"""Golden parity vs THE ACTUAL REFERENCE (BASELINE.md acceptance: "R8 ≥94%
with per-layer activations allclose vs reference"; VERDICT r1 item 5).

Replays the reference's real pipeline — ``PrepareData`` (reference
trainer.py:74-261: networkx edgelist → max-symmetrize → preprocess_adj;
feature build; pandas label parsing) and the torch ``GCN`` forward
(reference layer.py:84-190) — on the repo-built R8 artifacts, and asserts:

- Â allclose (normalized adjacency, reference trainer.py:98-151);
- X allclose (topic features, reference trainer.py:156-241);
- per-layer activations and logits allclose with identical weights;
- train/test splits identical; labels identical up to the reference's
  unordered-``set()`` class-id permutation (reference trainer.py:254).

θ-source note: the reference re-infers θ at train time through its pickled
sklearn LDA (trainer.py:179). Our artifact stores a JAX LDA, so the pickle
handed to the reference wraps the SAME θ/embeddings our pipeline computes
(duck-typed ``lda_model.transform``). That keeps the comparison exact where
it is meaningful — graph normalization, feature construction, label/split
parsing, and the GCN math — rather than comparing two LDA trainers' local
optima.

Runs the reference code read-only from /root/reference via sys.path; skipped
when the reference tree or the R8 artifacts are absent.
"""
import os
import pickle
import sys
import types

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = "/root/reference"

pytestmark = pytest.mark.skipif(
    not (
        os.path.exists(os.path.join(REF, "trainer.py"))
        and os.path.exists(os.path.join(REPO, "data/graph/R8_topic.txt"))
        and os.path.exists(os.path.join(REPO, "data/graph/R8_topic_model.pkl"))
    ),
    reason="reference tree or R8 artifacts unavailable",
)

torch = pytest.importorskip("torch")
pytest.importorskip("networkx")
pytest.importorskip("pandas")
pytest.importorskip("sklearn")


class _ThetaOracle:
    """Duck-typed stand-in for the pickled sklearn LDA: returns the fixed θ
    computed by our pipeline (see module docstring)."""

    def __init__(self, theta):
        self.theta = np.asarray(theta)

    def transform(self, dtm):
        return self.theta


class _NoopVectorizer:
    def transform(self, docs):
        return None  # only ever fed to _ThetaOracle.transform


def _stub_prettytable():
    """The reference's print_graph_detail imports prettytable (not installed
    here); provide a minimal stub so the reference code runs unmodified."""
    if "prettytable" in sys.modules:
        return
    mod = types.ModuleType("prettytable")

    class PrettyTable:
        def __init__(self, *a, **k):
            self.field_names = []

        def add_row(self, row):
            pass

        def __str__(self):
            return "<table>"

    mod.PrettyTable = PrettyTable
    sys.modules["prettytable"] = mod


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """Run our prepare and the reference's PrepareData on the same artifacts."""
    from textgcn.topics.model import TopicModel, load_documents_from_file
    from textgcn.train.prepare import prepare_topic_data

    data_root = os.path.join(REPO, "data")
    ours = prepare_topic_data("R8", data_root=data_root)

    # the θ/embedding source shared by both pipelines
    tm = TopicModel(num_topics=50)
    tm.load(os.path.join(data_root, "graph", "R8_topic_model.pkl"))
    docs = load_documents_from_file(
        os.path.join(data_root, "text_dataset", "clean_corpus", "R8.txt")
    )
    theta = tm.get_document_topic_distribution(docs)
    if tm.topic_embeddings is None:
        tm.get_topic_embeddings(top_n=20)

    # stage a working dir shaped the way the reference hardcodes its paths
    work = tmp_path_factory.mktemp("refrun")
    (work / "data" / "graph").mkdir(parents=True)
    (work / "data" / "text_dataset").mkdir(parents=True)
    os.symlink(
        os.path.join(data_root, "graph", "R8_topic.txt"),
        work / "data" / "graph" / "R8_topic.txt",
    )
    os.symlink(
        os.path.join(data_root, "text_dataset", "R8.txt"),
        work / "data" / "text_dataset" / "R8.txt",
    )
    os.symlink(
        os.path.join(data_root, "text_dataset", "clean_corpus"),
        work / "data" / "text_dataset" / "clean_corpus",
    )
    with open(work / "data" / "graph" / "R8_topic_model.pkl", "wb") as f:
        pickle.dump(
            {
                "lda_model": _ThetaOracle(theta),
                "vectorizer": _NoopVectorizer(),
                "vocabulary_": {str(w): i for i, w in enumerate(tm.vocabulary_)},
                "topic_word_distribution": tm.topic_word_distribution,
                "topic_embeddings": tm.topic_embeddings,
                "num_topics": 50,
                "word2vec_model": None,
            },
            f,
        )

    _stub_prettytable()
    sys.path.insert(0, REF)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        import importlib

        ref_trainer = importlib.import_module("trainer")
        args = types.SimpleNamespace(dataset="R8", num_topics=50)
        ref = ref_trainer.PrepareData(args)
    finally:
        os.chdir(cwd)
        sys.path.remove(REF)
    return ours, ref, theta


def test_adjacency_allclose(golden):
    """Â: reference trainer.py:98-151 + utils.py:185-213 vs graph/normalize."""
    ours, ref, _ = golden
    a_ref = np.asarray(ref.adj.to_dense())
    a_ours = ours.graph.to_scipy().toarray()
    assert a_ref.shape == a_ours.shape
    np.testing.assert_allclose(a_ours, a_ref, rtol=1e-5, atol=1e-6)


def test_features_allclose(golden):
    """X: reference trainer.py:156-241 vs train/prepare.build_topic_features."""
    ours, ref, _ = golden
    x_ref = np.asarray(ref.features.to_dense())
    np.testing.assert_allclose(ours.features, x_ref, rtol=1e-5, atol=1e-6)


def test_labels_and_splits(golden):
    ours, ref, _ = golden
    # splits: identical index lists (reference get_train_test, trainer.py:42-71)
    np.testing.assert_array_equal(ours.labels.train_idx, np.asarray(ref.train_lst))
    np.testing.assert_array_equal(ours.labels.test_idx, np.asarray(ref.test_lst))
    # labels: equal up to the reference's unordered-set() id permutation
    t_ref = np.asarray(ref.target)
    t_ours = ours.labels.target
    assert ref.nclass == ours.labels.n_classes
    mapping = {}
    for a, b in zip(t_ours, t_ref):
        if a in mapping:
            assert mapping[a] == b, "label mapping is not a bijection"
        mapping[a] = b
    assert len(mapping) == ref.nclass


def test_training_trajectory_allclose(golden):
    """Training-step parity vs the reference's actual optimizer semantics
    (reference trainer.py:349-362: Adam(lr=0.02), CrossEntropy on TRAIN-node
    logits only, full-batch): from identical weights, three epochs of the
    torch reference and three epochs of our jitted ``_train_block`` must
    produce allclose per-epoch losses AND allclose updated parameters.

    Dropout is set to 0 in both frameworks — the trajectories are otherwise
    deterministic, so this extends the golden suite from forward parity to
    the full train step (forward + backward through the SpMMs + Adam).

    torch is pinned to one thread for the duration: its CPU sparse mm uses a
    thread-parallel reduction whose summation order varies run to run, and 3
    Adam steps amplify that noise past tight tolerances (observed as a rare
    order-dependent flake in the full suite)."""
    import jax
    import jax.numpy as jnp

    from textgcn.models.gcn import gcn_init
    from textgcn.train import trainer as T

    ours, ref, _ = golden
    prev_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    n_epochs = 3
    params = gcn_init(jax.random.PRNGKey(1), ours.n_feat, 200, 8)

    # --- reference side: torch GCN + Adam, CE on train logits -------------
    sys.path.insert(0, REF)
    try:
        from layer import GCN as RefGCN
    finally:
        sys.path.remove(REF)
    model = RefGCN(nfeat=ours.n_feat, nhid=200, nclass=8, dropout=0.0)
    with torch.no_grad():
        model.gc1.weight.copy_(torch.from_numpy(np.asarray(params["gc1"]["w"])))
        model.gc1.bias.copy_(torch.from_numpy(np.asarray(params["gc1"]["b"])))
        model.gc2.weight.copy_(torch.from_numpy(np.asarray(params["gc2"]["w"])))
        model.gc2.bias.copy_(torch.from_numpy(np.asarray(params["gc2"]["b"])))
    # identical train subset for both (the reference further splits off 10%
    # val — irrelevant here: only the loss-bearing index set must match)
    train_idx = np.asarray(ref.train_lst, dtype=np.int64)
    target_t = torch.from_numpy(np.asarray(ref.target, dtype=np.int64))
    opt_t = torch.optim.Adam(model.parameters(), lr=0.02)
    crit = torch.nn.CrossEntropyLoss()
    ref_losses = []
    try:
        for _e in range(n_epochs):
            model.train()
            opt_t.zero_grad()
            logits = model(ref.features, ref.adj)
            loss = crit(logits[train_idx], target_t[train_idx])
            loss.backward()
            opt_t.step()
            ref_losses.append(float(loss.item()))
    finally:
        torch.set_num_threads(prev_threads)

    # --- our side: labels permuted to the reference's set()-order ids so
    # the CE targets are numerically identical --------------------------
    mapping = np.zeros(8, dtype=np.int64)
    for a, b in zip(ours.labels.target, np.asarray(ref.target)):
        mapping[a] = b
    y_ref_order = mapping[ours.labels.target]

    opt = T._adam()
    opt_state = opt.init(params)
    opt_state.hyperparams["learning_rate"] = jnp.asarray(0.02, jnp.float32)
    rngs = jax.random.split(jax.random.PRNGKey(0), n_epochs)  # unused: p=0
    params2, _, outs = T._train_block(
        params,
        opt_state,
        rngs,
        ours.graph,
        jnp.asarray(ours.features),
        jnp.asarray(y_ref_order, dtype=jnp.int32),
        jnp.asarray(train_idx, dtype=jnp.int32),
        jnp.asarray(train_idx[:10], dtype=jnp.int32),  # val: any subset
        8,
        0.0,  # dropout off
    )
    our_losses = np.asarray(outs[1])

    np.testing.assert_allclose(our_losses, ref_losses, rtol=1e-4, atol=1e-5)
    for name, layer in (("gc1", model.gc1), ("gc2", model.gc2)):
        np.testing.assert_allclose(
            np.asarray(params2[name]["w"]),
            layer.weight.detach().numpy(),
            rtol=2e-3,
            atol=2e-4,
        )
        np.testing.assert_allclose(
            np.asarray(params2[name]["b"]),
            layer.bias.detach().numpy(),
            rtol=2e-3,
            atol=2e-4,
        )


def test_per_layer_activations_allclose(golden):
    """Same weights → same layer-1 pre-activation, hidden, and logits
    (reference layer.py:84-190 vs models/gcn.gcn_forward)."""
    import jax
    import jax.numpy as jnp

    from textgcn.models.gcn import gcn_forward, gcn_init, graph_conv

    ours, ref, _ = golden
    params = gcn_init(jax.random.PRNGKey(0), ours.n_feat, 200, 8)

    sys.path.insert(0, REF)
    try:
        from layer import GCN as RefGCN
    finally:
        sys.path.remove(REF)
    model = RefGCN(nfeat=ours.n_feat, nhid=200, nclass=8, dropout=0.5)
    with torch.no_grad():
        model.gc1.weight.copy_(torch.from_numpy(np.asarray(params["gc1"]["w"])))
        model.gc1.bias.copy_(torch.from_numpy(np.asarray(params["gc1"]["b"])))
        model.gc2.weight.copy_(torch.from_numpy(np.asarray(params["gc2"]["w"])))
        model.gc2.bias.copy_(torch.from_numpy(np.asarray(params["gc2"]["b"])))
    model.eval()

    x = jnp.asarray(ours.features)
    with torch.no_grad():
        ref_h1 = model.gc1(ref.features, ref.adj)  # pre-ReLU layer 1
        ref_logits = model(ref.features, ref.adj)
    our_h1 = graph_conv(params["gc1"], ours.graph, x)
    our_logits = gcn_forward(params, ours.graph, x, train=False)

    np.testing.assert_allclose(
        np.asarray(our_h1), ref_h1.numpy(), rtol=1e-4, atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(our_logits), ref_logits.numpy(), rtol=1e-4, atol=1e-4
    )
