"""GAT model family: segment softmax + attention forward against a dense
numpy oracle, and end-to-end training through the Trainer (--model gat)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from textgcn.graph.normalize import sym_normalize_coo
from textgcn.graph.structs import SparseGraph
from textgcn.models.gat import (
    gat_forward,
    gat_init,
    gat_layer,
    segment_softmax,
)


def _graph(n=30, e0=90, seed=0, pad=64):
    rng = np.random.RandomState(seed)
    r, c, v = sym_normalize_coo(
        rng.randint(0, n, e0), rng.randint(0, n, e0), rng.rand(e0), n
    )
    return SparseGraph.from_coo(r, c, v, n, pad_to_multiple=pad), rng


def test_segment_softmax_matches_numpy():
    g, rng = _graph()
    e = g.n_edges
    logits = np.full(g.n_padded_edges, -np.inf, dtype=np.float32)
    logits[:e] = rng.randn(e).astype(np.float32)
    got = np.asarray(
        segment_softmax(jnp.asarray(logits), g.row, g.n_nodes)
    )
    row = np.asarray(g.row)[:e]
    want = np.zeros(e)
    for i in np.unique(row):
        sel = row == i
        z = np.exp(logits[:e][sel] - logits[:e][sel].max())
        want[sel] = z / z.sum()
    np.testing.assert_allclose(got[:e], want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[e:], 0.0)  # padding edges vanish


def test_gat_layer_matches_dense_oracle():
    """One GAT layer vs a dense numpy re-implementation of the weighted
    attention softmax + aggregation."""
    g, rng = _graph(seed=1)
    n, f, h = g.n_nodes, 7, 5
    x = rng.randn(n, f).astype(np.float32)
    p = {
        "w": jnp.asarray(rng.randn(f, h).astype(np.float32) * 0.3),
        "b": jnp.asarray(rng.randn(h).astype(np.float32) * 0.1),
        "a_src": jnp.asarray(rng.randn(h).astype(np.float32) * 0.3),
        "a_dst": jnp.asarray(rng.randn(h).astype(np.float32) * 0.3),
    }
    got = np.asarray(gat_layer(p, g, jnp.asarray(x)))

    # dense oracle
    hm = x @ np.asarray(p["w"])
    es = hm @ np.asarray(p["a_src"])
    ed = hm @ np.asarray(p["a_dst"])
    a = np.asarray(g.to_scipy().todense())
    logit = np.where(
        a > 0,
        np.where(
            es[:, None] + ed[None, :] > 0,
            es[:, None] + ed[None, :],
            0.2 * (es[:, None] + ed[None, :]),
        )
        + np.log(np.where(a > 0, a, 1.0)),
        -np.inf,
    )
    att = np.zeros_like(logit)
    for i in range(g.n_nodes):
        if np.isfinite(logit[i]).any():
            z = np.exp(logit[i] - logit[i][np.isfinite(logit[i])].max())
            z[~np.isfinite(logit[i])] = 0.0
            att[i] = z / z.sum()
    want = att @ hm + np.asarray(p["b"])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_gat_rejects_non_coo_graph():
    from textgcn.graph.structs import DenseGraph

    g, rng = _graph(seed=2)
    d = DenseGraph.from_sparse_graph(g)
    params = gat_init(jax.random.PRNGKey(0), 4, 8, 3)
    with pytest.raises(TypeError, match="segment"):
        gat_forward(params, d, jnp.zeros((g.n_nodes, 4)))


def test_gat_trains_end_to_end():
    """Trainer with model='gat': loss decreases and eval metrics are sane;
    attention params receive gradients."""
    from textgcn.train.trainer import TrainConfig, Trainer

    g, rng = _graph(n=60, e0=240, seed=3)
    x = rng.randn(60, 8).astype(np.float32)
    y = rng.randint(0, 3, 60)
    idx = np.arange(60)
    cfg = TrainConfig(
        n_hidden=8, max_epoch=25, early_stopping=25, dropout=0.0,
        seed=0, epoch_block=5, model="gat",
    )
    t = Trainer(g, x, y, idx[:40], idx[40:], 3, config=cfg)
    t.fit(verbose=False)
    assert t.history[-1]["train_loss"] < t.history[0]["train_loss"]
    res = t.test()
    assert np.isfinite(res["test_loss"])
    assert 0.0 <= res["acc"] <= 1.0
    # attention projections moved from init
    p0 = gat_init(
        jax.random.split(jax.random.PRNGKey(cfg.seed))[1], 8, 8, 3
    )
    moved = float(
        jnp.max(jnp.abs(t.params["gat1"]["a_src"] - p0["gat1"]["a_src"]))
    )
    assert moved > 1e-5


def test_gat_identity_features():
    """x=None (doc-word family): layer 1's h is the weight table itself."""
    g, rng = _graph(n=24, e0=60, seed=4)
    params = gat_init(jax.random.PRNGKey(1), g.n_nodes, 6, 2)
    out = gat_forward(params, g, None, train=False)
    assert out.shape == (g.n_nodes, 2)
    assert np.isfinite(np.asarray(out)).all()


@pytest.mark.parametrize("n_hidden", [1, 8, 200])
def test_gat_segment_trains_like_dense_attention(n_hidden):
    """Trainer(model='gat') at hidden widths 1, 8 and 200: the segment
    path's first-epoch loss matches the dense log-adjacency path (bf16
    loga tolerance), and the loss falls."""
    from textgcn.models.gat import DenseAttentionGraph
    from textgcn.train.trainer import TrainConfig, Trainer

    g, rng = _graph(n=60, e0=240, seed=5)
    x = rng.randn(60, 8).astype(np.float32)
    y = rng.randint(0, 3, 60)
    idx = np.arange(60)
    cfg = TrainConfig(
        n_hidden=n_hidden, max_epoch=15, early_stopping=25, dropout=0.0,
        seed=0, epoch_block=5, model="gat",
    )
    t_seg = Trainer(g, x, y, idx[:40], idx[40:], 3, config=cfg)
    t_seg.fit(verbose=False)
    t_den = Trainer(DenseAttentionGraph.from_sparse_graph(g), x, y,
                    idx[:40], idx[40:], 3, config=cfg)
    t_den.fit(verbose=False)
    np.testing.assert_allclose(
        t_den.history[0]["train_loss"],
        t_seg.history[0]["train_loss"],
        rtol=2e-2,
    )
    assert t_seg.history[-1]["train_loss"] < t_seg.history[0]["train_loss"]
    assert np.isfinite(t_seg.test()["test_loss"])


def test_gat_layer_dense_matches_segment():
    """Dense log-adjacency layer (models/gat.py DenseAttentionGraph) vs
    the segment path: forward and parameter grads agree to the bf16
    tolerance of the resident loga / bf16 aggregation matmul."""
    from textgcn.models.gat import (
        DenseAttentionGraph,
        _gat_layer_params,
        gat_layer_dense,
    )

    g, rng = _graph(n=80, e0=400, seed=7)
    dg = DenseAttentionGraph.from_sparse_graph(g)
    p = _gat_layer_params(jax.random.PRNGKey(0), 10, 6)
    x = jnp.asarray(rng.randn(80, 10).astype(np.float32))
    a = np.asarray(gat_layer(p, g, x))
    b = np.asarray(gat_layer_dense(p, dg, x))
    assert np.max(np.abs(a - b)) <= 2e-2 * max(np.max(np.abs(a)), 1.0)
    ga = jax.grad(lambda p: jnp.sum(gat_layer(p, g, x) ** 2))(p)
    gb = jax.grad(lambda p: jnp.sum(gat_layer_dense(p, dg, x) ** 2))(p)
    for k in ga:
        ref = np.asarray(ga[k])
        got = np.asarray(gb[k])
        assert np.max(np.abs(got - ref)) <= 2e-2 * max(
            np.max(np.abs(ref)), 1.0
        ), k


def test_gat_trains_on_dense_attention_graph():
    """Trainer(model='gat') on the DenseAttentionGraph follows the segment
    trainer's loss trajectory (dropout off, same seed)."""
    from textgcn.models.gat import DenseAttentionGraph
    from textgcn.train.trainer import TrainConfig, Trainer

    g, rng = _graph(n=60, e0=240, seed=8)
    x = rng.randn(60, 8).astype(np.float32)
    y = rng.randint(0, 3, 60)
    idx = np.arange(60)
    cfg = TrainConfig(
        n_hidden=8, max_epoch=10, early_stopping=25, dropout=0.0,
        seed=0, epoch_block=5, model="gat",
    )
    losses = {}
    for graph in (g, DenseAttentionGraph.from_sparse_graph(g)):
        t = Trainer(graph, x, y, idx[:40], idx[40:], 3, config=cfg)
        t.fit(verbose=False)
        losses[type(graph).__name__] = [
            h["train_loss"] for h in t.history
        ]
    seg = losses["SparseGraph"]
    den = losses["DenseAttentionGraph"]
    assert len(seg) == len(den)
    for a, b in zip(seg, den):
        assert abs(a - b) < 3e-2


def test_apply_dense_attention_format():
    """--model gat --spmm dense routes through the dense log-adjacency
    layout."""
    from textgcn.models.gat import DenseAttentionGraph
    from textgcn.text.datasets import DatasetLabels
    from textgcn.train.prepare import (
        PreparedData,
        apply_dense_attention_format,
    )

    g, rng = _graph(n=40, e0=160, seed=9)
    labels = DatasetLabels(
        target=rng.randint(0, 3, 20),
        label_names=["a", "b", "c"],
        train_idx=np.arange(12),
        test_idx=np.arange(12, 20),
    )
    pre = PreparedData(
        graph=g,
        features=rng.randn(40, 8).astype(np.float32),
        labels=labels,
        n_feat=8,
        num_docs=20,
        num_topics=20,
    )
    out = apply_dense_attention_format(pre)
    assert isinstance(out.graph, DenseAttentionGraph)
    # loga holds log(val) at real edges, the -1e30 sentinel elsewhere
    e = g.n_edges
    r0 = int(np.asarray(g.row)[0])
    c0 = int(np.asarray(g.col)[0])
    v0 = float(np.asarray(g.val)[0])
    got = float(out.graph.loga[r0, c0])
    assert abs(got - np.log(v0)) <= 2e-2 * max(abs(np.log(v0)), 1.0)
    rows = np.asarray(g.row)[:e]
    cols = np.asarray(g.col)[:e]
    if not np.any((rows == 0) & (cols == 1)):
        assert float(out.graph.loga[0, 1]) < -1e29


@pytest.mark.parametrize(
    "spmm, want", [("auto", "SparseGraph"), ("segment", "SparseGraph"),
                   ("dense", "DenseAttentionGraph")],
)
def test_gat_format_routing(spmm, want):
    """--model gat: auto and segment keep the segment COO (the dense
    log-adjacency trained slower on every text graph measured on the
    H100); only an explicit --spmm dense selects it."""
    from textgcn.text.datasets import DatasetLabels
    from textgcn.train.prepare import PreparedData
    from textgcn.train.run import _prepare_for_training
    from textgcn.train.trainer import TrainConfig

    g, rng = _graph(n=40, e0=160, seed=10)
    labels = DatasetLabels(
        target=rng.randint(0, 3, 20),
        label_names=["a", "b", "c"],
        train_idx=np.arange(12),
        test_idx=np.arange(12, 20),
    )
    pre = PreparedData(
        graph=g,
        features=rng.randn(40, 8).astype(np.float32),
        labels=labels,
        n_feat=8,
        num_docs=20,
        num_topics=20,
    )
    cfg = TrainConfig(model="gat", spmm=spmm)
    out = _prepare_for_training("x", "topic", "data", cfg, pre, None)
    assert type(out.graph).__name__ == want
    with pytest.raises(ValueError, match="no streamed form"):
        _prepare_for_training(
            "x", "topic", "data", TrainConfig(model="gat", spmm="streamed"),
            pre, None,
        )
