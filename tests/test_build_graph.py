"""Graph construction: thresholds, node indexing, artifact round-trip,
feature building — against hand-computed oracles."""
import numpy as np

from textgcn.graph.build_topic import (
    TopicGraph,
    TopicGraphBuilder,
    build_doc_topic_edges,
    build_topic_topic_edges,
    cosine_similarity_matrix,
    read_weighted_edgelist,
    write_weighted_edgelist,
)
from textgcn.train.prepare import build_topic_features, load_graph_edges


def test_doc_topic_edges_threshold_and_indexing():
    theta = np.array(
        [
            [0.5, 0.3, 0.2],
            [0.01, 0.019, 0.971],
            [0.02, 0.49, 0.49],
        ]
    )
    s, d, w = build_doc_topic_edges(theta, threshold=0.02)
    # doc 0: all 3 topics; doc 1: only topic 2; doc 2: all (0.02 >= 0.02)
    assert len(s) == 7
    assert set(zip(s.tolist(), d.tolist())) == {
        (0, 3), (0, 4), (0, 5), (1, 5), (2, 3), (2, 4), (2, 5),
    }
    np.testing.assert_allclose(w[(s == 1)], [0.971])


def test_topic_topic_edges_upper_triangle():
    emb = np.array(
        [[1.0, 0.0], [0.9, 0.1], [0.0, 1.0]], dtype=np.float64
    )
    s, d, w = build_topic_topic_edges(emb, threshold=0.3, num_docs=10)
    sim = cosine_similarity_matrix(emb)
    # only pair (0,1) has cos > 0.3 among i<j? check (1,2): cos ≈ 0.11
    assert list(zip(s.tolist(), d.tolist())) == [(10, 11)]
    np.testing.assert_allclose(w, [sim[0, 1]])


def test_cosine_similarity_matches_sklearn():
    from sklearn.metrics.pairwise import cosine_similarity

    x = np.random.RandomState(0).randn(7, 5)
    np.testing.assert_allclose(
        cosine_similarity_matrix(x), cosine_similarity(x), atol=1e-10
    )


def test_edgelist_roundtrip(tmp_path):
    g = TopicGraph(
        src=np.array([0, 1, 5]),
        dst=np.array([5, 6, 6]),
        weight=np.array([0.5, 0.25, 0.75]),
        num_docs=5,
        num_topics=2,
        n_doc_topic_edges=2,
        n_topic_topic_edges=1,
    )
    path = str(tmp_path / "g.txt")
    write_weighted_edgelist(g, path)
    s, d, w = read_weighted_edgelist(path)
    np.testing.assert_array_equal(s, g.src)
    np.testing.assert_array_equal(d, g.dst)
    np.testing.assert_allclose(w, g.weight)


def test_load_graph_edges_symmetrizes_and_normalizes(tmp_path):
    import scipy.sparse as sp

    path = str(tmp_path / "e.txt")
    with open(path, "w") as f:
        f.write("0 1 0.5\n1 2 0.25\n")
    g = load_graph_edges(path, 3, pad_to_multiple=16)
    a = g.to_scipy().toarray()
    # oracle
    raw = np.zeros((3, 3))
    raw[0, 1] = raw[1, 0] = 0.5
    raw[1, 2] = raw[2, 1] = 0.25
    raw += np.eye(3)
    d = np.diag(1.0 / np.sqrt(raw.sum(1)))
    want = d @ raw @ d
    np.testing.assert_allclose(a, want, atol=1e-6)


def test_build_topic_features_matches_reference_recipe():
    theta = np.array([[0.6, 0.4], [0.1, 0.9]])
    emb = np.array([[1.0, 2.0, 2.0], [0.0, 3.0, 4.0]])
    feats = build_topic_features(theta, emb)
    assert feats.shape == (4, 3)  # max(K=2, E=3) = 3
    # doc rows: theta padded then L2-normalized
    want0 = np.array([0.6, 0.4, 0.0])
    want0 = want0 / np.linalg.norm(want0)
    np.testing.assert_allclose(feats[0], want0, rtol=1e-5)
    # topic rows: embeddings L2-normalized
    want2 = emb[0] / np.linalg.norm(emb[0])
    np.testing.assert_allclose(feats[2], want2, rtol=1e-5)


def test_builder_end_to_end_synthetic(tmp_path):
    rng = np.random.RandomState(0)
    theta = rng.dirichlet(np.ones(4) * 0.5, size=30)
    emb = rng.randn(4, 8)
    b = TopicGraphBuilder("synth", num_topics=4, verbose=False)
    g = b.build_from_arrays(theta, emb)
    assert g.num_docs == 30 and g.num_topics == 4
    assert g.n_nodes == 34
    assert (g.src[: g.n_doc_topic_edges] < 30).all()
    assert (g.dst >= 30).all()  # both edge kinds end at topic nodes
    assert g.n_edges == g.n_doc_topic_edges + g.n_topic_topic_edges
    b.graph = g
    b.save(str(tmp_path))
    s, d, w = read_weighted_edgelist(str(tmp_path / "synth_topic.txt"))
    assert len(s) == g.n_edges
    assert (tmp_path / "synth_topic_nodes.csv").exists()
    assert (tmp_path / "synth_topic_edges.csv").exists()
