"""Native graph core vs the Python implementations."""
import numpy as np
import pytest
import scipy.sparse as sp

from textgcn import native
from textgcn.graph.normalize import max_symmetrize_coo, sym_normalize_coo

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native graphcore not built"
)


def test_parse_edgelist(tmp_path):
    p = tmp_path / "e.txt"
    p.write_text("0 5 0.5\n1 6 0.25\n7 2 1.5\n3 4\n")
    r, c, v = native.parse_edgelist(str(p))
    np.testing.assert_array_equal(r, [0, 1, 7, 3])
    np.testing.assert_array_equal(c, [5, 6, 2, 4])
    np.testing.assert_allclose(v, [0.5, 0.25, 1.5, 1.0])


def test_parse_large_roundtrip(tmp_path):
    rng = np.random.RandomState(0)
    n = 10000
    rows = rng.randint(0, 1000, n)
    cols = rng.randint(0, 1000, n)
    vals = rng.rand(n)
    p = tmp_path / "big.txt"
    with open(p, "w") as f:
        for a, b, w in zip(rows, cols, vals):
            f.write(f"{a} {b} {w}\n")
    r, c, v = native.parse_edgelist(str(p))
    np.testing.assert_array_equal(r, rows)
    np.testing.assert_array_equal(c, cols)
    np.testing.assert_allclose(v, vals, rtol=1e-12)


def test_coalesce_max_symmetrize_matches_python():
    rng = np.random.RandomState(1)
    n_nodes = 50
    rows = rng.randint(0, n_nodes, 300)
    cols = rng.randint(0, n_nodes, 300)
    vals = rng.rand(300)
    r1, c1, v1 = native.coalesce(
        rows, cols, vals, n_nodes, reduce="max", symmetrize=True
    )
    r2, c2, v2 = max_symmetrize_coo(rows, cols, vals, n_nodes)
    m1 = sp.coo_matrix((v1, (r1, c1)), shape=(n_nodes, n_nodes)).toarray()
    m2 = sp.coo_matrix((v2, (r2, c2)), shape=(n_nodes, n_nodes)).toarray()
    np.testing.assert_allclose(m1, m2, rtol=1e-12)


def test_sym_normalize_matches_python():
    rng = np.random.RandomState(2)
    n_nodes = 40
    rows = rng.randint(0, n_nodes, 200)
    cols = rng.randint(0, n_nodes, 200)
    vals = rng.rand(200)
    # coalesce+symmetrize first (both paths)
    r0, c0, v0 = native.coalesce(
        rows, cols, vals, n_nodes, reduce="max", symmetrize=True
    )
    r1, c1, v1 = native.sym_normalize(r0, c0, v0, n_nodes)
    r2, c2, v2 = sym_normalize_coo(r0, c0, v0, n_nodes)
    m1 = sp.coo_matrix((v1, (r1, c1)), shape=(n_nodes, n_nodes)).toarray()
    m2 = sp.coo_matrix((v2, (r2, c2)), shape=(n_nodes, n_nodes)).toarray()
    np.testing.assert_allclose(m1, m2, rtol=1e-10, atol=1e-12)


def test_window_cooccurrence_matches_python():
    from textgcn.graph.build_textgcn import (
        window_word_incidence,
    )

    docs = ["a b c d e", "c d e f", "a f"]
    vocab = ["a", "b", "c", "d", "e", "f"]
    w2i = {w: i for i, w in enumerate(vocab)}
    tokens, offsets = [], [0]
    for d in docs:
        tokens.extend(w2i[w] for w in d.split())
        offsets.append(len(tokens))
    i, j, cnt, occ, n_win = native.window_cooccurrence(
        np.asarray(tokens), np.asarray(offsets), len(vocab), 3
    )
    inc = window_word_incidence(docs, vocab, window_size=3)
    assert n_win == inc.shape[0]
    np.testing.assert_array_equal(
        occ, np.asarray(inc.sum(axis=0)).ravel().astype(np.int64)
    )
    co = (inc.T @ inc).toarray()
    want = {}
    for a in range(len(vocab)):
        for b in range(a + 1, len(vocab)):
            if co[a, b] > 0:
                want[(a, b)] = co[a, b]
    got = dict(zip(zip(i.tolist(), j.tolist()), cnt))
    assert {k: int(v) for k, v in got.items()} == {
        k: int(v) for k, v in want.items()
    }
