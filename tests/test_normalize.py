"""Normalization vs scipy oracle (independent implementation of the
reference's preprocess_adj semantics, utils.py:185-213)."""
import numpy as np
import pytest
import scipy.sparse as sp

from textgcn.graph.normalize import (
    add_self_loops_coo,
    max_symmetrize_coo,
    sym_normalize_coo,
    sym_normalize_vals,
)
from textgcn.graph.structs import SparseGraph


def _random_coo(n, nnz, seed=0, symmetric=False):
    rng = np.random.RandomState(seed)
    row = rng.randint(0, n, nnz)
    col = rng.randint(0, n, nnz)
    val = rng.rand(nnz)
    m = sp.coo_matrix((val, (row, col)), shape=(n, n))
    m.sum_duplicates()
    if symmetric:
        m = m.maximum(m.T)
        m = m.tocoo()
    return m


def _scipy_normalize(adj):
    """Oracle: D^-1/2 (A+I) D^-1/2 exactly as the reference computes it."""
    a = sp.coo_matrix(adj + sp.eye(adj.shape[0]))
    rowsum = np.array(a.sum(1)).flatten()
    with np.errstate(divide="ignore"):
        dinv = np.power(rowsum, -0.5)
    dinv[np.isinf(dinv)] = 0.0
    d = sp.diags(dinv)
    return a.dot(d).transpose().dot(d).tocoo()


@pytest.mark.parametrize("n,nnz,seed", [(50, 200, 0), (200, 1000, 1), (13, 5, 2)])
def test_sym_normalize_matches_scipy(n, nnz, seed):
    m = _random_coo(n, nnz, seed, symmetric=True)
    r, c, v = sym_normalize_coo(m.row, m.col, m.data, n)
    got = sp.coo_matrix((v, (r, c)), shape=(n, n)).toarray()
    want = _scipy_normalize(m).toarray()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


def test_isolated_nodes_zero_degree_handling():
    # node 3 fully isolated except for the added self-loop
    row = np.array([0, 1])
    col = np.array([1, 0])
    val = np.array([1.0, 1.0])
    r, c, v = sym_normalize_coo(row, col, val, 4)
    m = sp.coo_matrix((v, (r, c)), shape=(4, 4)).toarray()
    assert m[3, 3] == pytest.approx(1.0)  # self-loop / sqrt(1)*sqrt(1)


def test_max_symmetrize():
    row = np.array([0, 1, 0])
    col = np.array([1, 0, 2])
    val = np.array([3.0, 5.0, 2.0])
    r, c, v = max_symmetrize_coo(row, col, val, 3)
    m = sp.coo_matrix((v, (r, c)), shape=(3, 3)).toarray()
    assert m[0, 1] == 5.0 and m[1, 0] == 5.0
    assert m[0, 2] == 2.0 and m[2, 0] == 2.0


def test_add_self_loops_merges_diagonal():
    row = np.array([0, 0])
    col = np.array([0, 1])
    val = np.array([2.0, 1.0])
    r, c, v = add_self_loops_coo(row, col, val, 2)
    m = sp.coo_matrix((v, (r, c)), shape=(2, 2)).toarray()
    assert m[0, 0] == 3.0 and m[1, 1] == 1.0


def test_device_side_normalize_matches_host():
    import jax.numpy as jnp

    m = _random_coo(60, 300, 3, symmetric=True)
    r, c, v = add_self_loops_coo(m.row.astype(np.int64), m.col.astype(np.int64), m.data, 60)
    g = SparseGraph.from_coo(r, c, v, 60, pad_to_multiple=128)
    nv = sym_normalize_vals(g.row, g.col, g.val, 60)
    got = sp.coo_matrix(
        (
            np.asarray(nv)[: g.n_edges],
            (np.asarray(g.row)[: g.n_edges], np.asarray(g.col)[: g.n_edges]),
        ),
        shape=(60, 60),
    ).toarray()
    want = _scipy_normalize(m).toarray()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
