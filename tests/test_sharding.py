"""Multi-device tests on the 8-device virtual CPU mesh: the sharded SpMM and
train step must match the single-device reference implementation."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.sparse as sp

from textgcn.graph.normalize import sym_normalize_coo
from textgcn.graph.structs import SparseGraph
from textgcn.models.gcn import gcn_forward, gcn_init
from textgcn.ops.spmm import spmm
from textgcn.parallel.partition import pad_features, partition_rows
from textgcn.parallel.sharded import (
    make_mesh,
    make_sharded_train_step,
    shard_arrays,
    sharded_gcn_forward,
    spmm_sharded,
)


def _graph(n=100, nnz=600, seed=0):
    rng = np.random.RandomState(seed)
    row = rng.randint(0, n, nnz)
    col = rng.randint(0, n, nnz)
    val = rng.rand(nnz)
    m = sp.coo_matrix((val, (row, col)), shape=(n, n)).maximum(
        sp.coo_matrix((val, (col, row)), shape=(n, n))
    ).tocoo()
    r, c, v = sym_normalize_coo(m.row, m.col, m.data, n)
    return SparseGraph.from_coo(r, c, v, n, pad_to_multiple=256)


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_spmm_sharded_matches_single_device(n_shards):
    g = _graph()
    mesh = make_mesh(n_shards)
    pg = partition_rows(g, n_shards)
    x = np.random.RandomState(1).randn(g.n_nodes, 24).astype(np.float32)
    xp = pad_features(x, pg.n_pad)
    got = np.asarray(spmm_sharded(pg, jnp.asarray(xp), mesh))[: g.n_nodes]
    want = np.asarray(spmm(g, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_sharded_forward_matches_single_device():
    g = _graph(n=77, nnz=400, seed=3)
    mesh = make_mesh(4)
    pg = partition_rows(g, 4)
    x = np.random.RandomState(2).randn(g.n_nodes, 12).astype(np.float32)
    params = gcn_init(jax.random.PRNGKey(0), 12, 16, 5)
    want = np.asarray(gcn_forward(params, g, jnp.asarray(x), train=False))
    xp = pad_features(x, pg.n_pad)
    got = np.asarray(
        sharded_gcn_forward(params, pg, jnp.asarray(xp), mesh, train=False)
    )[: g.n_nodes]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_sharded_train_step_runs_and_learns():
    g = _graph(n=64, nnz=500, seed=5)
    n = g.n_nodes
    mesh = make_mesh(8)
    pg = partition_rows(g, 8)
    rng = np.random.RandomState(3)
    y = rng.randint(0, 3, pg.n_pad).astype(np.int32)
    w = np.zeros(pg.n_pad, dtype=np.float32)
    w[:n][rng.rand(n) < 0.5] = 1.0
    x = rng.randn(n, 8).astype(np.float32)
    xp = pad_features(x, pg.n_pad)

    params = gcn_init(jax.random.PRNGKey(1), 8, 16, 3)
    opt = optax.adam(1e-2)
    opt_state = opt.init(params)
    step = make_sharded_train_step(pg, mesh, opt, dropout=0.0)
    xs, ys, ws = shard_arrays(mesh, xp, y, w)
    losses = []
    key = jax.random.PRNGKey(0)
    for i in range(30):
        key, k = jax.random.split(key)
        params, opt_state, loss = step(params, opt_state, xs, ys, ws, k)
        losses.append(float(loss))
    assert losses[-1] < losses[0], losses[:3] + losses[-3:]
    assert np.isfinite(losses).all()


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_spmm_halo_matches_single_device(n_shards):
    from textgcn.parallel.halo import partition_rows_halo, spmm_halo

    g = _graph(n=90, nnz=700, seed=11)
    mesh = make_mesh(n_shards)
    hg = partition_rows_halo(g, n_shards)
    x = np.random.RandomState(5).randn(g.n_nodes, 16).astype(np.float32)
    xp = pad_features(x, hg.n_pad)
    got = np.asarray(spmm_halo(hg, jnp.asarray(xp), mesh))[: g.n_nodes]
    want = np.asarray(spmm(g, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_spmm_halo_matches_allgather_path():
    from textgcn.parallel.halo import partition_rows_halo, spmm_halo

    g = _graph(n=128, nnz=900, seed=13)
    mesh = make_mesh(8)
    pg = partition_rows(g, 8)
    hg = partition_rows_halo(g, 8)
    assert hg.n_pad == pg.n_pad
    x = np.random.RandomState(6).randn(g.n_nodes, 24).astype(np.float32)
    xp = pad_features(x, hg.n_pad)
    a = np.asarray(spmm_sharded(pg, jnp.asarray(xp), mesh))
    b = np.asarray(spmm_halo(hg, jnp.asarray(xp), mesh))
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
