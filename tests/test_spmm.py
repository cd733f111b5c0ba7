"""SpMM paths vs dense oracles: segment, streamed, SDDMM and the
edge-differentiable SpMM."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from textgcn.graph.structs import SparseGraph
from textgcn.ops.spmm import spmm, spmm_coo_segment


def _random_graph(n, nnz, seed=0):
    rng = np.random.RandomState(seed)
    row = rng.randint(0, n, nnz)
    col = rng.randint(0, n, nnz)
    val = rng.randn(nnz)
    m = sp.coo_matrix((val, (row, col)), shape=(n, n))
    m.sum_duplicates()
    m = m.tocoo()
    # add diagonal so every block-row is populated (as Â always is)
    m = (m + sp.eye(n)).tocoo()
    return m


@pytest.mark.parametrize("n,nnz,f", [(64, 300, 16), (200, 2000, 64), (300, 50, 7)])
def test_segment_spmm_matches_dense(n, nnz, f):
    m = _random_graph(n, nnz)
    x = np.random.RandomState(1).randn(n, f).astype(np.float32)
    g = SparseGraph.from_coo(m.row, m.col, m.data, n, pad_to_multiple=256)
    got = np.asarray(spmm(g, jnp.asarray(x)))
    want = m.toarray() @ x
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_segment_spmm_grad_flows():
    m = _random_graph(32, 100)
    g = SparseGraph.from_coo(m.row, m.col, m.data, 32, pad_to_multiple=128)
    x = jnp.asarray(np.random.RandomState(2).randn(32, 8).astype(np.float32))

    def loss(x):
        return jnp.sum(spmm_coo_segment(g.row, g.col, g.val, x, 32) ** 2)

    grad = np.asarray(jax.grad(loss)(x))
    # analytic oracle: d/dx sum((Ax)^2) = 2 Aᵀ A x
    a = m.toarray()
    want = 2.0 * a.T @ (a @ np.asarray(x))
    np.testing.assert_allclose(grad, want, rtol=1e-3, atol=1e-3)


def test_sparse_graph_roundtrip():
    m = _random_graph(50, 200, seed=7)
    g = SparseGraph.from_coo(m.row, m.col, m.data, 50)
    back = g.to_scipy().toarray()
    np.testing.assert_allclose(back, m.toarray(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(g.to_dense()), m.toarray(), rtol=1e-6, atol=1e-6
    )


def test_segment_spmm_chunks_past_the_gather_cap(monkeypatch):
    """Past the [E, F] gather cap the segment SpMM runs in chunks under
    lax.scan and still matches the dense product, forward and VJP."""
    from textgcn import device

    m = _random_graph(200, 2000, seed=9)
    g = SparseGraph.from_coo(m.row, m.col, m.data, 200, pad_to_multiple=256)
    x = jnp.asarray(np.random.RandomState(4).randn(200, 16).astype(np.float32))
    # 2304 padded edges x 16 x 4 B = 147 kB: a 40 kB cap makes 4 chunks
    monkeypatch.setattr(device, "HOST_GATHER_BYTES_LIMIT", 40_000)
    got = np.asarray(spmm_coo_segment(g.row, g.col, g.val, x, 200))
    np.testing.assert_allclose(got, m.toarray() @ np.asarray(x), rtol=1e-4,
                               atol=1e-4)
    grad = jax.grad(
        lambda z: jnp.sum(spmm_coo_segment(g.row, g.col, g.val, z, 200))
    )(x)
    want = m.toarray().T @ np.ones((200, 16))
    np.testing.assert_allclose(np.asarray(grad), want, rtol=1e-4, atol=1e-4)


def test_spmm_streamed_matches_materialized_oracle():
    """The edge-streaming SpMM (for graphs beyond device memory) must equal the
    materialized computation on a replayed stream (small scale)."""
    import sys, os

    sys.path.insert(
        0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks")
    )
    from synthetic_large import make_random_edge_fn

    from textgcn.ops.spmm import spmm_streamed

    n, chunk_e, n_chunks, f = 300, 512, 3, 17
    edge_fn = make_random_edge_fn(n, chunk_e, seed=9)
    x = np.random.RandomState(1).randn(n, f).astype(np.float32)
    got = np.asarray(spmm_streamed(edge_fn, jnp.asarray(x), n, n_chunks))

    a = np.zeros((n, n), dtype=np.float64)
    for i in range(n_chunks):
        r, c, v = (np.asarray(t) for t in edge_fn(i))
        np.add.at(a, (r, c), v)
    np.testing.assert_allclose(got, a @ x, rtol=1e-4, atol=1e-4)


def test_sddmm_matches_dense_oracle():
    """sddmm(row, col, a, b)[e] must equal (a @ b.T)[row[e], col[e]],
    with padding indices (== N) contributing 0."""
    from textgcn.ops.spmm import sddmm

    rng = np.random.RandomState(3)
    n, f, e = 37, 9, 120
    row = rng.randint(0, n, e).astype(np.int32)
    col = rng.randint(0, n, e).astype(np.int32)
    # append padding entries
    row = np.concatenate([row, np.full(8, n, np.int32)])
    col = np.concatenate([col, np.full(8, n, np.int32)])
    a = rng.randn(n, f).astype(np.float32)
    b = rng.randn(n, f).astype(np.float32)
    got = np.asarray(sddmm(jnp.asarray(row), jnp.asarray(col),
                           jnp.asarray(a), jnp.asarray(b)))
    want = (a @ b.T)[row[:e], col[:e]]
    np.testing.assert_allclose(got[:e], want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[e:], 0.0)


def test_spmm_ew_val_gradient_matches_dense():
    """The edge-weight-differentiable SpMM's val-gradient (an SDDMM pass)
    must equal autodiff through the dense formulation."""
    from textgcn.ops.spmm import spmm_coo_segment_ew

    rng = np.random.RandomState(4)
    n, f, e = 23, 7, 61
    row = np.sort(rng.randint(0, n, e)).astype(np.int32)
    col = rng.randint(0, n, e).astype(np.int32)
    val = rng.rand(e).astype(np.float32)
    x = rng.randn(n, f).astype(np.float32)
    w = rng.randn(n, f).astype(np.float32)  # cotangent seed

    def f_sparse(v, xx):
        out = spmm_coo_segment_ew(
            jnp.asarray(row), jnp.asarray(col), v, xx, n, True
        )
        return jnp.sum(out * w)

    def f_dense(v, xx):
        a = jnp.zeros((n, n)).at[row, col].add(v)
        return jnp.sum((a @ xx) * w)

    gv_s, gx_s = jax.grad(f_sparse, argnums=(0, 1))(
        jnp.asarray(val), jnp.asarray(x)
    )
    gv_d, gx_d = jax.grad(f_dense, argnums=(0, 1))(
        jnp.asarray(val), jnp.asarray(x)
    )
    np.testing.assert_allclose(np.asarray(gv_s), np.asarray(gv_d),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(gx_s), np.asarray(gx_d),
                               rtol=1e-4, atol=1e-5)


def test_gcn_edge_forward_trains_edge_weights():
    """gcn_edge_forward: at init (edge_logit=0) it equals the fixed-Â model;
    a few optimizer steps must move edge_logit and reduce the loss."""
    import optax

    from textgcn.graph.normalize import sym_normalize_coo
    from textgcn.graph.structs import SparseGraph
    from textgcn.models.gcn import (
        gcn_edge_forward,
        gcn_edge_init,
        gcn_forward,
    )

    rng = np.random.RandomState(5)
    n, e0 = 40, 160
    r, c, v = sym_normalize_coo(
        rng.randint(0, n, e0), rng.randint(0, n, e0), rng.rand(e0), n
    )
    g = SparseGraph.from_coo(r, c, v, n, pad_to_multiple=64)
    x = jnp.asarray(rng.randn(n, 6).astype(np.float32))
    y = jnp.asarray(rng.randint(0, 3, n))

    params = gcn_edge_init(jax.random.PRNGKey(0), g, 6, 8, 3)
    base = gcn_forward(
        {k: params[k] for k in ("gc1", "gc2")}, g, x, train=False
    )
    withe = gcn_edge_forward(params, g, x, train=False)
    np.testing.assert_allclose(
        np.asarray(base), np.asarray(withe), rtol=1e-5, atol=1e-5
    )

    def loss_fn(p):
        logits = gcn_edge_forward(p, g, x, train=False)
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1))

    opt = optax.adam(0.05)
    state = opt.init(params)
    losses = []
    for _ in range(12):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    assert losses[-1] < losses[0] - 0.05, losses
    assert float(jnp.max(jnp.abs(params["edge_logit"]))) > 1e-4


def test_spmm_streamed_sym_gradient_matches_dense():
    """The symmetric streamed SpMM's x-gradient (a second streamed pass)
    must equal dense autodiff on a symmetrized replayed stream."""
    import sys, os

    sys.path.insert(
        0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmarks")
    )
    from synthetic_large import make_random_edge_fn

    from textgcn.ops.spmm import spmm_streamed_sym

    n, chunk_e, n_chunks, f = 64, 128, 2, 5
    base = make_random_edge_fn(n, chunk_e, seed=21)

    def edge_fn(i):
        # chunks (2k, 2k+1) are the two directions of base chunk k, so the
        # streamed matrix is symmetric by construction
        r, c, v = base(i // 2)
        return (
            jnp.where(i % 2 == 0, r, c),
            jnp.where(i % 2 == 0, c, r),
            v,
        )

    x = np.random.RandomState(2).randn(n, f).astype(np.float32)
    w = np.random.RandomState(3).randn(n, f).astype(np.float32)

    def f_stream(xx):
        return jnp.sum(spmm_streamed_sym(edge_fn, xx, n, 2 * n_chunks) * w)

    a = np.zeros((n, n), dtype=np.float64)
    for i in range(2 * n_chunks):
        r, c, v = (np.asarray(t) for t in edge_fn(i))
        np.add.at(a, (r, c), v)
    np.testing.assert_allclose(a, a.T)  # stream really is symmetric

    def f_dense(xx):
        return jnp.sum((jnp.asarray(a.astype(np.float32)) @ xx) * w)

    gs = jax.grad(f_stream)(jnp.asarray(x))
    gd = jax.grad(f_dense)(jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(gs), np.asarray(gd),
                               rtol=1e-4, atol=1e-4)
