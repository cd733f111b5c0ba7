"""Sharded beyond-HBM streaming (textgcn.parallel.streamed): the
composition of the edge-stream SpMM with the device mesh — round-3 verdict
missing #1. Oracle-tested on the virtual 8-device CPU mesh:

- the ring-streamed mesh SpMM == dense matmul of the same operator, for
  both the PRNG bucket stream and a real graph's halo bucket layout;
- host-segmented == monolithic execution (donated accumulators, rotates);
- the sharded streamed GCN train step (autodiff through the symmetric mesh
  VJP) == the dense-operator train step, loss and every updated parameter;
- segmented sharded step == monolithic sharded step in bf16.
"""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

from textgcn.parallel.sharded import make_mesh
from textgcn.parallel.streamed import (
    halo_bucket_stream,
    make_random_bucket_edge_fn,
    make_streamed_sharded_train_step,
    make_streamed_sharded_train_step_segmented,
    shard_streamed_inputs,
    spmm_streamed_mesh,
    spmm_streamed_mesh_multi,
    symmetrize_bucket_edge_fn,
)

P_SHARDS = 4
RPS = 16
N_PAD = P_SHARDS * RPS


def _dense_from_bucket_stream(edge_fn, n_chunks, rps, n_shards,
                              symmetrize=False):
    """Replay the DIRECTED bucket stream host-side into the dense global
    operator; ``symmetrize=True`` adds the transpose — equal to what
    ``symmetrize_bucket_edge_fn`` streams, without eagerly dispatching
    its ``lax.cond`` per (p, q, j) (per-call XLA CPU compiles of the
    cond segfaulted flakily under the 8-device test config)."""
    a = np.zeros((n_shards * rps, n_shards * rps), dtype=np.float64)
    for p in range(n_shards):
        for q in range(n_shards):
            for j in range(n_chunks):
                r, c, v = (np.asarray(t) for t in edge_fn(p, q, j))
                keep = (r < rps) & (c < rps)
                np.add.at(
                    a,
                    (p * rps + r[keep], q * rps + c[keep]),
                    v[keep].astype(np.float64),
                )
    if symmetrize:
        a = a + a.T
    return a.astype(np.float32)


def test_mesh_stream_matches_dense_prng():
    mesh = make_mesh(P_SHARDS)
    edge_fn = make_random_bucket_edge_fn(RPS, chunk_e=32, seed=0)
    sym_fn = symmetrize_bucket_edge_fn(edge_fn, 3)
    dims = (RPS, P_SHARDS, 6)  # 3 directed + 3 transposed chunks
    a = _dense_from_bucket_stream(edge_fn, 3, RPS, P_SHARDS,
                                  symmetrize=True)
    assert np.allclose(a, a.T), "symmetrized stream must be symmetric"

    x = jnp.asarray(np.random.RandomState(1).randn(N_PAD, 8), jnp.float32)
    xs = jax.device_put(
        x, jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(
            "nodes", None))
    )
    got = spmm_streamed_mesh(sym_fn, xs, mesh, dims)
    want = a @ np.asarray(x)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5)

    # segmented execution: same math across dispatch boundaries (uneven
    # final segment: 6 chunks in segments of 4)
    got_seg = spmm_streamed_mesh_multi(
        sym_fn, xs, mesh, dims, chunks_per_dispatch=4
    )
    np.testing.assert_allclose(
        np.asarray(got_seg), np.asarray(got), rtol=1e-6, atol=1e-6
    )


def test_mesh_stream_matches_dense_real_graph():
    """A real (small) symmetric graph through the halo bucket layout:
    partition_rows_halo's [P, P, E_b] buckets ARE the stream's chunk
    source, so an on-disk edge list and the mesh stream compose."""
    import scipy.sparse as sp

    from textgcn.graph.structs import SparseGraph
    from textgcn.parallel.halo import partition_rows_halo

    rng = np.random.RandomState(3)
    n = 50
    e = 300
    row = rng.randint(0, n, e)
    col = rng.randint(0, n, e)
    val = rng.rand(e)
    # symmetrize host-side (the documented route for real graphs)
    r2 = np.concatenate([row, col])
    c2 = np.concatenate([col, row])
    v2 = np.concatenate([val, val])
    g = SparseGraph.from_coo(r2, c2, v2, n, pad_to_multiple=8)
    hg = partition_rows_halo(g, P_SHARDS, pad_edges_to_multiple=8)

    mesh = make_mesh(P_SHARDS)
    edge_fn, n_chunks, edge_args = halo_bucket_stream(hg, chunk_e=16)
    dims = (hg.rows_per_shard, P_SHARDS, n_chunks)
    x = jnp.asarray(rng.randn(hg.n_pad, 8), jnp.float32)
    xs = jax.device_put(
        x, jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(
            "nodes", None))
    )
    got = spmm_streamed_mesh(edge_fn, xs, mesh, dims, edge_args)
    a = sp.coo_matrix(
        (v2, (r2, c2)), shape=(hg.n_pad, hg.n_pad)
    ).tocsr()
    want = a @ np.asarray(x)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5)


def test_mesh_stream_grad_matches_dense():
    """d/dx sum(f(Â x)) through the symmetric mesh VJP == dense autodiff."""
    mesh = make_mesh(P_SHARDS)
    edge_fn = make_random_bucket_edge_fn(RPS, chunk_e=24, seed=4)
    sym_fn = symmetrize_bucket_edge_fn(edge_fn, 2)
    dims = (RPS, P_SHARDS, 4)
    a = jnp.asarray(
        _dense_from_bucket_stream(edge_fn, 2, RPS, P_SHARDS,
                                  symmetrize=True))
    x = jnp.asarray(np.random.RandomState(5).randn(N_PAD, 8), jnp.float32)
    xs = jax.device_put(
        x, jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(
            "nodes", None))
    )

    def f_mesh(v):
        return jnp.sum(jnp.tanh(spmm_streamed_mesh(sym_fn, v, mesh, dims)))

    def f_dense(v):
        return jnp.sum(jnp.tanh(a @ v))

    g_mesh = jax.grad(f_mesh)(xs)
    g_dense = jax.grad(f_dense)(x)
    np.testing.assert_allclose(
        np.asarray(g_mesh), np.asarray(g_dense), rtol=1e-5, atol=1e-5
    )


def _train_data(c=3, f=12, seed=6):
    rng = np.random.RandomState(seed)
    y_np = rng.randint(0, c, N_PAD)
    x = rng.randn(N_PAD, f).astype(np.float32) * 0.1
    x += np.eye(c)[y_np][:, (np.arange(f) % c)]
    mask = (rng.rand(N_PAD) < 0.6).astype(np.float32)
    return x, y_np.astype(np.int32), mask


def test_sharded_streamed_train_step_matches_dense():
    from textgcn.train.streamed import init_streamed

    c, f, h = 3, 12, 8
    mesh = make_mesh(P_SHARDS)
    edge_fn = make_random_bucket_edge_fn(RPS, chunk_e=24, seed=7)
    sym_fn = symmetrize_bucket_edge_fn(edge_fn, 2)
    dims = (RPS, P_SHARDS, 4)
    a = jnp.asarray(
        _dense_from_bucket_stream(edge_fn, 2, RPS, P_SHARDS,
                                  symmetrize=True))
    x, y, mask = _train_data(c, f)
    xs, ys, ms = shard_streamed_inputs(mesh, x, y, mask)

    params, opt, opt_state = init_streamed(jax.random.PRNGKey(8), f, h, c)
    step = make_streamed_sharded_train_step(
        sym_fn, mesh, dims, stream_dtype=jnp.float32
    )
    p_s, _, loss_s = step(params, opt_state, xs, ys, ms)

    def dense_loss(p):
        s1 = jnp.asarray(x) @ p["gc1"]["w"]
        hh = jax.nn.relu(a @ s1 + p["gc1"]["b"])
        logits = a @ (hh @ p["gc2"]["w"]) + p["gc2"]["b"]
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, jnp.asarray(y)[:, None], axis=1)[:, 0]
        return jnp.sum(nll * jnp.asarray(mask)) / jnp.sum(jnp.asarray(mask))

    params_d, _, opt_state_d = init_streamed(jax.random.PRNGKey(8), f, h, c)
    loss_d, grads = jax.value_and_grad(dense_loss)(params_d)
    updates, _ = optax.adam(0.02).update(grads, opt_state_d, params_d)
    p_d = optax.apply_updates(params_d, updates)

    np.testing.assert_allclose(float(loss_s), float(loss_d), rtol=1e-5)
    for (ka, va), (kb, vb) in zip(
        jax.tree_util.tree_leaves_with_path(p_s),
        jax.tree_util.tree_leaves_with_path(p_d),
    ):
        assert str(ka) == str(kb)
        np.testing.assert_allclose(
            np.asarray(va), np.asarray(vb), rtol=1e-4, atol=1e-5,
            err_msg=str(ka),
        )


def test_sharded_segmented_matches_monolithic_bf16():
    """Bounded-dispatch sharded step == one-dispatch sharded step in the
    production bf16 stream dtype (identical chunk schedule per bucket)."""
    from textgcn.train.streamed import init_streamed

    c, f, h = 3, 12, 8
    mesh = make_mesh(P_SHARDS)
    edge_fn = make_random_bucket_edge_fn(RPS, chunk_e=24, seed=9)
    sym_fn = symmetrize_bucket_edge_fn(edge_fn, 2)
    dims = (RPS, P_SHARDS, 4)
    x, y, mask = _train_data(c, f, seed=10)
    xs, ys, ms = shard_streamed_inputs(
        mesh, x.astype(jnp.bfloat16), y, mask
    )

    params, opt, opt_state = init_streamed(jax.random.PRNGKey(11), f, h, c)
    mono = make_streamed_sharded_train_step(sym_fn, mesh, dims)
    p_m, _, loss_m = mono(params, opt_state, xs, ys, ms)

    params2, _, opt_state2 = init_streamed(jax.random.PRNGKey(11), f, h, c)
    xs2, ys2, ms2 = shard_streamed_inputs(
        mesh, x.astype(jnp.bfloat16), y, mask
    )
    segd = make_streamed_sharded_train_step_segmented(
        sym_fn, mesh, dims, chunks_per_dispatch=3
    )
    p_s, _, loss_s = segd(params2, opt_state2, xs2, ys2, ms2)

    np.testing.assert_allclose(float(loss_s), float(loss_m), rtol=1e-6)
    for (ka, va), (kb, vb) in zip(
        jax.tree_util.tree_leaves_with_path(p_s),
        jax.tree_util.tree_leaves_with_path(p_m),
    ):
        assert str(ka) == str(kb)
        np.testing.assert_allclose(
            np.asarray(va, dtype=np.float32),
            np.asarray(vb, dtype=np.float32),
            rtol=1e-5, atol=1e-6, err_msg=str(ka),
        )


def test_sharded_streamed_training_reduces_loss():
    from textgcn.train.streamed import init_streamed

    c, f, h = 3, 12, 8
    mesh = make_mesh(P_SHARDS)
    edge_fn = make_random_bucket_edge_fn(RPS, chunk_e=24, seed=12)
    sym_fn = symmetrize_bucket_edge_fn(edge_fn, 2)
    dims = (RPS, P_SHARDS, 4)
    x, y, _ = _train_data(c, f, seed=13)
    xs, ys, ms = shard_streamed_inputs(
        mesh, x, y, np.ones(N_PAD, np.float32)
    )
    params, opt, opt_state = init_streamed(jax.random.PRNGKey(14), f, h, c)
    step = make_streamed_sharded_train_step(
        sym_fn, mesh, dims, stream_dtype=jnp.float32
    )
    losses = []
    for _ in range(10):
        params, opt_state, loss = step(params, opt_state, xs, ys, ms)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.9, losses


def test_mesh_stream_grad_with_edge_args():
    """Autodiff through spmm_streamed_mesh with NON-EMPTY edge_args (the
    halo_bucket_stream path): the custom VJP must hand back a None
    cotangent for the edge-array pytree without upsetting JAX — advisor
    r4 finding: only empty-edge_args grads were exercised."""
    import scipy.sparse as sp

    from textgcn.graph.structs import SparseGraph
    from textgcn.parallel.halo import partition_rows_halo

    rng = np.random.RandomState(21)
    n, e = 48, 260
    row = rng.randint(0, n, e)
    col = rng.randint(0, n, e)
    val = rng.rand(e)
    r2 = np.concatenate([row, col])
    c2 = np.concatenate([col, row])
    v2 = np.concatenate([val, val])
    g = SparseGraph.from_coo(r2, c2, v2, n, pad_to_multiple=8)
    hg = partition_rows_halo(g, P_SHARDS, pad_edges_to_multiple=8)
    mesh = make_mesh(P_SHARDS)
    edge_fn, n_chunks, edge_args = halo_bucket_stream(hg, chunk_e=16)
    dims = (hg.rows_per_shard, P_SHARDS, n_chunks)
    x = jnp.asarray(rng.randn(hg.n_pad, 8), jnp.float32)
    t = jnp.asarray(rng.randn(hg.n_pad, 8), jnp.float32)
    xs = jax.device_put(
        x, jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec("nodes", None))
    )

    def f_mesh(v):
        return jnp.sum(
            spmm_streamed_mesh(edge_fn, v, mesh, dims, edge_args) * t
        )

    a = sp.coo_matrix((v2, (r2, c2)), shape=(hg.n_pad, hg.n_pad)).toarray()
    ad = jnp.asarray(a, jnp.float32)

    def f_dense(v):
        return jnp.sum((ad @ v) * t)

    g_mesh = jax.grad(f_mesh)(xs)
    g_dense = jax.grad(f_dense)(x)
    np.testing.assert_allclose(
        np.asarray(g_mesh), np.asarray(g_dense), rtol=1e-5, atol=1e-5
    )


def test_sharded_streamed_gin_matches_dense():
    """The 5th streamed family on the mesh: the generic sharded factory
    with family='gin' (tape-built, reassociated (1+eps)(vW) + A(vW)
    aggregation) == the dense-operator autodiff step, f32 exact."""
    from textgcn.models.gin import gin_init
    from textgcn.parallel.streamed import (
        make_streamed_sharded_step_segmented,
    )

    c, f, h = 3, 12, 8
    mesh = make_mesh(P_SHARDS)
    edge_fn = make_random_bucket_edge_fn(RPS, chunk_e=24, seed=17)
    sym_fn = symmetrize_bucket_edge_fn(edge_fn, 2)
    dims = (RPS, P_SHARDS, 4)
    a = jnp.asarray(
        _dense_from_bucket_stream(edge_fn, 2, RPS, P_SHARDS,
                                  symmetrize=True))
    x, y, mask = _train_data(c, f, seed=18)
    xs, ys, ms = shard_streamed_inputs(mesh, x, y, mask)

    params = gin_init(jax.random.PRNGKey(19), f, h, c)
    opt = optax.adam(0.02)
    opt_state = opt.init(params)
    step = make_streamed_sharded_step_segmented(
        "gin", sym_fn, mesh, dims, stream_dtype=jnp.float32,
        chunks_per_dispatch=3,
    )
    p_s, _, loss_s = step(dict(params), opt_state, xs, ys, ms)

    def dense_loss(p):
        s1 = jnp.asarray(x) @ p["gin1"]["w1"]
        z1 = (1.0 + p["gin1"]["eps"]) * s1 + a @ s1
        hh = jax.nn.relu(z1 + p["gin1"]["b1"])
        h2 = jax.nn.relu(hh @ p["gin1"]["w2"] + p["gin1"]["b2"])
        s2 = h2 @ p["gin2"]["w"]
        logits = (1.0 + p["gin2"]["eps"]) * s2 + a @ s2 + p["gin2"]["b"]
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(
            logp, jnp.asarray(y)[:, None], axis=1
        )[:, 0]
        return jnp.sum(nll * jnp.asarray(mask)) / jnp.sum(jnp.asarray(mask))

    loss_d, grads = jax.value_and_grad(dense_loss)(params)
    updates, _ = opt.update(grads, opt.init(params), params)
    p_d = optax.apply_updates(params, updates)

    np.testing.assert_allclose(float(loss_s), float(loss_d), rtol=1e-5)
    for (ka, va), (kb, vb) in zip(
        jax.tree_util.tree_leaves_with_path(p_s),
        jax.tree_util.tree_leaves_with_path(p_d),
    ):
        assert str(ka) == str(kb)
        np.testing.assert_allclose(
            np.asarray(va), np.asarray(vb), rtol=1e-4, atol=1e-5,
            err_msg=str(ka),
        )


def test_sharded_streamed_gcnii_matches_dense():
    """The 6th streamed family on the mesh: generic sharded factory with
    family='gcnii' (K-deep initial-residual recurrence, h0 fan-out) ==
    the dense-operator autodiff step, f32 exact."""
    from textgcn.models.gcnii import gcnii_betas, gcnii_init
    from textgcn.parallel.streamed import (
        make_streamed_sharded_step_segmented,
    )

    c, f, h, kdeep, alpha, lam = 3, 12, 8, 3, 0.1, 0.5
    mesh = make_mesh(P_SHARDS)
    edge_fn = make_random_bucket_edge_fn(RPS, chunk_e=24, seed=23)
    sym_fn = symmetrize_bucket_edge_fn(edge_fn, 2)
    dims = (RPS, P_SHARDS, 4)
    a = jnp.asarray(
        _dense_from_bucket_stream(edge_fn, 2, RPS, P_SHARDS,
                                  symmetrize=True))
    x, y, mask = _train_data(c, f, seed=24)
    xs, ys, ms = shard_streamed_inputs(mesh, x, y, mask)

    params = gcnii_init(jax.random.PRNGKey(25), f, h, c, k=kdeep)
    opt = optax.adam(0.02)
    opt_state = opt.init(params)
    step = make_streamed_sharded_step_segmented(
        "gcnii", sym_fn, mesh, dims, k=kdeep, alpha=alpha, lam=lam,
        stream_dtype=jnp.float32, chunks_per_dispatch=3,
    )
    p_s, _, loss_s = step(dict(params), opt_state, xs, ys, ms)

    betas = gcnii_betas(kdeep, lam)

    def dense_loss(p):
        h0 = jax.nn.relu(
            jnp.dot(jnp.asarray(x), p["fc_in"]["w"]) + p["fc_in"]["b"]
        )
        hh = h0
        for l in range(kdeep):
            s = (1.0 - alpha) * (a @ hh) + alpha * h0
            sw = jnp.dot(s, p["deep"]["w"][l])
            hh = jax.nn.relu((1.0 - betas[l]) * s + betas[l] * sw)
        logits = jnp.dot(hh, p["fc_out"]["w"]) + p["fc_out"]["b"]
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(
            logp, jnp.asarray(y)[:, None], axis=1
        )[:, 0]
        return jnp.sum(nll * jnp.asarray(mask)) / jnp.sum(jnp.asarray(mask))

    loss_d, grads = jax.value_and_grad(dense_loss)(params)
    upd, _ = opt.update(grads, opt.init(params), params)
    p_d = optax.apply_updates(params, upd)

    np.testing.assert_allclose(float(loss_s), float(loss_d), rtol=1e-5)
    for (ka, va), (kb, vb) in zip(
        jax.tree_util.tree_leaves_with_path(p_s),
        jax.tree_util.tree_leaves_with_path(p_d),
    ):
        assert str(ka) == str(kb)
        np.testing.assert_allclose(
            np.asarray(va), np.asarray(vb), rtol=1e-4, atol=1e-5,
            err_msg=str(ka),
        )
