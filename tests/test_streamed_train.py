"""Streamed (beyond-HBM) train step oracle tests (round-2 verdict item #3:
the scale config must be TRAINABLE, not just inferable).

The streamed GCN train step — both aggregations via spmm_streamed_sym, so
neither the edge list nor any [E, F] residual ever materializes — must
match a dense-matmul implementation of the same symmetric operator
A + Aᵀ, loss AND parameter updates, at toy size with f32 streaming."""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

from textgcn.train.streamed import (
    init_streamed,
    make_streamed_train_step,
    streamed_gcn_forward,
    symmetrize_edge_fn,
)


def _toy_stream(n=64, n_chunks=4, chunk=48, seed=0):
    """Fixed directed COO split into equal chunks + its dense A + Aᵀ."""
    rng = np.random.RandomState(seed)
    e = n_chunks * chunk
    row = rng.randint(0, n, e).astype(np.int32)
    col = rng.randint(0, n, e).astype(np.int32)
    val = rng.rand(e).astype(np.float32)
    a = np.zeros((n, n), dtype=np.float64)
    np.add.at(a, (row, col), val)
    a_sym = a + a.T

    rows = jnp.asarray(row.reshape(n_chunks, chunk))
    cols = jnp.asarray(col.reshape(n_chunks, chunk))
    vals = jnp.asarray(val.reshape(n_chunks, chunk))

    def edge_fn(i):
        take = lambda arr: jax.lax.dynamic_index_in_dim(  # noqa: E731
            arr, i, 0, keepdims=False
        )
        return take(rows), take(cols), take(vals)

    return edge_fn, a_sym.astype(np.float32)


def _dense_forward(params, a, x):
    s1 = x @ params["gc1"]["w"]
    h = jax.nn.relu(a @ s1 + params["gc1"]["b"])
    return a @ (h @ params["gc2"]["w"]) + params["gc2"]["b"]


def test_streamed_forward_matches_dense():
    n, f, h, c = 64, 12, 8, 3
    edge_fn, a_sym = _toy_stream(n)
    sym_fn = symmetrize_edge_fn(edge_fn, 4)
    params, _, _ = init_streamed(jax.random.PRNGKey(0), f, h, c)
    x = jnp.asarray(np.random.RandomState(1).randn(n, f), dtype=jnp.float32)
    got = streamed_gcn_forward(
        params, sym_fn, x, n, 8, stream_dtype=jnp.float32
    )
    want = _dense_forward(params, jnp.asarray(a_sym), x)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def test_streamed_train_step_matches_dense():
    """One full streamed train step (fwd + bwd through BOTH streamed
    aggregations + Adam) == the dense-operator train step: loss and every
    updated parameter allclose."""
    n, f, h, c = 64, 12, 8, 3
    edge_fn, a_sym = _toy_stream(n)
    sym_fn = symmetrize_edge_fn(edge_fn, 4)
    rng = np.random.RandomState(2)
    x = jnp.asarray(rng.randn(n, f), dtype=jnp.float32)
    y = jnp.asarray(rng.randint(0, c, n), dtype=jnp.int32)
    mask = jnp.asarray((rng.rand(n) < 0.6), dtype=jnp.float32)

    params, opt, opt_state = init_streamed(jax.random.PRNGKey(3), f, h, c)
    step = make_streamed_train_step(
        sym_fn, n, 8, stream_dtype=jnp.float32
    )
    p_s, _, loss_s = step(params, opt_state, x, y, mask)

    # dense oracle with identical loss/optimizer semantics
    a = jnp.asarray(a_sym)

    def dense_loss(p):
        logits = _dense_forward(p, a, x)
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, y[:, None], axis=1)[:, 0]
        return jnp.sum(nll * mask) / jnp.sum(mask)

    params_d, _, opt_state_d = init_streamed(jax.random.PRNGKey(3), f, h, c)
    loss_d, grads = jax.value_and_grad(dense_loss)(params_d)
    opt_d = optax.adam(0.02)
    updates, _ = opt_d.update(grads, opt_state_d, params_d)
    p_d = optax.apply_updates(params_d, updates)

    np.testing.assert_allclose(float(loss_s), float(loss_d), rtol=1e-5)
    for (ka, va), (kb, vb) in zip(
        jax.tree_util.tree_leaves_with_path(p_s),
        jax.tree_util.tree_leaves_with_path(p_d),
    ):
        assert str(ka) == str(kb)  # same pytree structure → same order
        np.testing.assert_allclose(
            np.asarray(va), np.asarray(vb), rtol=1e-4, atol=1e-5,
            err_msg=str(ka),
        )


def test_streamed_training_reduces_loss():
    """A few streamed steps reduce the loss on a learnable toy problem."""
    n, f, h, c = 64, 12, 8, 3
    edge_fn, _ = _toy_stream(n, seed=5)
    sym_fn = symmetrize_edge_fn(edge_fn, 4)
    rng = np.random.RandomState(6)
    y_np = rng.randint(0, c, n)
    # features carry the label signal so the loss can actually drop
    x = jnp.asarray(
        rng.randn(n, f) * 0.1 + np.eye(c)[y_np][:, (np.arange(f) % c)],
        dtype=jnp.float32,
    )
    y = jnp.asarray(y_np, dtype=jnp.int32)
    mask = jnp.ones((n,), dtype=jnp.float32)
    params, opt, opt_state = init_streamed(jax.random.PRNGKey(7), f, h, c)
    step = make_streamed_train_step(sym_fn, n, 8, stream_dtype=jnp.float32)
    losses = []
    for _ in range(10):
        params, opt_state, loss = step(params, opt_state, x, y, mask)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.9, losses


def test_segmented_step_matches_monolithic():
    """The host-segmented train step (manual backward, bounded dispatches —
    make_streamed_train_step_segmented) must reproduce the monolithic
    autodiff step's loss and every updated parameter, including with an
    uneven final segment."""
    from textgcn.ops.spmm import spmm_streamed, spmm_streamed_multi
    from textgcn.train.streamed import make_streamed_train_step_segmented

    n, f, h, c = 64, 12, 8, 3
    edge_fn, _ = _toy_stream(n)
    sym_fn = symmetrize_edge_fn(edge_fn, 4)
    rng = np.random.RandomState(8)
    x = jnp.asarray(rng.randn(n, f), dtype=jnp.float32)
    y = jnp.asarray(rng.randint(0, c, n), dtype=jnp.int32)
    mask = jnp.asarray((rng.rand(n) < 0.6), dtype=jnp.float32)

    # the segmented spmm itself, with seg=3 over 8 chunks (uneven tail)
    want_agg = spmm_streamed(sym_fn, x, n, 8)
    got_agg = spmm_streamed_multi(sym_fn, x, n, 8, chunks_per_dispatch=3)
    np.testing.assert_allclose(
        np.asarray(got_agg), np.asarray(want_agg), rtol=1e-6, atol=1e-6
    )

    params, opt, opt_state = init_streamed(jax.random.PRNGKey(9), f, h, c)
    mono = make_streamed_train_step(sym_fn, n, 8, stream_dtype=jnp.float32)
    p_m, _, loss_m = mono(params, opt_state, x, y, mask)

    params2, _, opt_state2 = init_streamed(jax.random.PRNGKey(9), f, h, c)
    segd = make_streamed_train_step_segmented(
        sym_fn, n, 8, stream_dtype=jnp.float32, chunks_per_dispatch=3
    )
    p_s, _, loss_s = segd(params2, opt_state2, x, y, mask)

    np.testing.assert_allclose(float(loss_s), float(loss_m), rtol=1e-6)
    for (ka, va), (kb, vb) in zip(
        jax.tree_util.tree_leaves_with_path(p_s),
        jax.tree_util.tree_leaves_with_path(p_m),
    ):
        assert str(ka) == str(kb)
        np.testing.assert_allclose(
            np.asarray(va), np.asarray(vb), rtol=1e-5, atol=1e-6,
            err_msg=str(ka),
        )


def test_segmented_step_reduces_loss_bf16():
    """Segmented step with the production bf16 stream dtype trains."""
    from textgcn.train.streamed import make_streamed_train_step_segmented

    n, f, h, c = 64, 12, 8, 3
    edge_fn, _ = _toy_stream(n, seed=5)
    sym_fn = symmetrize_edge_fn(edge_fn, 4)
    rng = np.random.RandomState(6)
    y_np = rng.randint(0, c, n)
    x = jnp.asarray(
        rng.randn(n, f) * 0.1 + np.eye(c)[y_np][:, (np.arange(f) % c)],
        dtype=jnp.bfloat16,
    )
    y = jnp.asarray(y_np, dtype=jnp.int32)
    mask = jnp.ones((n,), dtype=jnp.float32)
    params, opt, opt_state = init_streamed(jax.random.PRNGKey(7), f, h, c)
    step = make_streamed_train_step_segmented(sym_fn, n, 8)
    losses = []
    for _ in range(10):
        params, opt_state, loss = step(params, opt_state, x, y, mask)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.9, losses


def test_segmented_step_matches_monolithic_bf16():
    """Parity in the PRODUCTION stream dtype (bf16): the f32 oracle above
    makes every cast a no-op, so it cannot catch a cast-chain divergence —
    this run pins the segmented manual backward against autodiff with
    bf16 streaming and bf16 features (both paths share the identical
    chunk schedule, so agreement should be near-exact)."""
    from textgcn.train.streamed import make_streamed_train_step_segmented

    n, f, h, c = 64, 12, 8, 3
    edge_fn, _ = _toy_stream(n, seed=11)
    sym_fn = symmetrize_edge_fn(edge_fn, 4)
    rng = np.random.RandomState(12)
    x = jnp.asarray(rng.randn(n, f), dtype=jnp.bfloat16)
    y = jnp.asarray(rng.randint(0, c, n), dtype=jnp.int32)
    mask = jnp.asarray((rng.rand(n) < 0.6), dtype=jnp.float32)

    params, opt, opt_state = init_streamed(jax.random.PRNGKey(13), f, h, c)
    mono = make_streamed_train_step(sym_fn, n, 8)
    p_m, _, loss_m = mono(params, opt_state, x, y, mask)

    params2, _, opt_state2 = init_streamed(jax.random.PRNGKey(13), f, h, c)
    segd = make_streamed_train_step_segmented(
        sym_fn, n, 8, chunks_per_dispatch=3
    )
    p_s, _, loss_s = segd(params2, opt_state2, x, y, mask)

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


def _sgc_dense_loss(p, a, x, y, mask, k=2):
    h = x @ p["lin"]["w"]
    for _ in range(k):
        h = a @ h
    logits = h + p["lin"]["b"]
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, y[:, None], axis=1)[:, 0]
    return jnp.sum(nll * mask) / jnp.sum(mask)


def test_streamed_sgc_matches_dense():
    """Streamed SGC (second family at beyond-HBM scale): forward and one
    full train step == the dense Â^k operator, f32 streaming."""
    from textgcn.models.sgc import sgc_init
    from textgcn.train.streamed import (
        make_streamed_sgc_train_step,
        streamed_sgc_forward,
    )

    n, f, c = 64, 12, 3
    edge_fn, a_sym = _toy_stream(n, seed=20)
    sym_fn = symmetrize_edge_fn(edge_fn, 4)
    rng = np.random.RandomState(21)
    x = jnp.asarray(rng.randn(n, f), dtype=jnp.float32)
    y = jnp.asarray(rng.randint(0, c, n), dtype=jnp.int32)
    mask = jnp.asarray((rng.rand(n) < 0.6), dtype=jnp.float32)
    params = sgc_init(jax.random.PRNGKey(22), f, 0, c)
    a = jnp.asarray(a_sym)

    got = streamed_sgc_forward(
        params, sym_fn, x, n, 8, stream_dtype=jnp.float32
    )
    h = x @ params["lin"]["w"]
    want = a @ (a @ h) + params["lin"]["b"]
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(want), rtol=1e-4, atol=1e-4
    )

    opt = optax.adam(0.02)
    opt_state = opt.init(params)
    step = make_streamed_sgc_train_step(
        sym_fn, n, 8, stream_dtype=jnp.float32
    )
    p_s, _, loss_s = step(params, opt_state, x, y, mask)

    params_d = sgc_init(jax.random.PRNGKey(22), f, 0, c)
    loss_d, grads = jax.value_and_grad(_sgc_dense_loss)(
        params_d, a, x, y, mask
    )
    updates, _ = optax.adam(0.02).update(
        grads, optax.adam(0.02).init(params_d), params_d
    )
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


def test_streamed_sgc_segmented_matches_monolithic_bf16():
    """SGC segmented manual backward == autodiff in the production bf16
    stream dtype (identical chunk schedule + cast chain)."""
    from textgcn.models.sgc import sgc_init
    from textgcn.train.streamed import (
        make_streamed_sgc_train_step,
        make_streamed_sgc_train_step_segmented,
    )

    n, f, c = 64, 12, 3
    edge_fn, _ = _toy_stream(n, seed=23)
    sym_fn = symmetrize_edge_fn(edge_fn, 4)
    rng = np.random.RandomState(24)
    x = jnp.asarray(rng.randn(n, f), dtype=jnp.bfloat16)
    y = jnp.asarray(rng.randint(0, c, n), dtype=jnp.int32)
    mask = jnp.asarray((rng.rand(n) < 0.6), dtype=jnp.float32)

    params = sgc_init(jax.random.PRNGKey(25), f, 0, c)
    opt = optax.adam(0.02)
    mono = make_streamed_sgc_train_step(sym_fn, n, 8)
    p_m, _, loss_m = mono(params, opt.init(params), x, y, mask)

    params2 = sgc_init(jax.random.PRNGKey(25), f, 0, c)
    segd = make_streamed_sgc_train_step_segmented(
        sym_fn, n, 8, chunks_per_dispatch=3
    )
    p_s, _, loss_s = segd(params2, opt.init(params2), x, y, mask)

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


def test_streamed_sgc_sharded_matches_single_chip():
    """The sharded streamed SGC step on the virtual 8-mesh == the
    single-chip segmented SGC step over the equivalent global stream."""
    from textgcn.models.sgc import sgc_init
    from textgcn.parallel.sharded import make_mesh
    from textgcn.parallel.streamed import (
        make_random_bucket_edge_fn,
        make_streamed_sharded_sgc_train_step_segmented,
        shard_streamed_inputs,
        symmetrize_bucket_edge_fn,
    )
    from textgcn.train.streamed import make_streamed_sgc_train_step

    p_sh, rps, f, c = 4, 16, 12, 3
    n_pad = p_sh * rps
    mesh = make_mesh(p_sh)
    edge_fn = make_random_bucket_edge_fn(rps, chunk_e=24, seed=26)
    sym_fn = symmetrize_bucket_edge_fn(edge_fn, 2)
    dims = (rps, p_sh, 4)

    # assemble the dense operator by replaying the DIRECTED stream and
    # symmetrizing host-side (A + Aᵀ == what symmetrize_bucket_edge_fn
    # streams). The sym wrapper's lax.cond must not be dispatched
    # eagerly here: per-call XLA CPU compiles of the cond segfaulted
    # flakily under the 8-device test config.
    a = np.zeros((n_pad, n_pad), dtype=np.float64)
    for p in range(p_sh):
        for q in range(p_sh):
            for j in range(2):
                r, cc, v = (np.asarray(t) for t in edge_fn(p, q, j))
                np.add.at(
                    a, (p * rps + r, q * rps + cc), v.astype(np.float64)
                )
    a = jnp.asarray((a + a.T).astype(np.float32))

    rng = np.random.RandomState(27)
    x = rng.randn(n_pad, f).astype(np.float32)
    y = rng.randint(0, c, n_pad).astype(np.int32)
    mask = (rng.rand(n_pad) < 0.6).astype(np.float32)
    xs, ys, ms = shard_streamed_inputs(mesh, x, y, mask)

    params = sgc_init(jax.random.PRNGKey(28), f, 0, c)
    opt = optax.adam(0.02)
    step = make_streamed_sharded_sgc_train_step_segmented(
        sym_fn, mesh, dims, stream_dtype=jnp.float32,
        chunks_per_dispatch=3,
    )
    p_s, _, loss_s = step(params, opt.init(params), xs, ys, ms)

    params_d = sgc_init(jax.random.PRNGKey(28), f, 0, c)
    loss_d, grads = jax.value_and_grad(_sgc_dense_loss)(
        params_d, a, jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask)
    )
    updates, _ = optax.adam(0.02).update(
        grads, optax.adam(0.02).init(params_d), params_d
    )
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


def test_streamed_appnp_matches_dense():
    """Streamed APPNP (third family at beyond-HBM scale): forward and one
    train step == the dense PPR operator, f32 streaming."""
    from textgcn.models.appnp import appnp_init
    from textgcn.train.streamed import (
        make_streamed_appnp_train_step,
        streamed_appnp_forward,
    )

    n, f, h, c = 64, 12, 8, 3
    k, alpha = 4, 0.2
    edge_fn, a_sym = _toy_stream(n, seed=30)
    sym_fn = symmetrize_edge_fn(edge_fn, 4)
    rng = np.random.RandomState(31)
    x = jnp.asarray(rng.randn(n, f), dtype=jnp.float32)
    y = jnp.asarray(rng.randint(0, c, n), dtype=jnp.int32)
    mask = jnp.asarray((rng.rand(n) < 0.6), dtype=jnp.float32)
    params = appnp_init(jax.random.PRNGKey(32), f, h, c)
    a = jnp.asarray(a_sym)

    def dense_appnp(p):
        h1 = jax.nn.relu(x @ p["fc1"]["w"] + p["fc1"]["b"])
        hm = h1 @ p["fc2"]["w"] + p["fc2"]["b"]
        z = hm
        for _ in range(k):
            z = (1 - alpha) * (a @ z) + alpha * hm
        return z

    got = streamed_appnp_forward(
        params, sym_fn, x, n, 8, alpha=alpha, k=k,
        stream_dtype=jnp.float32,
    )
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(dense_appnp(params)),
        rtol=1e-4, atol=1e-4,
    )

    opt = optax.adam(0.02)
    step = make_streamed_appnp_train_step(
        sym_fn, n, 8, alpha=alpha, k=k, stream_dtype=jnp.float32
    )
    p_s, _, loss_s = step(params, opt.init(params), x, y, mask)

    def dense_loss(p):
        logits = dense_appnp(p)
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, y[:, None], axis=1)[:, 0]
        return jnp.sum(nll * mask) / jnp.sum(mask)

    params_d = appnp_init(jax.random.PRNGKey(32), f, h, c)
    loss_d, grads = jax.value_and_grad(dense_loss)(params_d)
    updates, _ = optax.adam(0.02).update(
        grads, optax.adam(0.02).init(params_d), params_d
    )
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


def test_streamed_appnp_segmented_matches_monolithic_bf16():
    """APPNP segmented manual backward (reverse PPR chain with α-weighted
    cotangent accumulation) == autodiff in the production bf16 dtype."""
    from textgcn.models.appnp import appnp_init
    from textgcn.train.streamed import (
        make_streamed_appnp_train_step,
        make_streamed_appnp_train_step_segmented,
    )

    n, f, h, c = 64, 12, 8, 3
    k, alpha = 3, 0.15
    edge_fn, _ = _toy_stream(n, seed=33)
    sym_fn = symmetrize_edge_fn(edge_fn, 4)
    rng = np.random.RandomState(34)
    x = jnp.asarray(rng.randn(n, f), dtype=jnp.bfloat16)
    y = jnp.asarray(rng.randint(0, c, n), dtype=jnp.int32)
    mask = jnp.asarray((rng.rand(n) < 0.6), dtype=jnp.float32)

    params = appnp_init(jax.random.PRNGKey(35), f, h, c)
    opt = optax.adam(0.02)
    mono = make_streamed_appnp_train_step(sym_fn, n, 8, alpha=alpha, k=k)
    p_m, _, loss_m = mono(params, opt.init(params), x, y, mask)

    params2 = appnp_init(jax.random.PRNGKey(35), f, h, c)
    segd = make_streamed_appnp_train_step_segmented(
        sym_fn, n, 8, alpha=alpha, k=k, chunks_per_dispatch=3
    )
    p_s, _, loss_s = segd(params2, opt.init(params2), x, y, mask)

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


def test_streamed_appnp_sharded_matches_single_chip():
    """The sharded streamed APPNP step on the virtual mesh == the dense
    PPR-operator train step (third family at beyond-HBM scale, sharded)."""
    from textgcn.models.appnp import appnp_init
    from textgcn.parallel.sharded import make_mesh
    from textgcn.parallel.streamed import (
        make_random_bucket_edge_fn,
        make_streamed_sharded_appnp_train_step_segmented,
        shard_streamed_inputs,
        symmetrize_bucket_edge_fn,
    )

    p_sh, rps, f, h, c = 4, 16, 12, 8, 3
    kk, alpha = 3, 0.2
    n_pad = p_sh * rps
    mesh = make_mesh(p_sh)
    edge_fn = make_random_bucket_edge_fn(rps, chunk_e=24, seed=40)
    sym_fn = symmetrize_bucket_edge_fn(edge_fn, 2)
    dims = (rps, p_sh, 4)

    a = np.zeros((n_pad, n_pad), dtype=np.float64)
    for p in range(p_sh):
        for q in range(p_sh):
            for j in range(2):
                r, cc, v = (np.asarray(t) for t in edge_fn(p, q, j))
                np.add.at(
                    a, (p * rps + r, q * rps + cc), v.astype(np.float64)
                )
    a = jnp.asarray((a + a.T).astype(np.float32))

    rng = np.random.RandomState(41)
    x = rng.randn(n_pad, f).astype(np.float32)
    y = rng.randint(0, c, n_pad).astype(np.int32)
    mask = (rng.rand(n_pad) < 0.6).astype(np.float32)
    xs, ys, ms = shard_streamed_inputs(mesh, x, y, mask)

    params = appnp_init(jax.random.PRNGKey(42), f, h, c)
    opt = optax.adam(0.02)
    step = make_streamed_sharded_appnp_train_step_segmented(
        sym_fn, mesh, dims, alpha=alpha, k=kk,
        stream_dtype=jnp.float32, chunks_per_dispatch=3,
    )
    p_s, _, loss_s = step(params, opt.init(params), xs, ys, ms)

    def dense_loss(p):
        h1 = jax.nn.relu(jnp.asarray(x) @ p["fc1"]["w"] + p["fc1"]["b"])
        hm = h1 @ p["fc2"]["w"] + p["fc2"]["b"]
        z = hm
        for _ in range(kk):
            z = (1 - alpha) * (a @ z) + alpha * hm
        logp = jax.nn.log_softmax(z, axis=-1)
        nll = -jnp.take_along_axis(
            logp, jnp.asarray(y)[:, None], axis=1
        )[:, 0]
        m = jnp.asarray(mask)
        return jnp.sum(nll * m) / jnp.sum(m)

    params_d = appnp_init(jax.random.PRNGKey(42), f, h, c)
    loss_d, grads = jax.value_and_grad(dense_loss)(params_d)
    updates, _ = optax.adam(0.02).update(
        grads, optax.adam(0.02).init(params_d), params_d
    )
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


def test_hostfed_stream_matches_dense(tmp_path):
    """Host-fed chunk streaming (edges on disk via np.memmap — the REAL
    beyond-HBM edge source): Â@x and a full segmented GCN train step must
    match the dense operator, including an uneven padded tail chunk."""
    from textgcn.ops.spmm import (
        edge_chunks_from_memmap,
        spmm_streamed_hostfed,
    )
    from textgcn.train.streamed import (
        make_streamed_train_step_segmented,
    )

    n, f, h, c = 64, 12, 8, 3
    rng = np.random.RandomState(50)
    e_dir = 150  # not a chunk multiple: exercises the padded tail
    row = rng.randint(0, n, e_dir).astype(np.int32)
    col = rng.randint(0, n, e_dir).astype(np.int32)
    val = rng.rand(e_dir).astype(np.float32)
    # symmetrize host-side — the documented route for real graphs
    r2 = np.concatenate([row, col])
    c2 = np.concatenate([col, row])
    v2 = np.concatenate([val, val])
    np.asarray(r2, np.int32).tofile(tmp_path / "row.bin")
    np.asarray(c2, np.int32).tofile(tmp_path / "col.bin")
    np.asarray(v2, np.float32).tofile(tmp_path / "val.bin")
    chunks = edge_chunks_from_memmap(
        str(tmp_path / "row.bin"), str(tmp_path / "col.bin"),
        str(tmp_path / "val.bin"), chunk_e=64,
    )
    a = np.zeros((n, n), dtype=np.float64)
    np.add.at(a, (r2, c2), v2)
    a = jnp.asarray(a.astype(np.float32))

    x = jnp.asarray(rng.randn(n, f), dtype=jnp.float32)
    got = spmm_streamed_hostfed(chunks, x, n)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(a @ x), rtol=1e-5, atol=1e-5
    )
    # the source is RE-ITERABLE: a second pass (as every backward pass
    # must do) gives the same answer
    got2 = spmm_streamed_hostfed(chunks, x, n)
    np.testing.assert_allclose(np.asarray(got2), np.asarray(got))

    # full segmented train step fed from disk via the stream_fn hook
    y = jnp.asarray(rng.randint(0, c, n), dtype=jnp.int32)
    mask = jnp.asarray((rng.rand(n) < 0.6), dtype=jnp.float32)
    params, opt, opt_state = init_streamed(jax.random.PRNGKey(51), f, h, c)
    step = make_streamed_train_step_segmented(
        None, n, 1, stream_dtype=jnp.float32,
        stream_fn=lambda v: spmm_streamed_hostfed(chunks, v, n),
    )
    p_s, _, loss_s = step(params, opt_state, x, y, mask)

    def dense_loss(p):
        logits = _dense_forward(p, a, x)
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, y[:, None], axis=1)[:, 0]
        return jnp.sum(nll * mask) / jnp.sum(mask)

    params_d, _, opt_state_d = init_streamed(jax.random.PRNGKey(51), f, h, c)
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


def test_streamed_sage_tape_matches_dense():
    """The tape-built streamed GraphSAGE step (4th beyond-HBM family) ==
    the dense-operator autodiff oracle, f32 exact path."""
    import optax

    from textgcn.models.sage import sage_init
    from textgcn.train.streamed import (
        make_streamed_sage_train_step_segmented,
        symmetrize_edge_fn,
    )

    n, n_chunks = 64, 4
    edge_fn, a_sym = _toy_stream(n=n, n_chunks=n_chunks)
    sym_fn = symmetrize_edge_fn(edge_fn, n_chunks)
    rng = np.random.RandomState(11)
    f, h, c = 10, 6, 3
    x = jnp.asarray(rng.randn(n, f), jnp.float32)
    y = jnp.asarray(rng.randint(0, c, n), jnp.int32)
    mask = jnp.asarray((rng.rand(n) < 0.6), jnp.float32)
    params = sage_init(jax.random.PRNGKey(2), f, h, c)
    opt = optax.adam(0.02)
    opt_state = opt.init(params)
    step = make_streamed_sage_train_step_segmented(
        sym_fn, n, 2 * n_chunks, stream_dtype=jnp.float32,
        chunks_per_dispatch=3,
    )
    p2, _, loss = step(dict(params), opt_state, x, y, mask)

    ad = jnp.asarray(a_sym, jnp.float32)

    def dense_loss(p):
        n1 = ad @ jnp.dot(x, p["sage1"]["w_neigh"])
        hh = jax.nn.relu(
            jnp.dot(x, p["sage1"]["w_self"]) + n1 + p["sage1"]["b"]
        )
        n2 = ad @ jnp.dot(hh, p["sage2"]["w_neigh"])
        logits = (
            jnp.dot(hh, p["sage2"]["w_self"]) + n2 + p["sage2"]["b"]
        )
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, y[:, None], axis=1)[:, 0]
        return jnp.sum(nll * mask) / jnp.sum(mask)

    loss_d, grads = jax.value_and_grad(dense_loss)(params)
    np.testing.assert_allclose(float(loss), float(loss_d), rtol=2e-4)
    upd, _ = opt.update(grads, opt.init(params), params)
    import optax as _ox

    want = _ox.apply_updates(params, upd)
    for lyr in ("sage1", "sage2"):
        for leaf in ("w_self", "w_neigh", "b"):
            np.testing.assert_allclose(
                np.asarray(p2[lyr][leaf]), np.asarray(want[lyr][leaf]),
                rtol=2e-3, atol=2e-4,
            )


def test_streamed_gin_tape_matches_dense():
    """The tape-built streamed GIN step (5th beyond-HBM family) == the
    dense-operator autodiff oracle on the REASSOCIATED aggregation
    (1+eps)(vW) + A(vW), f32 exact path."""
    import optax

    from textgcn.models.gin import gin_init
    from textgcn.train.streamed import (
        make_streamed_gin_train_step_segmented,
        symmetrize_edge_fn,
    )

    n, n_chunks = 64, 4
    edge_fn, a_sym = _toy_stream(n=n, n_chunks=n_chunks)
    sym_fn = symmetrize_edge_fn(edge_fn, n_chunks)
    rng = np.random.RandomState(13)
    f, h, c = 10, 6, 3
    x = jnp.asarray(rng.randn(n, f), jnp.float32)
    y = jnp.asarray(rng.randint(0, c, n), jnp.int32)
    mask = jnp.asarray((rng.rand(n) < 0.6), jnp.float32)
    params = gin_init(jax.random.PRNGKey(3), f, h, c)
    opt = optax.adam(0.02)
    opt_state = opt.init(params)
    step = make_streamed_gin_train_step_segmented(
        sym_fn, n, 2 * n_chunks, stream_dtype=jnp.float32,
        chunks_per_dispatch=3,
    )
    p2, _, loss = step(dict(params), opt_state, x, y, mask)

    ad = jnp.asarray(a_sym, jnp.float32)

    def dense_loss(p):
        s1 = jnp.dot(x, p["gin1"]["w1"])
        z1 = (1.0 + p["gin1"]["eps"]) * s1 + ad @ s1
        hh = jax.nn.relu(z1 + p["gin1"]["b1"])
        h2 = jax.nn.relu(jnp.dot(hh, p["gin1"]["w2"]) + p["gin1"]["b2"])
        s2 = jnp.dot(h2, p["gin2"]["w"])
        logits = (1.0 + p["gin2"]["eps"]) * s2 + ad @ s2 + p["gin2"]["b"]
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, y[:, None], axis=1)[:, 0]
        return jnp.sum(nll * mask) / jnp.sum(mask)

    loss_d, grads = jax.value_and_grad(dense_loss)(params)
    np.testing.assert_allclose(float(loss), float(loss_d), rtol=2e-4)
    upd, _ = opt.update(grads, opt.init(params), params)
    want = optax.apply_updates(params, upd)
    for lyr, leaves in (
        ("gin1", ("eps", "w1", "b1", "w2", "b2")),
        ("gin2", ("eps", "w", "b")),
    ):
        for leaf in leaves:
            np.testing.assert_allclose(
                np.asarray(p2[lyr][leaf]), np.asarray(want[lyr][leaf]),
                rtol=2e-3, atol=2e-4, err_msg=f"{lyr}/{leaf}",
            )


def test_streamed_gcnii_tape_matches_dense():
    """The tape-built streamed GCNII step (6th beyond-HBM family; K deep
    layers, initial-residual fan-out of h0 into every layer) == the
    dense-operator autodiff oracle, f32 exact path."""
    import optax

    from textgcn.models.gcnii import gcnii_betas, gcnii_init
    from textgcn.train.streamed import (
        make_streamed_gcnii_train_step_segmented,
        symmetrize_edge_fn,
    )

    n, n_chunks, kdeep = 64, 4, 3
    edge_fn, a_sym = _toy_stream(n=n, n_chunks=n_chunks)
    sym_fn = symmetrize_edge_fn(edge_fn, n_chunks)
    rng = np.random.RandomState(21)
    f, h, c, alpha, lam = 10, 6, 3, 0.1, 0.5
    x = jnp.asarray(rng.randn(n, f), jnp.float32)
    y = jnp.asarray(rng.randint(0, c, n), jnp.int32)
    mask = jnp.asarray((rng.rand(n) < 0.6), jnp.float32)
    params = gcnii_init(jax.random.PRNGKey(4), f, h, c, k=kdeep)
    opt = optax.adam(0.02)
    opt_state = opt.init(params)
    step = make_streamed_gcnii_train_step_segmented(
        sym_fn, n, 2 * n_chunks, k=kdeep, alpha=alpha, lam=lam,
        stream_dtype=jnp.float32, chunks_per_dispatch=3,
    )
    p2, _, loss = step(dict(params), opt_state, x, y, mask)

    ad = jnp.asarray(a_sym, jnp.float32)
    betas = gcnii_betas(kdeep, lam)

    def dense_loss(p):
        h0 = jax.nn.relu(jnp.dot(x, p["fc_in"]["w"]) + p["fc_in"]["b"])
        hh = h0
        for l in range(kdeep):
            s = (1.0 - alpha) * (ad @ hh) + alpha * h0
            sw = jnp.dot(s, p["deep"]["w"][l])
            hh = jax.nn.relu((1.0 - betas[l]) * s + betas[l] * sw)
        logits = jnp.dot(hh, p["fc_out"]["w"]) + p["fc_out"]["b"]
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, y[:, None], axis=1)[:, 0]
        return jnp.sum(nll * mask) / jnp.sum(mask)

    loss_d, grads = jax.value_and_grad(dense_loss)(params)
    np.testing.assert_allclose(float(loss), float(loss_d), rtol=2e-4)
    upd, _ = opt.update(grads, opt.init(params), params)
    want = optax.apply_updates(params, upd)
    for (ka, va), (kb, vb) in zip(
        jax.tree_util.tree_leaves_with_path(p2),
        jax.tree_util.tree_leaves_with_path(want),
    ):
        assert str(ka) == str(kb)
        np.testing.assert_allclose(
            np.asarray(va), np.asarray(vb), rtol=2e-3, atol=2e-4,
            err_msg=str(ka),
        )
