"""SGC and APPNP model families: dense numpy oracles, precompute
equivalence, identity-feature paths, and end-to-end training through the
Trainer registry (TrainConfig.model). Both are new capabilities beyond the
reference's single 2-layer GCN (reference layer.py:143-190)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from textgcn.graph.normalize import sym_normalize_coo
from textgcn.graph.structs import SparseGraph
from textgcn.models.appnp import appnp_forward, appnp_init
from textgcn.models.sgc import (
    sgc_forward,
    sgc_init,
    sgc_pre_forward,
    sgc_precompute,
)


def _graph(n=30, e0=90, seed=0, pad=64):
    rng = np.random.RandomState(seed)
    r, c, v = sym_normalize_coo(
        rng.randint(0, n, e0), rng.randint(0, n, e0), rng.rand(e0), n
    )
    return SparseGraph.from_coo(r, c, v, n, pad_to_multiple=pad), rng


def test_sgc_matches_dense_oracle():
    g, rng = _graph(seed=1)
    n, f, c = g.n_nodes, 7, 4
    x = rng.randn(n, f).astype(np.float32)
    params = sgc_init(jax.random.PRNGKey(0), f, 99, c)
    got = np.asarray(sgc_forward(params, g, jnp.asarray(x), k=2))
    a = np.asarray(g.to_scipy().todense())
    w = np.asarray(params["lin"]["w"])
    b = np.asarray(params["lin"]["b"])
    want = a @ (a @ (x @ w)) + b
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_sgc_identity_features():
    """x=None: W is the node table, logits = A^2 W + b; I_N never built."""
    g, rng = _graph(n=20, e0=50, seed=2)
    params = sgc_init(jax.random.PRNGKey(1), g.n_nodes, 99, 3)
    got = np.asarray(sgc_forward(params, g, None, k=2))
    a = np.asarray(g.to_scipy().todense())
    want = a @ (a @ np.asarray(params["lin"]["w"])) + np.asarray(
        params["lin"]["b"]
    )
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_sgc_precompute_equivalence():
    """Training on sgc_precompute'd features with the gather-free linear
    head gives exactly the recomputing forward: A^k (X W) = (A^k X) W."""
    g, rng = _graph(seed=3)
    n, f, c = g.n_nodes, 6, 3
    x = jnp.asarray(rng.randn(n, f).astype(np.float32))
    params = sgc_init(jax.random.PRNGKey(2), f, 99, c)
    xp = sgc_precompute(g, x, k=2)
    got = np.asarray(sgc_pre_forward(params, None, xp))
    want = np.asarray(sgc_forward(params, g, x, k=2))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_sgc_pre_rejects_identity_features():
    params = sgc_init(jax.random.PRNGKey(0), 4, 99, 2)
    with pytest.raises(ValueError, match="precomputed"):
        sgc_pre_forward(params, None, None)


def test_appnp_alpha_one_is_pure_mlp():
    """alpha=1 fully teleports: propagation is a no-op, logits == MLP(x)."""
    g, rng = _graph(seed=4)
    n, f, h, c = g.n_nodes, 5, 8, 3
    x = rng.randn(n, f).astype(np.float32)
    params = appnp_init(jax.random.PRNGKey(3), f, h, c)
    got = np.asarray(
        appnp_forward(params, g, jnp.asarray(x), alpha=1.0, k=7)
    )
    h1 = np.maximum(
        x @ np.asarray(params["fc1"]["w"]) + np.asarray(params["fc1"]["b"]),
        0.0,
    )
    want = h1 @ np.asarray(params["fc2"]["w"]) + np.asarray(
        params["fc2"]["b"]
    )
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_appnp_matches_dense_power_iteration():
    g, rng = _graph(seed=5)
    n, f, h, c = g.n_nodes, 5, 8, 3
    x = rng.randn(n, f).astype(np.float32)
    params = appnp_init(jax.random.PRNGKey(4), f, h, c)
    alpha, k = 0.2, 3
    got = np.asarray(
        appnp_forward(params, g, jnp.asarray(x), alpha=alpha, k=k)
    )
    a = np.asarray(g.to_scipy().todense())
    h1 = np.maximum(
        x @ np.asarray(params["fc1"]["w"]) + np.asarray(params["fc1"]["b"]),
        0.0,
    )
    hm = h1 @ np.asarray(params["fc2"]["w"]) + np.asarray(params["fc2"]["b"])
    z = hm.copy()
    for _ in range(k):
        z = (1 - alpha) * (a @ z) + alpha * hm
    np.testing.assert_allclose(got, z, rtol=1e-4, atol=1e-5)


def test_appnp_identity_features():
    g, rng = _graph(n=24, e0=60, seed=6)
    params = appnp_init(jax.random.PRNGKey(5), g.n_nodes, 6, 2)
    out = appnp_forward(params, g, None, train=False)
    assert out.shape == (g.n_nodes, 2)
    assert np.isfinite(np.asarray(out)).all()


def _separable_problem(seed=7, n=60):
    """Two planted communities with intra-community edges: propagation-based
    models should separate them well above chance."""
    rng = np.random.RandomState(seed)
    y = np.arange(n) % 2
    rows, cols = [], []
    for _ in range(6 * n):
        grp = rng.randint(2)
        members = np.where(y == grp)[0]
        i, j = rng.choice(members, 2, replace=False)
        rows.append(i)
        cols.append(j)
    r, c, v = sym_normalize_coo(
        np.asarray(rows), np.asarray(cols), np.ones(len(rows)), n
    )
    g = SparseGraph.from_coo(r, c, v, n, pad_to_multiple=64)
    x = rng.randn(n, 8).astype(np.float32)
    x[:, 0] += 0.5 * (2 * y - 1)  # weak feature signal
    return g, x, y


@pytest.mark.parametrize("model", ["sgc", "appnp"])
def test_trains_end_to_end_via_registry(model):
    from textgcn.train.trainer import TrainConfig, Trainer

    g, x, y = _separable_problem()
    n = g.n_nodes
    idx = np.random.RandomState(0).permutation(n)
    cfg = TrainConfig(
        n_hidden=16, max_epoch=60, early_stopping=60, dropout=0.0,
        seed=0, epoch_block=10, model=model, lr=0.05,
    )
    t = Trainer(g, x, y, idx[:40], idx[40:], 2, config=cfg)
    t.fit(verbose=False)
    assert t.history[-1]["train_loss"] < t.history[0]["train_loss"]
    res = t.test()
    assert np.isfinite(res["test_loss"])
    assert res["acc"] > 0.6  # well above the 0.5 chance line


def test_registry_contains_new_families():
    from textgcn.models import MODELS

    for name in ("sgc", "sgc_pre", "appnp"):
        assert name in MODELS
        init, fwd = MODELS[name]
        assert callable(init) and callable(fwd)


@pytest.mark.parametrize("fmt", ["dense", "auto"])
def test_sgc_through_other_spmm_formats(fmt):
    """SGC trains through any differentiable SpMM format, not just COO."""
    from textgcn.graph.format import convert_graph

    g, rng = _graph(n=40, e0=160, seed=8)
    x = np.asarray(rng.randn(40, 6).astype(np.float32))
    params = sgc_init(jax.random.PRNGKey(6), 6, 99, 3)
    want = np.asarray(sgc_forward(params, g, jnp.asarray(x)))
    g2 = convert_graph(g, fmt)
    x2 = jnp.asarray(x)

    def loss(p):
        return jnp.sum(sgc_forward(p, g2, x2) ** 2)

    got = np.asarray(sgc_forward(params, g2, x2))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    grads = jax.grad(loss)(params)
    assert np.isfinite(np.asarray(grads["lin"]["w"])).all()
    assert float(jnp.max(jnp.abs(grads["lin"]["w"]))) > 0.0


def test_sage_matches_dense_oracle():
    """GraphSAGE layer: x W_self + Â (x W_neigh) + b, two layers + ReLU."""
    from textgcn.models.sage import sage_forward, sage_init

    g, rng = _graph(seed=9)
    n, f, h, c = g.n_nodes, 7, 8, 4
    x = rng.randn(n, f).astype(np.float32)
    params = sage_init(jax.random.PRNGKey(7), f, h, c)
    got = np.asarray(sage_forward(params, g, jnp.asarray(x), train=False))
    a = np.asarray(g.to_scipy().todense())

    def layer(p, xx):
        return (
            xx @ np.asarray(p["w_self"])
            + a @ (xx @ np.asarray(p["w_neigh"]))
            + np.asarray(p["b"])
        )

    h1 = np.maximum(layer(params["sage1"], x), 0.0)
    want = layer(params["sage2"], h1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_sage_identity_features():
    from textgcn.models.sage import sage_forward, sage_init

    g, rng = _graph(n=24, e0=60, seed=10)
    params = sage_init(jax.random.PRNGKey(8), g.n_nodes, 6, 2)
    got = np.asarray(sage_forward(params, g, None, train=False))
    a = np.asarray(g.to_scipy().todense())
    p1, p2 = params["sage1"], params["sage2"]
    h1 = np.maximum(
        np.asarray(p1["w_self"]) + a @ np.asarray(p1["w_neigh"])
        + np.asarray(p1["b"]),
        0.0,
    )
    want = (
        h1 @ np.asarray(p2["w_self"])
        + a @ (h1 @ np.asarray(p2["w_neigh"]))
        + np.asarray(p2["b"])
    )
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_sage_trains_end_to_end_via_registry():
    from textgcn.train.trainer import TrainConfig, Trainer

    g, x, y = _separable_problem(seed=11)
    n = g.n_nodes
    idx = np.random.RandomState(0).permutation(n)
    cfg = TrainConfig(
        n_hidden=16, max_epoch=60, early_stopping=60, dropout=0.0,
        seed=0, epoch_block=10, model="sage", lr=0.05,
    )
    t = Trainer(g, x, y, idx[:40], idx[40:], 2, config=cfg)
    t.fit(verbose=False)
    assert t.history[-1]["train_loss"] < t.history[0]["train_loss"]
    res = t.test()
    assert res["acc"] > 0.6


def test_gin_matches_dense_oracle():
    """GIN layer: MLP((1+eps)·x + Âx); layer 2 is a linear head."""
    from textgcn.models.gin import gin_forward, gin_init

    g, rng = _graph(seed=12)
    n, f, h, c = g.n_nodes, 7, 8, 4
    x = rng.randn(n, f).astype(np.float32)
    params = gin_init(jax.random.PRNGKey(9), f, h, c)
    # non-zero eps so the self-scaling term is actually exercised
    params["gin1"]["eps"] = jnp.asarray(0.3, jnp.float32)
    params["gin2"]["eps"] = jnp.asarray(-0.1, jnp.float32)
    got = np.asarray(gin_forward(params, g, jnp.asarray(x), train=False))
    a = np.asarray(g.to_scipy().todense())
    p1, p2 = params["gin1"], params["gin2"]
    agg1 = (1.0 + float(p1["eps"])) * x + a @ x
    h1 = np.maximum(agg1 @ np.asarray(p1["w1"]) + np.asarray(p1["b1"]), 0.0)
    h1 = np.maximum(
        h1 @ np.asarray(p1["w2"]) + np.asarray(p1["b2"]), 0.0
    )
    agg2 = (1.0 + float(p2["eps"])) * h1 + a @ h1
    want = agg2 @ np.asarray(p2["w"]) + np.asarray(p2["b"])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_gin_identity_features():
    """x=None: ((1+eps)I + Â)W == (1+eps)W + ÂW per layer, I_N never built."""
    from textgcn.models.gin import gin_forward, gin_init

    g, rng = _graph(n=24, e0=60, seed=13)
    params = gin_init(jax.random.PRNGKey(10), g.n_nodes, 6, 2)
    params["gin1"]["eps"] = jnp.asarray(0.25, jnp.float32)
    got = np.asarray(gin_forward(params, g, None, train=False))
    a = np.asarray(g.to_scipy().todense())
    p1, p2 = params["gin1"], params["gin2"]
    w1 = np.asarray(p1["w1"])
    agg1 = (1.0 + float(p1["eps"])) * w1 + a @ w1
    h1 = np.maximum(agg1 + np.asarray(p1["b1"]), 0.0)
    h1 = np.maximum(h1 @ np.asarray(p1["w2"]) + np.asarray(p1["b2"]), 0.0)
    agg2 = (1.0 + float(p2["eps"])) * h1 + a @ h1
    want = agg2 @ np.asarray(p2["w"]) + np.asarray(p2["b"])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_gin_trains_end_to_end_via_registry():
    from textgcn.train.trainer import TrainConfig, Trainer

    g, x, y = _separable_problem(seed=14)
    n = g.n_nodes
    idx = np.random.RandomState(0).permutation(n)
    cfg = TrainConfig(
        n_hidden=16, max_epoch=60, early_stopping=60, dropout=0.0,
        seed=0, epoch_block=10, model="gin", lr=0.05,
    )
    t = Trainer(g, x, y, idx[:40], idx[40:], 2, config=cfg)
    t.fit(verbose=False)
    assert t.history[-1]["train_loss"] < t.history[0]["train_loss"]
    res = t.test()
    assert res["acc"] > 0.6
    # eps is learnable: it must have moved off its 0 init
    assert float(jnp.abs(t.params["gin1"]["eps"])) > 0.0


def test_gcnii_forward_matches_numpy_oracle():
    """K-layer GCNII vs a literal numpy transcription of the recurrence:
    s_l = (1-a) A h + a h0; h_l = relu((1-b_l) s + b_l s W_l)."""
    import jax

    from textgcn.models.gcnii import (
        DEFAULT_ALPHA,
        DEFAULT_LAMBDA,
        gcnii_forward,
        gcnii_init,
    )

    g, x, _ = _separable_problem(seed=21)
    params = gcnii_init(jax.random.PRNGKey(4), 8, 16, 2, k=4)
    got = np.asarray(gcnii_forward(params, g, jnp.asarray(x), train=False))

    a = np.asarray(g.to_scipy().todense())
    h0 = np.maximum(
        x @ np.asarray(params["fc_in"]["w"]) + np.asarray(params["fc_in"]["b"]),
        0.0,
    )
    h = h0
    for layer in range(4):
        beta = np.log(DEFAULT_LAMBDA / (layer + 1) + 1.0)
        s = (1.0 - DEFAULT_ALPHA) * (a @ h) + DEFAULT_ALPHA * h0
        w = np.asarray(params["deep"]["w"][layer])
        h = np.maximum((1.0 - beta) * s + beta * (s @ w), 0.0)
    want = h @ np.asarray(params["fc_out"]["w"]) + np.asarray(
        params["fc_out"]["b"]
    )
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_gcnii_trains_end_to_end_via_registry():
    from textgcn.train.trainer import TrainConfig, Trainer

    g, x, y = _separable_problem(seed=22)
    n = g.n_nodes
    idx = np.random.RandomState(1).permutation(n)
    cfg = TrainConfig(
        n_hidden=16, max_epoch=60, early_stopping=60, dropout=0.0,
        seed=0, epoch_block=10, model="gcnii", lr=0.05,
    )
    t = Trainer(g, x, y, idx[:40], idx[40:], 2, config=cfg)
    t.fit(verbose=False)
    assert t.history[-1]["train_loss"] < t.history[0]["train_loss"]
    assert t.test()["acc"] > 0.6


def test_gcnii_identity_features():
    """x=None: fc_in.w is the [n_nodes, H] node table; the deep scan and
    both heads must run and produce finite logits."""
    import jax

    from textgcn.models.gcnii import gcnii_forward, gcnii_init

    g, _, _ = _separable_problem(seed=23)
    params = gcnii_init(jax.random.PRNGKey(5), g.n_nodes, 12, 3, k=3)
    out = np.asarray(gcnii_forward(params, g, None, train=False))
    assert out.shape == (g.n_nodes, 3)
    assert np.isfinite(out).all()
