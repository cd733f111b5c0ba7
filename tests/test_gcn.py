"""GCN model semantics vs a hand-rolled numpy oracle."""
import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp

from textgcn.graph.normalize import sym_normalize_coo
from textgcn.graph.structs import SparseGraph
from textgcn.models.gcn import GCN, gcn_forward, gcn_init


def _toy_graph(n=40, nnz=150, seed=0):
    rng = np.random.RandomState(seed)
    row = rng.randint(0, n, nnz)
    col = rng.randint(0, n, nnz)
    val = rng.rand(nnz)
    m = sp.coo_matrix((val, (row, col)), shape=(n, n))
    m = m.maximum(m.T).tocoo()
    r, c, v = sym_normalize_coo(m.row, m.col, m.data, n)
    return SparseGraph.from_coo(r, c, v, n, pad_to_multiple=128)


def test_forward_matches_numpy_oracle():
    n, f, h, cdim = 40, 12, 8, 3
    g = _toy_graph(n)
    x = np.random.RandomState(1).randn(n, f).astype(np.float32)
    params = gcn_init(jax.random.PRNGKey(0), f, h, cdim)
    got = np.asarray(gcn_forward(params, g, jnp.asarray(x), train=False))

    a = g.to_scipy().toarray()
    w1, b1 = np.asarray(params["gc1"]["w"]), np.asarray(params["gc1"]["b"])
    w2, b2 = np.asarray(params["gc2"]["w"]), np.asarray(params["gc2"]["b"])
    h1 = np.maximum(a @ (x @ w1) + b1, 0.0)
    want = a @ (h1 @ w2) + b2
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_init_matches_reference_distribution():
    # U(-s, s) with s = 1/sqrt(fan_out)  (reference layer.py:67-82)
    params = gcn_init(jax.random.PRNGKey(0), 100, 200, 8)
    w1 = np.asarray(params["gc1"]["w"])
    s = 1.0 / np.sqrt(200)
    assert w1.min() >= -s and w1.max() <= s
    assert abs(w1.mean()) < 0.005
    w2 = np.asarray(params["gc2"]["w"])
    s2 = 1.0 / np.sqrt(8)
    assert w2.min() >= -s2 and w2.max() <= s2


def test_param_count_r8_config():
    # Reference reports ~21,808 params for the R8 config (trainer.py:310-311)
    model = GCN(n_feat=100, n_hidden=200, n_class=8)
    params = model.init(jax.random.PRNGKey(0))
    assert model.param_count(params) == 100 * 200 + 200 + 200 * 8 + 8


def test_dropout_train_vs_eval():
    n, f = 30, 10
    g = _toy_graph(n)
    x = jnp.asarray(np.random.RandomState(2).randn(n, f).astype(np.float32))
    params = gcn_init(jax.random.PRNGKey(1), f, 16, 4)
    out_eval = gcn_forward(params, g, x, train=False)
    out_eval2 = gcn_forward(params, g, x, train=False)
    np.testing.assert_allclose(np.asarray(out_eval), np.asarray(out_eval2))
    out_tr1 = gcn_forward(
        params, g, x, train=True, dropout=0.5, rng=jax.random.PRNGKey(3)
    )
    out_tr2 = gcn_forward(
        params, g, x, train=True, dropout=0.5, rng=jax.random.PRNGKey(4)
    )
    assert not np.allclose(np.asarray(out_tr1), np.asarray(out_tr2))
