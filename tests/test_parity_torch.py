"""Per-layer parity vs an independent torch implementation of the reference
semantics (reference layer.py:84-112, 164-190: support = X@W via spmm,
out = spmm(Â, support) + b, ReLU, dropout, second layer).

The torch model here is written from the reference's *math* (documented in
SURVEY.md §3.4), not copied code; torch (CPU) ships in this image and gives
an independent oracle including torch.spmm's sparse kernels.
"""
import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from textgcn.graph.normalize import sym_normalize_coo
from textgcn.graph.structs import SparseGraph
from textgcn.models.gcn import gcn_forward, gcn_init, graph_conv


def _scipy_to_torch_sparse(m):
    m = m.tocoo().astype(np.float32)
    idx = torch.from_numpy(np.vstack([m.row, m.col]).astype(np.int64))
    return torch.sparse_coo_tensor(
        idx, torch.from_numpy(m.data), tuple(m.shape)
    ).coalesce()


def _setup(n=60, nnz=250, f=20, h=16, c=4, seed=0):
    rng = np.random.RandomState(seed)
    row = rng.randint(0, n, nnz)
    col = rng.randint(0, n, nnz)
    val = rng.rand(nnz)
    m = sp.coo_matrix((val, (row, col)), shape=(n, n))
    m = m.maximum(m.T).tocoo()
    r, cc, v = sym_normalize_coo(m.row, m.col, m.data, n)
    g = SparseGraph.from_coo(r, cc, v, n, pad_to_multiple=128)
    a_torch = _scipy_to_torch_sparse(
        sp.coo_matrix((v, (r, cc)), shape=(n, n))
    )
    x = rng.randn(n, f).astype(np.float32)
    params = gcn_init(jax.random.PRNGKey(seed), f, h, c)
    return g, a_torch, x, params


def _torch_layer(a_sp, x_t, w, b):
    support = torch.mm(x_t, w)  # reference uses spmm(X_sparse, W); X dense here
    out = torch.spmm(a_sp, support)
    return out + b


def test_single_layer_allclose_vs_torch_spmm():
    g, a_t, x, params = _setup()
    w = torch.from_numpy(np.asarray(params["gc1"]["w"]))
    b = torch.from_numpy(np.asarray(params["gc1"]["b"]))
    want = _torch_layer(a_t, torch.from_numpy(x), w, b).numpy()
    got = np.asarray(graph_conv(params["gc1"], g, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_two_layer_forward_allclose_vs_torch():
    g, a_t, x, params = _setup(seed=3)
    x_t = torch.from_numpy(x)
    w1 = torch.from_numpy(np.asarray(params["gc1"]["w"]))
    b1 = torch.from_numpy(np.asarray(params["gc1"]["b"]))
    w2 = torch.from_numpy(np.asarray(params["gc2"]["w"]))
    b2 = torch.from_numpy(np.asarray(params["gc2"]["b"]))
    h1 = torch.relu(_torch_layer(a_t, x_t, w1, b1))
    want = _torch_layer(a_t, h1, w2, b2).numpy()  # eval mode: no dropout
    got = np.asarray(gcn_forward(params, g, jnp.asarray(x), train=False))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_training_gradient_allclose_vs_torch():
    """One masked-CE gradient step matches torch autograd through spmm."""
    import optax

    g, a_t, x, params = _setup(n=40, nnz=160, f=10, h=8, c=3, seed=5)
    y = np.random.RandomState(7).randint(0, 3, 40)
    train_idx = np.arange(0, 30)

    # torch side
    x_t = torch.from_numpy(x)
    w1 = torch.from_numpy(np.asarray(params["gc1"]["w"])).requires_grad_()
    b1 = torch.from_numpy(np.asarray(params["gc1"]["b"])).requires_grad_()
    w2 = torch.from_numpy(np.asarray(params["gc2"]["w"])).requires_grad_()
    b2 = torch.from_numpy(np.asarray(params["gc2"]["b"])).requires_grad_()
    h1 = torch.relu(_torch_layer(a_t, x_t, w1, b1))
    logits = _torch_layer(a_t, h1, w2, b2)
    loss = torch.nn.functional.cross_entropy(
        logits[torch.from_numpy(train_idx)], torch.from_numpy(y[train_idx])
    )
    loss.backward()

    # jax side
    def loss_fn(p):
        lg = gcn_forward(p, g, jnp.asarray(x), train=False)
        sel = lg[jnp.asarray(train_idx)]
        return jnp.mean(
            optax.softmax_cross_entropy_with_integer_labels(
                sel, jnp.asarray(y[train_idx])
            )
        )

    jloss, grads = jax.value_and_grad(loss_fn)(params)
    np.testing.assert_allclose(float(jloss), float(loss), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(grads["gc1"]["w"]), w1.grad.numpy(), rtol=1e-4, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(grads["gc2"]["b"]), b2.grad.numpy(), rtol=1e-4, atol=1e-6
    )
