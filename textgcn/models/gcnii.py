"""GCNII — deep GCN with initial residual and identity mapping.

Chen et al. 2020 ("Simple and Deep Graph Convolutional Networks"): plain
GCNs over-smooth past 2 layers; GCNII goes deep by anchoring every layer
to the initial representation and shrinking each layer's transform::

    h_0   = relu(X W_in + b_in)
    s_l   = (1 - alpha) Â h_{l-1}  +  alpha h_0          (initial residual)
    h_l   = relu( (1 - beta_l) s_l + beta_l (s_l W_l) )  (identity mapping)
    logits = h_K W_out + b_out,     beta_l = log(lambda/l + 1)

An eighth model family beyond the reference's single 2-layer GCN
(reference layer.py:143-190). Shape: the K deep layers run under ONE
``lax.scan`` over stacked [K, H, H] weights and a static beta vector —
static trip count, a single fused XLA loop, one SpMM per layer dispatched
through :func:`textgcn.ops.spmm.spmm` (so every
resident format works, all differentiable).
Per-layer beta decays as log(lambda/l + 1), so late layers are close to
identity maps — gradients reach layer 1 even at large K.

``x=None`` selects identity features (classic TextGCN doc-word graphs):
W_in becomes the [n_nodes, H] node table and h_0 = relu(W_in + b_in) —
I_N is never materialized, as in :func:`textgcn.models.gcn.gcn_forward`.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp

from textgcn.models.gcn import _init_layer
from textgcn.ops.spmm import spmm

Params = Dict[str, Any]

DEFAULT_ALPHA = 0.1
DEFAULT_LAMBDA = 0.5
DEFAULT_K = 8


def gcnii_betas(k: int = DEFAULT_K, lam: float = DEFAULT_LAMBDA):
    """Static per-layer identity-mapping strengths beta_l = log(lam/l + 1)."""
    l = jnp.arange(1, k + 1, dtype=jnp.float32)
    return jnp.log(lam / l + 1.0)


def gcnii_init(
    key: jax.Array,
    n_feat: int,
    n_hidden: int,
    n_class: int,
    k: int = DEFAULT_K,
) -> Params:
    k_in, k_deep, k_out = jax.random.split(key, 3)
    # deep weights: K stacked [H, H] maps with the same ±1/sqrt(out)
    # uniform init as every other layer in the framework
    bound = 1.0 / jnp.sqrt(jnp.asarray(n_hidden, jnp.float32))
    deep_w = jax.random.uniform(
        k_deep, (k, n_hidden, n_hidden), jnp.float32, -bound, bound
    )
    return {
        "fc_in": _init_layer(k_in, n_feat, n_hidden),
        "deep": {"w": deep_w},
        "fc_out": _init_layer(k_out, n_hidden, n_class),
    }


def gcnii_core(
    params: Params,
    aggregate,
    x: Optional[jnp.ndarray],
    *,
    dropout: float = 0.5,
    train: bool = False,
    rng: Optional[jax.Array] = None,
    alpha: float = DEFAULT_ALPHA,
    lam: float = DEFAULT_LAMBDA,
) -> jnp.ndarray:
    """The GCNII recurrence over any aggregation operator.

    ``aggregate(h) -> Â h`` abstracts the single sparse op per layer:
    the single-device forward passes ``spmm(graph, ·)``; the mesh
    forward (:func:`textgcn.parallel.sharded.sharded_gcnii_forward`)
    passes its shard-local SpMM closure — ONE recurrence definition for
    both paths.
    """
    h0 = (
        params["fc_in"]["w"]
        if x is None
        else jnp.dot(
            x, params["fc_in"]["w"], preferred_element_type=jnp.float32
        )
    )
    h0 = jax.nn.relu(h0 + params["fc_in"]["b"])
    k = params["deep"]["w"].shape[0]
    betas = gcnii_betas(k, lam)

    def layer(h, wb):
        w, beta = wb
        s = (1.0 - alpha) * aggregate(h) + alpha * h0
        sw = jnp.dot(s, w, preferred_element_type=jnp.float32)
        return jax.nn.relu((1.0 - beta) * s + beta * sw), None

    h, _ = jax.lax.scan(layer, h0, (params["deep"]["w"], betas))
    if train and dropout > 0.0:
        keep = 1.0 - dropout
        mask = jax.random.bernoulli(rng, keep, h.shape)
        h = jnp.where(mask, h / keep, 0.0)
    return (
        jnp.dot(h, params["fc_out"]["w"], preferred_element_type=jnp.float32)
        + params["fc_out"]["b"]
    )


def gcnii_forward(
    params: Params,
    graph,
    x: Optional[jnp.ndarray],
    *,
    dropout: float = 0.5,
    train: bool = False,
    rng: Optional[jax.Array] = None,
    alpha: float = DEFAULT_ALPHA,
    lam: float = DEFAULT_LAMBDA,
) -> jnp.ndarray:
    """Logits for all nodes through K initial-residual layers."""
    return gcnii_core(
        params,
        lambda h: spmm(graph, h),
        x,
        dropout=dropout,
        train=train,
        rng=rng,
        alpha=alpha,
        lam=lam,
    )
