"""APPNP — predict-then-propagate with personalized PageRank.

APPNP (Gasteiger/Klicpera et al. 2019, "Predict then Propagate") separates
prediction from propagation: a small MLP produces per-node logits H, then a
truncated personalized-PageRank power iteration smooths them over the graph::

    Z_0 = H;   Z_{t+1} = (1 - α) Â Z_t + α H;   logits = Z_K

The teleport term α keeps each node anchored to its own prediction, so K can
be large (deep receptive field) without over-smoothing — the failure mode
that caps plain GCNs at 2 layers. Shape: the iteration runs over the
already-projected [N, C] logits (C = #classes), so K steps of
propagation cost K cheap SpMMs inside one ``lax.scan`` — static trip count,
a single fused XLA loop, differentiable through every SpMM format's VJP.

The reference has no APPNP (its only model is the 2-layer GCN, reference
layer.py:143-190); this is a new capability of the framework. Feature
dropout matches the reference's placement (between the MLP layers); the
paper's additional adjacency-dropout is intentionally omitted — Â here is a
weighted normalized adjacency whose entries carry meaning (TF-IDF / PMI /
θ), not a binary citation mask.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp

from textgcn.models.gcn import _init_layer
from textgcn.ops.spmm import spmm

Params = Dict[str, Any]

DEFAULT_ALPHA = 0.1
DEFAULT_K = 10


def appnp_init(
    key: jax.Array,
    n_feat: int,
    n_hidden: int,
    n_class: int,
) -> Params:
    k1, k2 = jax.random.split(key)
    return {
        "fc1": _init_layer(k1, n_feat, n_hidden),
        "fc2": _init_layer(k2, n_hidden, n_class),
    }


def appnp_forward(
    params: Params,
    graph,
    x: Optional[jnp.ndarray],
    *,
    dropout: float = 0.5,
    train: bool = False,
    rng: Optional[jax.Array] = None,
    alpha: float = DEFAULT_ALPHA,
    k: int = DEFAULT_K,
) -> jnp.ndarray:
    """Logits for all nodes: PPR-propagated MLP predictions.

    ``x=None`` selects identity features (doc-word graphs): X = I_N makes
    fc1's weight the [n_nodes, n_hidden] node table — I_N is never
    materialized, as in :func:`textgcn.models.gcn.gcn_forward`.
    """
    h = (
        params["fc1"]["w"]
        if x is None
        else jnp.dot(
            x, params["fc1"]["w"], preferred_element_type=jnp.float32
        )
    )
    h = jax.nn.relu(h + params["fc1"]["b"])
    if train and dropout > 0.0:
        keep = 1.0 - dropout
        mask = jax.random.bernoulli(rng, keep, h.shape)
        h = jnp.where(mask, h / keep, 0.0)
    h = (
        jnp.dot(h, params["fc2"]["w"], preferred_element_type=jnp.float32)
        + params["fc2"]["b"]
    )

    def step(z, _):
        return (1.0 - alpha) * spmm(graph, z) + alpha * h, None

    z, _ = jax.lax.scan(step, h, None, length=k)
    return z
