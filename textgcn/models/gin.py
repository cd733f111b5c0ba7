"""GIN (Graph Isomorphism Network), full-batch.

Xu et al. 2019's maximally-expressive aggregator as a seventh model family
beyond the reference's single GCN (reference layer.py:143-190). Per layer::

    h' = MLP( (1 + eps) * h  +  Â h )

with ``eps`` a learnable scalar per layer. Layer 1 uses the paper's 2-layer
MLP (Linear → ReLU → Linear); layer 2 maps straight to class logits with a
single linear — the usual node-classification head.

Two deliberate adaptations to this framework, both documented rather than
silent: (1) the aggregation runs over the framework's **sym-normalized** Â
(GIN's theory uses the raw adjacency's sum aggregator; every fast kernel's
transpose-free VJP requires the symmetric normalized operator — the same
transductive simplification as models/sage.py); (2) ``eps`` is initialized
to 0, so at init the layer is plain sum-of-self-and-neighbors.

Notes: the only sparse op per layer is the same single SpMM as GCN
(dispatched through :func:`textgcn.ops.spmm.spmm`, so every resident
format works); everything else is dense matmuls. Because (1+eps)·h + Âh must be formed **before** the MLP, the
SpMM runs at the input width — for identity features (``x=None``, classic
doc-word graphs) the layer instead aggregates the node table directly:
``(1+eps) W[v] + (Â W)[v]`` where ``W`` is the [n_nodes, H] first MLP
weight, I_N never materialized (same embedding-table move as models/gcn.py).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp

from textgcn.models.gcn import _init_layer
from textgcn.ops.spmm import spmm

Params = Dict[str, Any]


def gin_init(
    key: jax.Array,
    n_feat: int,
    n_hidden: int,
    n_class: int,
) -> Params:
    k1, k2, k3 = jax.random.split(key, 3)
    mlp1a = _init_layer(k1, n_feat, n_hidden)
    mlp1b = _init_layer(k2, n_hidden, n_hidden)
    head = _init_layer(k3, n_hidden, n_class)
    return {
        "gin1": {
            "eps": jnp.zeros((), jnp.float32),
            "w1": mlp1a["w"],
            "b1": mlp1a["b"],
            "w2": mlp1b["w"],
            "b2": mlp1b["b"],
        },
        "gin2": {
            "eps": jnp.zeros((), jnp.float32),
            "w": head["w"],
            "b": head["b"],
        },
    }


def _aggregate(p: Params, graph, x: Optional[jnp.ndarray], w: jnp.ndarray):
    """(1+eps)·x + Âx, then @w — or the identity-feature table form."""
    if x is None:
        # x = I_N: ((1+eps) I + Â) W == (1+eps) W + Â W, row-indexed tables
        return (1.0 + p["eps"]) * w + spmm(graph, w)
    agg = (1.0 + p["eps"]) * x + spmm(graph, x)
    return jnp.dot(agg, w, preferred_element_type=jnp.float32)


def gin_forward(
    params: Params,
    graph,
    x: Optional[jnp.ndarray],
    *,
    dropout: float = 0.5,
    train: bool = False,
    rng: Optional[jax.Array] = None,
) -> jnp.ndarray:
    """Logits for all nodes: gin2(dropout(MLP-layer(x)))."""
    p1 = params["gin1"]
    h = jax.nn.relu(_aggregate(p1, graph, x, p1["w1"]) + p1["b1"])
    h = jnp.dot(h, p1["w2"], preferred_element_type=jnp.float32) + p1["b2"]
    h = jax.nn.relu(h)
    if train and dropout > 0.0:
        keep = 1.0 - dropout
        mask = jax.random.bernoulli(rng, keep, h.shape)
        h = jnp.where(mask, h / keep, 0.0)
    p2 = params["gin2"]
    return _aggregate(p2, graph, h, p2["w"]) + p2["b"]
