"""GraphSAGE (mean aggregator), full-batch.

Hamilton et al. 2017's inductive aggregator as a sixth model family beyond
the reference's single GCN (reference layer.py:143-190). The full-batch,
sampling-free form used here::

    h' = ReLU( x W_self  +  (Â x) W_neigh  + b )

i.e. each layer keeps a SELF transform separate from the NEIGHBOR
aggregation — unlike GCN, a node's own features are not diluted by its
degree. The aggregation runs through :func:`textgcn.ops.spmm.spmm`,
so every resident format (segment / dense) works,
and training on the framework's sym-normalized Â keeps the aggregation a
weighted mean up to the symmetric normalization (the standard transductive
simplification; the VJP of every fast kernel requires symmetric Â).

Notes: both transforms are dense matmuls over [N, F]-shaped
activations; the only sparse op per layer is the same single SpMM as GCN,
so SAGE costs one extra [N, F] @ [F, H] matmul per layer — noise next to
the aggregation.

``x=None`` (identity features, classic TextGCN doc-word graphs): the self
leg's W_self is the [n_nodes, H] node table and the neighbor leg becomes
``Â @ W_neigh`` with its own table — both row-indexed, I_N never
materialized (same embedding-table move as models/gcn.py).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp

from textgcn.models.gcn import _init_layer
from textgcn.ops.spmm import spmm

Params = Dict[str, Any]


def sage_init(
    key: jax.Array,
    n_feat: int,
    n_hidden: int,
    n_class: int,
) -> Params:
    k1, k2, k3, k4 = jax.random.split(key, 4)
    l1s = _init_layer(k1, n_feat, n_hidden)
    l1n = _init_layer(k2, n_feat, n_hidden)
    l2s = _init_layer(k3, n_hidden, n_class)
    l2n = _init_layer(k4, n_hidden, n_class)
    return {
        "sage1": {"w_self": l1s["w"], "w_neigh": l1n["w"], "b": l1s["b"]},
        "sage2": {"w_self": l2s["w"], "w_neigh": l2n["w"], "b": l2s["b"]},
    }


def _sage_layer(p: Params, graph, x: Optional[jnp.ndarray]) -> jnp.ndarray:
    if x is None:
        # identity features: both legs are node tables
        self_part = p["w_self"]
        neigh_part = spmm(graph, p["w_neigh"])
    else:
        self_part = jnp.dot(
            x, p["w_self"], preferred_element_type=jnp.float32
        )
        # project-then-aggregate: Â (x W) == (Â x) W, and the SpMM runs at
        # the (usually narrower) output width (same move as models/gcn.py)
        neigh_part = spmm(
            graph,
            jnp.dot(x, p["w_neigh"], preferred_element_type=jnp.float32),
        )
    return self_part + neigh_part + p["b"]


def sage_forward(
    params: Params,
    graph,
    x: Optional[jnp.ndarray],
    *,
    dropout: float = 0.5,
    train: bool = False,
    rng: Optional[jax.Array] = None,
) -> jnp.ndarray:
    """Logits for all nodes: sage2(dropout(relu(sage1(x))))."""
    h = jax.nn.relu(_sage_layer(params["sage1"], graph, x))
    if train and dropout > 0.0:
        keep = 1.0 - dropout
        mask = jax.random.bernoulli(rng, keep, h.shape)
        h = jnp.where(mask, h / keep, 0.0)
    return _sage_layer(params["sage2"], graph, h)
