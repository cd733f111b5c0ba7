"""Simple Graph Convolution (SGC) — the linear GCN family member.

SGC (Wu et al. 2019, "Simplifying Graph Convolutional Networks") drops the
nonlinearities of a K-layer GCN, collapsing it to a single linear classifier
over K-step-propagated features::

    logits = Â^K X W + b

This is the cheapest member of the family: training touches no
gather/scatter at all once propagation is hoisted, and even the recomputing
form below propagates the *projected* [N, C] activations (C = #classes)
instead of the [N, F] features — Â^K (X W) = (Â^K X) W,
so we project first and propagate the small thing.

Two usage modes:

- **registry forward** (:func:`sgc_forward`): plugs into the trainer's model
  registry with the uniform ``forward(params, graph, x, ...)`` signature.
  Propagation runs inside the jitted step through whatever SpMM format the
  graph carries (segment or dense — both differentiable).
- **precompute** (:func:`sgc_precompute`): hoist Â^K X out of training
  entirely — after it, training is a pure dense logistic regression with no
  graph in the step at all. At BASELINE's 10M-node/500M-edge scale the
  propagation composes with :func:`textgcn.ops.spmm.spmm_streamed`
  (the edge list never materializes in HBM).

The reference has no SGC (its only model is the 2-layer GCN, reference
layer.py:143-190); this is a new capability of the framework. SGC has no
dropout and no hidden layer — ``sgc_init`` ignores ``n_hidden`` and
``sgc_forward`` ignores the dropout arguments (kept for registry signature
uniformity).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp

from textgcn.models.gcn import _init_layer
from textgcn.ops.spmm import spmm

Params = Dict[str, Any]

# propagation depth; 2 matches the receptive field of the reference's
# 2-layer GCN so accuracy comparisons are like-for-like
DEFAULT_K = 2


def sgc_init(
    key: jax.Array,
    n_feat: int,
    n_hidden: int,  # unused: SGC is a single linear map (kept for registry)
    n_class: int,
) -> Params:
    del n_hidden
    return {"lin": _init_layer(key, n_feat, n_class)}


def sgc_forward(
    params: Params,
    graph,
    x: Optional[jnp.ndarray],
    *,
    dropout: float = 0.0,  # unused: SGC has no dropout (registry signature)
    train: bool = False,
    rng: Optional[jax.Array] = None,
    k: int = DEFAULT_K,
) -> jnp.ndarray:
    """Logits for all nodes: Â^k (X W) + b.

    ``x=None`` selects identity features (classic TextGCN doc-word graphs):
    X = I_N makes W itself the [n_nodes, n_class] node table and the model
    becomes Â^k W + b — I_N is never materialized.
    """
    del dropout, train, rng
    h = (
        params["lin"]["w"]
        if x is None
        else jnp.dot(
            x, params["lin"]["w"], preferred_element_type=jnp.float32
        )
    )
    for _ in range(k):
        h = spmm(graph, h)
    return h + params["lin"]["b"]


def sgc_precompute(graph, x: jnp.ndarray, k: int = DEFAULT_K) -> jnp.ndarray:
    """Hoist propagation out of training: returns Â^k X.

    Train a plain dense classifier on the result (e.g. ``sgc_forward`` with
    ``k=0`` — :data:`textgcn.models.MODELS` entry ``"sgc_pre"``); the
    training loop then contains no sparse op at all.
    """
    h = jnp.asarray(x, dtype=jnp.float32)
    for _ in range(k):
        h = spmm(graph, h)
    return h


def sgc_pre_forward(
    params: Params,
    graph,
    x: Optional[jnp.ndarray],
    *,
    dropout: float = 0.0,
    train: bool = False,
    rng: Optional[jax.Array] = None,
) -> jnp.ndarray:
    """Registry forward for *precomputed* features: a pure linear layer.

    Use with features already propagated via :func:`sgc_precompute`; the
    graph argument is ignored, so the compiled train step is gather-free.
    """
    del graph
    if x is None:
        raise ValueError(
            "sgc_pre needs precomputed dense features (sgc_precompute); "
            "identity features carry no propagation"
        )
    return sgc_forward(params, None, x, k=0)
