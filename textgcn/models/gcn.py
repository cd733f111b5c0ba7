"""Two-layer Kipf–Welling GCN as a pure-functional JAX model.

Mirrors the reference model semantics (reference layer.py:25-190):
``H' = Â (H W) + b``; two layers with ReLU + dropout between; logits for all
nodes. Differences by design:

- Parameters are a plain pytree (dict), not a module object; the forward is a
  pure function usable under ``jit`` / ``grad`` / ``shard_map``.
- Features are treated as **dense** [N, F]: the reference pushes sparse
  features through ``spmm`` (reference layer.py:102), but F = max(K, emb_dim)
  is ~50-100, so a dense N×F matmul is one small GEMM.
- Dropout uses explicit PRNG keys (inverted scaling, matching
  ``torch.dropout``'s train-time 1/(1-p) scaling, reference layer.py:185).
- Weight init matches the reference: U(-s, s) with s = 1/sqrt(fan_out) for
  both W and b (reference layer.py:67-82).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import jax
import jax.numpy as jnp

from textgcn.ops.spmm import spmm

Params = Dict[str, Any]


def _init_layer(key: jax.Array, n_in: int, n_out: int, dtype=jnp.float32) -> Params:
    kw, kb = jax.random.split(key)
    s = 1.0 / jnp.sqrt(jnp.asarray(n_out, dtype=jnp.float32))
    return {
        "w": jax.random.uniform(kw, (n_in, n_out), dtype, -s, s),
        "b": jax.random.uniform(kb, (n_out,), dtype, -s, s),
    }


def graph_conv(params: Params, graph, x: jnp.ndarray) -> jnp.ndarray:
    """One graph convolution: Â (x W) + b."""
    support = jnp.dot(x, params["w"], preferred_element_type=jnp.float32)
    out = spmm(graph, support)
    return out + params["b"]


def gcn_init(
    key: jax.Array,
    n_feat: int,
    n_hidden: int,
    n_class: int,
    dtype=jnp.float32,
) -> Params:
    k1, k2 = jax.random.split(key)
    return {
        "gc1": _init_layer(k1, n_feat, n_hidden, dtype),
        "gc2": _init_layer(k2, n_hidden, n_class, dtype),
    }


def gcn_forward(
    params: Params,
    graph,
    x: Optional[jnp.ndarray],
    *,
    dropout: float = 0.5,
    train: bool = False,
    rng: Optional[jax.Array] = None,
) -> jnp.ndarray:
    """Logits for all nodes: gc2(dropout(relu(gc1(x)))).

    ``x=None`` selects **identity features** (classic TextGCN: X = I_N), in
    which case layer 1 reduces to ``Â @ W1 + b1`` with W1 of shape
    [n_nodes, n_hidden] — the N×N identity is never materialized (an
    embedding-table view of the same math).
    """
    if x is None:
        h = spmm(graph, params["gc1"]["w"]) + params["gc1"]["b"]
    else:
        h = graph_conv(params["gc1"], graph, x)
    h = jax.nn.relu(h)
    if train and dropout > 0.0:
        keep = 1.0 - dropout
        mask = jax.random.bernoulli(rng, keep, h.shape)
        h = jnp.where(mask, h / keep, 0.0)
    return graph_conv(params["gc2"], graph, h)


def gcn_edge_init(
    key: jax.Array,
    graph,
    n_feat: int,
    n_hidden: int,
    n_class: int,
) -> Params:
    """:func:`gcn_init` plus a learnable per-edge log-scale (init 0 ⇒
    scale 1 ⇒ exactly the fixed-Â model at initialization)."""
    params = gcn_init(key, n_feat, n_hidden, n_class)
    params["edge_logit"] = jnp.zeros(graph.row.shape, dtype=jnp.float32)
    return params


def gcn_edge_forward(
    params: Params,
    graph,
    x: Optional[jnp.ndarray],
    *,
    dropout: float = 0.5,
    train: bool = False,
    rng: Optional[jax.Array] = None,
) -> jnp.ndarray:
    """Two-layer GCN with **learnable edge weights**: Â's entries are scaled
    by ``exp(edge_logit_e)`` (positive, identity at init) and trained jointly
    with the layer weights through the edge-differentiable SpMM
    (:func:`textgcn.ops.spmm.spmm_coo_segment_ew`, whose val-VJP is an
    SDDMM pass). A capability the reference cannot express — its
    ``torch.spmm`` adjacency is a frozen buffer (reference layer.py:102,106).

    Requires a COO :class:`SparseGraph` (the segment kernel); other formats
    hold their values in tiled layouts where per-edge scaling loses meaning.
    """
    from textgcn.graph.structs import SparseGraph
    from textgcn.ops.spmm import spmm_coo_segment_ew

    if not isinstance(graph, SparseGraph):
        raise TypeError(
            "learnable edge weights need a SparseGraph (COO segment path); "
            f"got {type(graph).__name__}"
        )
    val = graph.val * jnp.exp(params["edge_logit"])

    def agg(support):
        # SparseGraph.from_coo sorts by (row, col), so rows are sorted
        return spmm_coo_segment_ew(
            graph.row, graph.col, val, support, graph.n_nodes, True
        )

    if x is None:
        h = agg(params["gc1"]["w"]) + params["gc1"]["b"]
    else:
        support = jnp.dot(
            x, params["gc1"]["w"], preferred_element_type=jnp.float32
        )
        h = agg(support) + params["gc1"]["b"]
    h = jax.nn.relu(h)
    if train and dropout > 0.0:
        keep = 1.0 - dropout
        mask = jax.random.bernoulli(rng, keep, h.shape)
        h = jnp.where(mask, h / keep, 0.0)
    support2 = jnp.dot(
        h, params["gc2"]["w"], preferred_element_type=jnp.float32
    )
    return agg(support2) + params["gc2"]["b"]


@dataclasses.dataclass
class GCN:
    """Convenience wrapper bundling hyperparameters with init/apply.

    Capability parity with the reference's ``GCN`` class
    (reference layer.py:143-190), as a thin facade over the functional API.
    """

    n_feat: int
    n_hidden: int
    n_class: int
    dropout: float = 0.5

    def init(self, key: jax.Array) -> Params:
        return gcn_init(key, self.n_feat, self.n_hidden, self.n_class)

    def apply(
        self,
        params: Params,
        graph,
        x: jnp.ndarray,
        train: bool = False,
        rng: Optional[jax.Array] = None,
    ) -> jnp.ndarray:
        return gcn_forward(
            params, graph, x, dropout=self.dropout, train=train, rng=rng
        )

    def param_count(self, params: Params) -> int:
        return sum(p.size for p in jax.tree_util.tree_leaves(params))
