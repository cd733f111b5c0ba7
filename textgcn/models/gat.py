"""Two-layer Graph Attention Network (GAT).

A second model family beyond the reference's fixed-Â GCN (the reference has
exactly one model, reference layer.py:143-190). Attention is built from the
framework's own sparse primitives — no new kernels:

- per-edge logits  ``e = LeakyReLU(a_src·h_row + a_dst·h_col) + log(val)``:
  two dense [N, H] @ [H] projections plus two masked-fill gathers. Folding
  the (sym-normalized) adjacency weight in as ``log(val)`` makes the
  attention a *weighted* softmax — and padding edges, whose ``val`` is 0,
  get ``-inf`` logits and vanish from the softmax with no explicit mask;
- row-wise segment softmax over incoming edges (``segment_max`` /
  ``segment_sum`` on the row-sorted COO);
- aggregation through :func:`textgcn.ops.spmm.spmm_coo_segment_ew`,
  the edge-differentiable SpMM whose val-VJP is an SDDMM pass — exactly
  the machinery attention training needs.

``x=None`` selects identity features (doc-word graphs): layer 1's ``h`` is
the weight table itself, as in :func:`textgcn.models.gcn.gcn_forward`.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp

from textgcn.graph.structs import SparseGraph
from textgcn.models.gcn import _init_layer
from textgcn.ops.spmm import spmm_coo_segment_ew

Params = Dict[str, Any]

_NEG = -1e30  # finite -inf stand-in (NaN-free max/exp arithmetic)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["loga"],
    meta_fields=["n_nodes"],
)
@dataclasses.dataclass(frozen=True)
class DenseAttentionGraph:
    """Dense log-adjacency for small-graph attention — the GAT analogue of
    :class:`textgcn.graph.structs.DenseGraph`.

    Every per-edge quantity of a GAT layer (logit, softmax weight) is a
    function of (row, col) only, so on graphs whose [N, N] table fits the
    device's dense budget the whole sparse side collapses into dense
    elementwise ops + one matmul — zero gathers and no scatter, all
    [N, N] traffic sequential.

    ``loga`` stores ``log(val)`` once, in bf16 ([N, N] = 472 MB on R8
    docword): the log never recomputes per pass, reads at half the f32
    traffic, and off-pattern entries hold a finite ``-1e30`` whose softmax
    weight underflows to exactly 0 — the dense image of the segment path's
    ``log(val=0) = -inf`` masking (padding edges carry val 0 there too).
    bf16's ~3-digit mantissa perturbs real logits by ~0.4%.

    Built ON DEVICE by scatter from the resident COO, so only the O(E)
    edge list crosses the host link; requires the coalesced edges every
    normalized Â has (``.set`` not ``.add``: log does not sum over
    duplicates).
    """

    loga: jnp.ndarray  # [n, n] bfloat16, log edge value; -1e30 off-pattern
    n_nodes: int

    @staticmethod
    def from_sparse_graph(g: "SparseGraph") -> "DenseAttentionGraph":
        n = int(g.n_nodes)

        @jax.jit
        def densify(row, col, val):
            # padded entries (row == col == n, val == 0) land in the
            # phantom rim and are sliced off; log(0) = -inf is clamped to
            # the finite sentinel
            d = jnp.full((n + 1, n + 1), _NEG, dtype=jnp.float32)
            lv = jnp.maximum(jnp.log(val.astype(jnp.float32)), _NEG)
            d = d.at[row, col].set(lv)
            return d[:n, :n].astype(jnp.bfloat16)

        return DenseAttentionGraph(
            loga=densify(g.row, g.col, g.val), n_nodes=n
        )


def segment_softmax(
    logits: jnp.ndarray,
    row: jnp.ndarray,
    n_nodes: int,
) -> jnp.ndarray:
    """Softmax of per-edge ``logits`` over edges sharing a row.

    ``row`` may contain the phantom id ``n_nodes`` (padding); those edges
    form their own segment and never touch real rows. Max-subtraction for
    stability; all-(-inf) segments (isolated rows / padding with -inf
    logits) produce 0, not NaN.
    """
    mx = jax.ops.segment_max(
        logits, row, num_segments=n_nodes + 1, indices_are_sorted=True
    )
    # rows with no edges have -inf max; keep the subtraction finite
    shifted = logits - jnp.where(jnp.isfinite(mx), mx, 0.0)[row]
    expd = jnp.where(jnp.isfinite(logits), jnp.exp(shifted), 0.0)
    denom = jax.ops.segment_sum(
        expd, row, num_segments=n_nodes + 1, indices_are_sorted=True
    )
    return expd / jnp.maximum(denom[row], 1e-30)


def _gat_layer_params(key, n_in, n_out):
    k1, k2, k3 = jax.random.split(key, 3)
    p = _init_layer(k1, n_in, n_out)  # w + b, reference ±1/√out init
    s = 1.0 / jnp.sqrt(jnp.asarray(n_out, dtype=jnp.float32))
    p["a_src"] = jax.random.uniform(k2, (n_out,), jnp.float32, -s, s)
    p["a_dst"] = jax.random.uniform(k3, (n_out,), jnp.float32, -s, s)
    return p


def gat_init(
    key: jax.Array,
    n_feat: int,
    n_hidden: int,
    n_class: int,
) -> Params:
    k1, k2 = jax.random.split(key)
    return {
        "gat1": _gat_layer_params(k1, n_feat, n_hidden),
        "gat2": _gat_layer_params(k2, n_hidden, n_class),
    }


def gat_layer(
    p: Params,
    graph: SparseGraph,
    x: Optional[jnp.ndarray],
    *,
    negative_slope: float = 0.2,
) -> jnp.ndarray:
    """One attention layer: softmax-weighted neighborhood aggregation."""
    h = (
        p["w"]
        if x is None
        else jnp.dot(x, p["w"], preferred_element_type=jnp.float32)
    )
    es = jnp.dot(h, p["a_src"], preferred_element_type=jnp.float32)
    ed = jnp.dot(h, p["a_dst"], preferred_element_type=jnp.float32)
    gs = jnp.take(es, graph.row, mode="fill", fill_value=0.0)
    gd = jnp.take(ed, graph.col, mode="fill", fill_value=0.0)
    e = jax.nn.leaky_relu(gs + gd, negative_slope)
    # weighted softmax: padding edges have val == 0 → log → -inf → weight 0
    e = e + jnp.log(graph.val)
    att = segment_softmax(e, graph.row, graph.n_nodes)
    out = spmm_coo_segment_ew(
        graph.row, graph.col, att, h, graph.n_nodes, True
    )
    return out + p["b"]


def gat_layer_dense(
    p: Params,
    dg: DenseAttentionGraph,
    x: Optional[jnp.ndarray],
    *,
    negative_slope: float = 0.2,
) -> jnp.ndarray:
    """One attention layer on the DENSE path (small graphs, zero gathers).

    The per-edge logit ``leaky(es[r] + ed[c]) + log(val[r,c])`` is a rank-1
    broadcast plus the resident log-adjacency; the row softmax is two
    fused elementwise sweeps; aggregation is one bf16 matmul. All
    [N, N] traffic is sequential, like the dense GCN format. Same
    math as :func:`gat_layer` (off-pattern/padding entries carry the
    finite ``-1e30`` image of ``log(0)`` and drop out of the softmax)."""
    h = (
        p["w"]
        if x is None
        else jnp.dot(x, p["w"], preferred_element_type=jnp.float32)
    )
    es = jnp.dot(h, p["a_src"], preferred_element_type=jnp.float32)
    ed = jnp.dot(h, p["a_dst"], preferred_element_type=jnp.float32)
    base = jax.nn.leaky_relu(es[:, None] + ed[None, :], negative_slope)
    logit = base + dg.loga.astype(jnp.float32)
    m = jnp.max(logit, axis=1, keepdims=True)
    shift = jnp.where(m > _NEG / 2, m, 0.0)
    e = jnp.where(logit > _NEG / 2, jnp.exp(logit - shift), 0.0)
    s = jnp.sum(e, axis=1, keepdims=True)
    att = (e / jnp.maximum(s, 1e-30)).astype(jnp.bfloat16)
    out = jnp.dot(
        att, h.astype(jnp.bfloat16), preferred_element_type=jnp.float32
    )
    return out + p["b"]


def gat_forward(
    params: Params,
    graph: SparseGraph,
    x: Optional[jnp.ndarray],
    *,
    dropout: float = 0.5,
    train: bool = False,
    rng: Optional[jax.Array] = None,
) -> jnp.ndarray:
    """Logits for all nodes: gat2(dropout(relu(gat1(x))))."""
    if isinstance(graph, DenseAttentionGraph):
        layer = gat_layer_dense
    elif isinstance(graph, SparseGraph):
        layer = gat_layer
    else:
        raise TypeError(
            "GAT needs the row-sorted COO SparseGraph (segment path) or a "
            "DenseAttentionGraph (dense small-graph path); got "
            f"{type(graph).__name__}"
        )
    h = layer(params["gat1"], graph, x)
    h = jax.nn.relu(h)
    if train and dropout > 0.0:
        keep = 1.0 - dropout
        mask = jax.random.bernoulli(rng, keep, h.shape)
        h = jnp.where(mask, h / keep, 0.0)
    return layer(params["gat2"], graph, h)
