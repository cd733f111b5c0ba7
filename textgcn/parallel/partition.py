"""Host-side 1-D row partitioning of a sparse graph for multi-chip SpMM.

The reference has **no** distributed code (SURVEY.md §2: zero parallelism
strategies); this subsystem is new design:

- nodes are padded to ``shards × rows_per_shard`` and split into contiguous
  row blocks, one per device;
- each shard keeps its outgoing rows' edges with **local row ids** and
  **global col ids**, padded to the max per-shard edge count (static shape);
- padding edges point at the phantom local row ``rows_per_shard`` and the
  phantom global col ``n_pad`` with value 0.

The device-side consumer is :func:`textgcn.parallel.sharded.spmm_sharded`
(all-gather of features + local segment-sum); the edge-bucketed halo
exchange of :mod:`textgcn.parallel.halo` serves graphs whose features do
not fit a gather.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from textgcn.graph.structs import SparseGraph


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["row", "col", "val"],
    meta_fields=["n_nodes", "n_pad", "rows_per_shard", "n_shards"],
)
@dataclasses.dataclass(frozen=True)
class PartitionedGraph:
    """Row-partitioned COO graph.

    row: [P, E_pad] int32 — local row ids (phantom = rows_per_shard).
    col: [P, E_pad] int32 — global col ids (phantom = n_pad).
    val: [P, E_pad] float.
    """

    row: jnp.ndarray
    col: jnp.ndarray
    val: jnp.ndarray
    n_nodes: int
    n_pad: int
    rows_per_shard: int
    n_shards: int


def partition_rows(
    g: SparseGraph, n_shards: int, pad_edges_to_multiple: int = 256
) -> PartitionedGraph:
    """Split a SparseGraph into contiguous row blocks for ``n_shards``."""
    e = g.n_edges
    row = np.asarray(g.row)[:e].astype(np.int64)
    col = np.asarray(g.col)[:e].astype(np.int64)
    val = np.asarray(g.val)[:e]

    rows_per_shard = _round_up(
        max(1, -(-g.n_nodes // n_shards)), 8
    )  # local row blocks a multiple of 8 rows
    n_pad = rows_per_shard * n_shards

    shard_of_edge = row // rows_per_shard
    counts = np.bincount(shard_of_edge, minlength=n_shards)
    e_pad = _round_up(max(int(counts.max()), 1), pad_edges_to_multiple)

    prow = np.full((n_shards, e_pad), rows_per_shard, dtype=np.int32)
    pcol = np.full((n_shards, e_pad), n_pad, dtype=np.int32)
    pval = np.zeros((n_shards, e_pad), dtype=np.asarray(val).dtype)
    for p in range(n_shards):
        sel = shard_of_edge == p
        k = int(sel.sum())
        prow[p, :k] = (row[sel] - p * rows_per_shard).astype(np.int32)
        pcol[p, :k] = col[sel].astype(np.int32)
        pval[p, :k] = val[sel]
    return PartitionedGraph(
        row=jnp.asarray(prow),
        col=jnp.asarray(pcol),
        val=jnp.asarray(pval),
        n_nodes=g.n_nodes,
        n_pad=int(n_pad),
        rows_per_shard=int(rows_per_shard),
        n_shards=int(n_shards),
    )


def pad_features(x: np.ndarray, n_pad: int) -> np.ndarray:
    """Zero-pad node features to the partitioned node count."""
    out = np.zeros((n_pad, x.shape[1]), dtype=np.asarray(x).dtype)
    out[: x.shape[0]] = x
    return out
