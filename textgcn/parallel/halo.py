"""Ring halo-exchange sharded SpMM.

The all-gather path (:mod:`textgcn.parallel.sharded`) materializes all
N feature rows on every chip — O(N·F) memory per chip. This module keeps
memory at O(N/P · F): feature blocks rotate around the ring via
``lax.ppermute`` while each shard accumulates the edge bucket that matches
the block it currently holds. XLA can overlap the permute's transfer (NVLink
between the cards of one host) with the local segment-sum (SURVEY.md §7
"cross-shard aggregation overlap").

Edge layout (host-side, :func:`partition_rows_halo`): for owner shard ``p``
and source shard ``q``, bucket ``(p, q)`` holds p's edges whose column lives
on q, with **local** row and col ids; all buckets padded to one static size.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from textgcn.graph.structs import SparseGraph

AXIS = "nodes"


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["row", "col", "val"],
    meta_fields=["n_nodes", "n_pad", "rows_per_shard", "n_shards"],
)
@dataclasses.dataclass(frozen=True)
class HaloPartitionedGraph:
    """Edges bucketed by (owner shard, source-col shard).

    row: [P, P, E_b] int32 — local row id on the owner (phantom = rps).
    col: [P, P, E_b] int32 — local col id on the source (phantom = rps).
    val: [P, P, E_b] float.
    """

    row: jnp.ndarray
    col: jnp.ndarray
    val: jnp.ndarray
    n_nodes: int
    n_pad: int
    rows_per_shard: int
    n_shards: int


def partition_rows_halo(
    g: SparseGraph, n_shards: int, pad_edges_to_multiple: int = 256
) -> HaloPartitionedGraph:
    e = g.n_edges
    row = np.asarray(g.row)[:e].astype(np.int64)
    col = np.asarray(g.col)[:e].astype(np.int64)
    val = np.asarray(g.val)[:e]

    rps = _round_up(max(1, -(-g.n_nodes // n_shards)), 8)
    n_pad = rps * n_shards
    p_of = row // rps
    q_of = col // rps
    bucket = p_of * n_shards + q_of
    counts = np.bincount(bucket, minlength=n_shards * n_shards)
    e_b = _round_up(max(int(counts.max()), 1), pad_edges_to_multiple)

    # single stable sort + one vectorized scatter — O(E log E), not the
    # O(P^2 E) per-bucket boolean masks (which dominate host time at the
    # 500M-edge scale config)
    order = np.argsort(bucket, kind="stable")
    bs = bucket[order]
    offsets = np.concatenate([[0], np.cumsum(counts)])
    pos_in_bucket = np.arange(e, dtype=np.int64) - offsets[bs]
    dst = bs * e_b + pos_in_bucket

    prow = np.full((n_shards * n_shards * e_b,), rps, dtype=np.int32)
    pcol = np.full((n_shards * n_shards * e_b,), rps, dtype=np.int32)
    pval = np.zeros(
        (n_shards * n_shards * e_b,), dtype=np.asarray(val).dtype
    )
    prow[dst] = (row[order] - (bs // n_shards) * rps).astype(np.int32)
    pcol[dst] = (col[order] - (bs % n_shards) * rps).astype(np.int32)
    pval[dst] = val[order]
    prow = prow.reshape(n_shards, n_shards, e_b)
    pcol = pcol.reshape(n_shards, n_shards, e_b)
    pval = pval.reshape(n_shards, n_shards, e_b)
    return HaloPartitionedGraph(
        row=jnp.asarray(prow),
        col=jnp.asarray(pcol),
        val=jnp.asarray(pval),
        n_nodes=g.n_nodes,
        n_pad=int(n_pad),
        rows_per_shard=int(rps),
        n_shards=int(n_shards),
    )


def spmm_halo(
    hg: HaloPartitionedGraph, x: jnp.ndarray, mesh: Mesh
) -> jnp.ndarray:
    """Â @ x with ring-rotated feature blocks. x: [n_pad, F] row-sharded."""
    n_shards = hg.n_shards
    rps = hg.rows_per_shard
    ring = [(i, (i - 1) % n_shards) for i in range(n_shards)]

    def body(row_b, col_b, val_b, x_local):
        # shard-local views: row_b/col_b/val_b [1, P, E_b]; x_local [rps, F]
        row_b, col_b, val_b = row_b[0], col_b[0], val_b[0]
        p = jax.lax.axis_index(AXIS)
        f = x_local.shape[1]

        def step(s, carry):
            acc, h = carry
            q = jax.lax.rem(p + s, n_shards)  # whose block we hold now
            r = jax.lax.dynamic_index_in_dim(row_b, q, axis=0, keepdims=False)
            c = jax.lax.dynamic_index_in_dim(col_b, q, axis=0, keepdims=False)
            v = jax.lax.dynamic_index_in_dim(val_b, q, axis=0, keepdims=False)
            hp = jnp.concatenate(
                [h, jnp.zeros((1, f), dtype=h.dtype)], axis=0
            )
            contrib = hp[c] * v[:, None].astype(h.dtype)
            acc = acc + jax.ops.segment_sum(
                contrib, r, num_segments=rps + 1
            )
            h = jax.lax.ppermute(h, AXIS, perm=ring)
            return acc, h

        acc = jnp.zeros((rps + 1, f), dtype=jnp.float32)
        # mark the accumulator device-varying so the scan carry type matches
        # (shard_map varying-manual-axes typing)
        acc = jax.lax.pcast(acc, (AXIS,), to="varying")
        acc, _ = jax.lax.fori_loop(0, n_shards, step, (acc, x_local))
        return acc[:rps]

    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS, None)),
        out_specs=P(AXIS, None),
    )(hg.row, hg.col, hg.val, x)
