"""Graph containers as JAX pytrees.

Design (for a compiled accelerator, not a port):

The reference keeps its graph as a ``networkx.Graph`` converted to a scipy CSR
and then a ``torch.sparse`` COO tensor (reference trainer.py:98-151,
utils.py:196-203).  XLA wants *static shapes*, so the device-side containers
here are fixed-size, padding-aware pytrees:

- :class:`SparseGraph` — row-sorted COO with explicit static padding.  The
  padding convention is ``row = col = n_nodes`` pointing at a phantom node
  with ``val = 0`` so padded edges contribute nothing to a segment-sum and
  never alias a real node's accumulator.  ``row`` stays sorted with padding
  at the end, enabling ``indices_are_sorted=True`` fast paths.

- :class:`DenseGraph` — the materialized [N, N] table for graphs whose
  table fits the device's dense budget.

- :class:`StreamedGraph` — a host-resident edge list in fixed-size chunks,
  for graphs whose edges should not live in device memory.

Host-side construction utilities live in :mod:`textgcn.graph.normalize`
and the builder modules; they work in numpy/scipy and only convert to device
pytrees at the jit boundary.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["row", "col", "val"],
    meta_fields=["n_nodes", "n_edges"],
)
@dataclasses.dataclass(frozen=True)
class SparseGraph:
    """Row-sorted padded COO sparse matrix (square, ``n_nodes`` x ``n_nodes``).

    Attributes:
      row:      [E_pad] int32, ascending; padding entries equal ``n_nodes``.
      col:      [E_pad] int32; padding entries equal ``n_nodes``.
      val:      [E_pad] float; padding entries are 0.
      n_nodes:  static — true number of nodes (segment count for SpMM).
      n_edges:  static — number of real (non-padding) entries.
    """

    row: jnp.ndarray
    col: jnp.ndarray
    val: jnp.ndarray
    n_nodes: int
    n_edges: int

    @property
    def n_padded_edges(self) -> int:
        return self.row.shape[0]

    @staticmethod
    def from_coo(
        row: np.ndarray,
        col: np.ndarray,
        val: np.ndarray,
        n_nodes: int,
        pad_to_multiple: int = 1024,
        dtype=jnp.float32,
    ) -> "SparseGraph":
        """Build from host COO arrays; sorts by (row, col) and pads."""
        row = np.asarray(row, dtype=np.int64)
        col = np.asarray(col, dtype=np.int64)
        val = np.asarray(val, dtype=np.float64)
        order = np.lexsort((col, row))
        row, col, val = row[order], col[order], val[order]
        e = row.shape[0]
        e_pad = max(_round_up(max(e, 1), pad_to_multiple), pad_to_multiple)
        prow = np.full((e_pad,), n_nodes, dtype=np.int32)
        pcol = np.full((e_pad,), n_nodes, dtype=np.int32)
        pval = np.zeros((e_pad,), dtype=np.float64)
        prow[:e] = row
        pcol[:e] = col
        pval[:e] = val
        return SparseGraph(
            row=jnp.asarray(prow),
            col=jnp.asarray(pcol),
            val=jnp.asarray(pval, dtype=dtype),
            n_nodes=int(n_nodes),
            n_edges=int(e),
        )

    def to_scipy(self):
        """Back to a scipy COO (drops padding). Host-side helper for tests."""
        import scipy.sparse as sp

        e = self.n_edges
        return sp.coo_matrix(
            (
                np.asarray(self.val)[:e],
                (np.asarray(self.row)[:e], np.asarray(self.col)[:e]),
            ),
            shape=(self.n_nodes, self.n_nodes),
        )

    def to_dense(self) -> jnp.ndarray:
        """Dense [n, n] materialization (small graphs / tests only)."""
        n = self.n_nodes
        dense = jnp.zeros((n + 1, n + 1), dtype=self.val.dtype)
        dense = dense.at[self.row, self.col].add(self.val)
        return dense[:n, :n]


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["a"],
    meta_fields=["n_nodes"],
)
@dataclasses.dataclass(frozen=True)
class DenseGraph:
    """Dense [N, N] adjacency — one GEMM per aggregation, no gather or
    scatter at all.

    Materialized once ON DEVICE by a scatter-add from the (already
    resident) padded COO, so only the O(E) edge list crosses the host
    link, not the O(N²) table (944 MB on R8 doc-word).
    """

    a: jnp.ndarray  # [n, n] float32
    n_nodes: int

    @staticmethod
    def from_sparse_graph(g: "SparseGraph") -> "DenseGraph":
        n = int(g.n_nodes)

        @partial(jax.jit, static_argnames=())
        def densify(row, col, val):
            # padded entries carry row == col == n → land in the phantom
            # rim and are sliced off (val is 0 there anyway)
            d = jnp.zeros((n + 1, n + 1), dtype=jnp.float32)
            return d.at[row, col].add(val.astype(jnp.float32))[:n, :n]

        return DenseGraph(a=densify(g.row, g.col, g.val), n_nodes=n)


@dataclasses.dataclass(frozen=True)
class StreamedGraph:
    """Host-resident COO in fixed-size chunks — the ``streamed`` format.

    The edge list stays in host memory; :func:`textgcn.ops.spmm.spmm`
    feeds it chunk by chunk through
    :func:`textgcn.ops.spmm.spmm_streamed_hostfed`, so only ``x``, the
    f32 accumulator and two chunks are ever on the device. The last chunk
    is padded with ``row = col = n_nodes``, ``val = 0`` (the scatter drops
    it, the gather fills zeros).

    Attributes:
      row, col: [n_chunks, chunk_e] int32.
      val:      [n_chunks, chunk_e] float32.
      n_nodes:  true number of nodes.
      n_edges:  number of real (non-padding) entries.
    """

    row: np.ndarray
    col: np.ndarray
    val: np.ndarray
    n_nodes: int
    n_edges: int

    @property
    def n_chunks(self) -> int:
        return self.row.shape[0]

    @staticmethod
    def from_coo(
        row: np.ndarray,
        col: np.ndarray,
        val: np.ndarray,
        n_nodes: int,
        chunk_e: int = 4_000_000,
    ) -> "StreamedGraph":
        e = int(len(row))
        chunk_e = min(chunk_e, _round_up(max(e, 1), 1024))
        n_chunks = max(-(-e // chunk_e), 1)
        size = n_chunks * chunk_e

        def padded(a, fill, dtype):
            out = np.full((size,), fill, dtype=dtype)
            out[:e] = a
            return out.reshape(n_chunks, chunk_e)

        return StreamedGraph(
            row=padded(row, n_nodes, np.int32),
            col=padded(col, n_nodes, np.int32),
            val=padded(val, 0.0, np.float32),
            n_nodes=int(n_nodes),
            n_edges=e,
        )

    def chunks(self):
        """The host chunks as ``(row, col, val)`` triples."""
        return zip(self.row, self.col, self.val)
