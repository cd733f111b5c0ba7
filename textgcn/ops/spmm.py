"""SpMM: sparse adjacency × dense features, the framework's hot op.

Replaces the reference's ``torch.spmm`` (reference layer.py:102,106) with
plain XLA implementations:

- :func:`spmm_coo_segment` — gather → scale → ``segment_sum`` (an atomic
  scatter-add on the GPU). Differentiable, runs anywhere. The correctness
  oracle.
- :func:`spmm_dense` — materialized dense matmul for graphs whose [N, N]
  table fits the device's dense budget (one cuBLAS GEMM).
- :func:`spmm_streamed` and friends — edge streams for graphs whose edge
  list does not fit device memory.

:func:`spmm` dispatches on the graph container type.
"""
from __future__ import annotations

from functools import partial
from typing import Union

import jax
import jax.numpy as jnp

from textgcn.graph.structs import DenseGraph, SparseGraph, StreamedGraph


def _chunk_count(e_pad: int, f: int, itemsize: int = 4) -> int:
    """Passes over the edge list that keep the transient [E, F] gather
    product under the device's cap (textgcn.device.gather_bytes_limit):
    XLA's unsorted scatter-add otherwise materializes the whole product —
    25.8 GB at 50M edges x F=128."""
    from textgcn.device import gather_bytes_limit

    limit = gather_bytes_limit()
    total = e_pad * f * itemsize
    if total <= limit:
        return 1
    return -(-total // limit)


def _spmm_coo_impl(row, col, val, x, n_nodes, indices_are_sorted):
    xp = jnp.concatenate([x, jnp.zeros((1, x.shape[1]), dtype=x.dtype)], axis=0)
    e_pad = row.shape[0]
    n_chunks = _chunk_count(e_pad, x.shape[1])
    if n_chunks == 1:
        gathered = xp[col] * val[:, None].astype(x.dtype)
        out = jax.ops.segment_sum(
            gathered,
            row,
            num_segments=n_nodes + 1,
            indices_are_sorted=indices_are_sorted,
        )
        return out[:n_nodes]

    chunk = -(-e_pad // n_chunks)
    extra = n_chunks * chunk - e_pad
    if extra:
        # Pad the edge stream so it reshapes evenly: phantom row/col land in
        # the dropped segment, val=0 contributes nothing.
        row = jnp.concatenate([row, jnp.full((extra,), n_nodes, row.dtype)])
        col = jnp.concatenate([col, jnp.full((extra,), n_nodes, col.dtype)])
        val = jnp.concatenate([val, jnp.zeros((extra,), val.dtype)])

    def body(acc, args):
        r, c, v = args
        gathered = xp[c] * v[:, None].astype(x.dtype)
        return (
            acc
            + jax.ops.segment_sum(
                gathered, r, num_segments=n_nodes + 1
            ),
            None,
        )

    acc0 = jnp.zeros((n_nodes + 1, x.shape[1]), dtype=jnp.float32)
    out, _ = jax.lax.scan(
        body,
        acc0,
        (
            row.reshape(n_chunks, chunk),
            col.reshape(n_chunks, chunk),
            val.reshape(n_chunks, chunk),
        ),
    )
    return out[:n_nodes]


@partial(jax.custom_vjp, nondiff_argnums=(4, 5))
def spmm_coo_segment(
    row: jnp.ndarray,
    col: jnp.ndarray,
    val: jnp.ndarray,
    x: jnp.ndarray,
    n_nodes: int,
    indices_are_sorted: bool = True,
) -> jnp.ndarray:
    """(A @ x) for padded COO A. Padding rows (== n_nodes) land in a dropped
    phantom segment; padding vals are 0 anyway.

    Differentiable in ``x`` with a custom VJP: the cotangent is the
    transpose SpMM ``Aᵀ @ g`` (col/row swapped), so autodiff never stores
    the [E, F] gather product as a residual (25.6 GB at 50M edges x
    F=128). ``val`` is treated as a
    constant (adjacency weights are not trained in this framework).

    Args:
      row, col: [E] int32 (row sorted ascending if indices_are_sorted).
      val:      [E] float.
      x:        [N, F] float (N == n_nodes; an extra phantom row is appended
                internally so padded ``col == n_nodes`` gathers zeros).
    Returns:
      [N, F] float32 result.
    """
    return _spmm_coo_impl(row, col, val, x, n_nodes, indices_are_sorted)


def _spmm_fwd(row, col, val, x, n_nodes, indices_are_sorted):
    return (
        _spmm_coo_impl(row, col, val, x, n_nodes, indices_are_sorted),
        (row, col, val),
    )


def _spmm_bwd(n_nodes, indices_are_sorted, res, g):
    row, col, val = res
    # d/dx (A @ x) applied to cotangent g is Aᵀ @ g: swap row/col. The
    # transposed rows are NOT sorted, so indices_are_sorted=False.
    dx = _spmm_coo_impl(col, row, val, g, n_nodes, False)
    return None, None, None, dx


spmm_coo_segment.defvjp(_spmm_fwd, _spmm_bwd)


def sddmm(
    row: jnp.ndarray,
    col: jnp.ndarray,
    a: jnp.ndarray,
    b: jnp.ndarray,
) -> jnp.ndarray:
    """Sampled dense-dense matmul: ``out[e] = a[row[e]] · b[col[e]]``.

    The sparse-pattern-restricted product ``(A ⊙ (a @ bᵀ))`` evaluated only
    at edge positions — the op the reference never needs (its ``torch.spmm``
    adjacency is frozen, layer.py:102,106) but a framework with learnable
    edge weights does: it IS the VJP of SpMM w.r.t. the edge values.
    Out-of-range indices (padding, == N) contribute 0 via masked-fill
    gathers. Chunked over the edge stream so the [E, F] gather transients
    stay under the same HBM cap as SpMM.
    """
    e_pad = row.shape[0]
    f = a.shape[1]
    n_chunks = _chunk_count(e_pad, 2 * f)
    if n_chunks == 1:
        ga = jnp.take(a, row, axis=0, mode="fill", fill_value=0)
        gb = jnp.take(b, col, axis=0, mode="fill", fill_value=0)
        return jnp.sum(ga.astype(jnp.float32) * gb.astype(jnp.float32), axis=1)

    chunk = -(-e_pad // n_chunks)
    extra = n_chunks * chunk - e_pad
    n = a.shape[0]
    if extra:
        row = jnp.concatenate([row, jnp.full((extra,), n, row.dtype)])
        col = jnp.concatenate([col, jnp.full((extra,), n, col.dtype)])

    def body(_, rc):
        r, c = rc
        ga = jnp.take(a, r, axis=0, mode="fill", fill_value=0)
        gb = jnp.take(b, c, axis=0, mode="fill", fill_value=0)
        return None, jnp.sum(
            ga.astype(jnp.float32) * gb.astype(jnp.float32), axis=1
        )

    _, out = jax.lax.scan(
        body,
        None,
        (row.reshape(n_chunks, chunk), col.reshape(n_chunks, chunk)),
    )
    return out.reshape(-1)[:e_pad]


@partial(jax.custom_vjp, nondiff_argnums=(4, 5))
def spmm_coo_segment_ew(
    row: jnp.ndarray,
    col: jnp.ndarray,
    val: jnp.ndarray,
    x: jnp.ndarray,
    n_nodes: int,
    indices_are_sorted: bool = True,
) -> jnp.ndarray:
    """:func:`spmm_coo_segment` that is ALSO differentiable in ``val``.

    Separate entry point so the frozen-adjacency hot path pays nothing:
    the extra VJP residual here is ``x`` plus an :func:`sddmm` pass on the
    backward (dval[e] = g[row[e]] · x[col[e]]). Use for learnable edge
    weights (attention-style edge scaling).
    """
    return _spmm_coo_impl(row, col, val, x, n_nodes, indices_are_sorted)


def _spmm_ew_fwd(row, col, val, x, n_nodes, indices_are_sorted):
    return (
        _spmm_coo_impl(row, col, val, x, n_nodes, indices_are_sorted),
        (row, col, val, x),
    )


def _spmm_ew_bwd(n_nodes, indices_are_sorted, res, g):
    row, col, val, x = res
    dx = _spmm_coo_impl(col, row, val, g, n_nodes, False)
    dval = sddmm(row, col, g, x)
    return None, None, dval.astype(val.dtype), dx


spmm_coo_segment_ew.defvjp(_spmm_ew_fwd, _spmm_ew_bwd)


def spmm_dense(a_dense: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    return jnp.dot(a_dense, x, preferred_element_type=jnp.float32)


@partial(jax.jit, static_argnames=("edge_fn", "n_chunks", "n_nodes"))
def spmm_streamed(
    edge_fn,
    x: jnp.ndarray,
    n_nodes: int,
    n_chunks: int,
) -> jnp.ndarray:
    """``Â @ x`` over an edge STREAM that never materializes in HBM.

    For graphs whose edge list should not live in device memory, the edges
    are produced chunk by chunk inside the compiled loop and scatter-added
    into the resident accumulator. Only ``x`` ([N, F], bf16 recommended) and the f32
    accumulator ([N+1, F]) live in HBM; each chunk's [chunk_e, F] gather
    product is a transient.

    Args:
      edge_fn: static traceable ``i -> (row, col, val)`` producing chunk
        ``i``'s edges on device (e.g. from a PRNG for synthetic graphs, or
        via ``jax.device_put`` streaming callbacks for real ones). Padding
        convention: ``row == n_nodes`` drops the edge (out-of-bounds
        scatter updates drop; ``col == n_nodes`` gathers the phantom row).
      x: [n_nodes, F] features.
      n_nodes, n_chunks: static.
    Returns:
      [n_nodes, F] float32.

    Memory note: the accumulator IS the output buffer — no [N+1] phantom
    row and no post-loop slice, so exactly one [N, F] f32 array lives in
    HBM beyond ``x`` (at 10M x 128 the phantom-row variant's slice copy
    alone would add 5 GB). Likewise the out-of-range
    ``col`` gather uses a masked-fill gather directly from ``x`` rather
    than concatenating a phantom row — the concat would copy all of ``x``
    (another 2.6 GB at that shape).
    """

    def body(i, acc):
        return _stream_chunk_add(edge_fn, x, i, acc)

    acc = jnp.zeros((n_nodes, x.shape[1]), dtype=jnp.float32)
    return jax.lax.fori_loop(0, n_chunks, body, acc)


def _stream_chunk_add(edge_fn, x, i, acc):
    """Scatter-add chunk ``i``'s gather product into the accumulator (the
    shared loop body of :func:`spmm_streamed` and the segmented variant)."""
    row, col, val = edge_fn(i)
    gathered = jnp.take(
        x, col, axis=0, mode="fill", fill_value=0, unique_indices=False
    )
    contrib = gathered * val[:, None].astype(x.dtype)
    return acc.at[row].add(
        contrib.astype(jnp.float32),
        indices_are_sorted=False,
        unique_indices=False,
        mode="drop",
    )


@partial(
    jax.jit,
    static_argnames=("edge_fn", "seg", "n_nodes"),
    donate_argnums=(2,),
)
def _spmm_stream_segment(edge_fn, x, acc, lo, seg, n_nodes):
    """``seg`` chunks starting at traced offset ``lo``, accumulator donated
    (one [N, F] f32 buffer alive across the whole host-segmented pass)."""
    del n_nodes

    def body(j, a):
        return _stream_chunk_add(edge_fn, x, lo + j, a)

    return jax.lax.fori_loop(0, seg, body, acc)


def spmm_streamed_multi(
    edge_fn,
    x: jnp.ndarray,
    n_nodes: int,
    n_chunks: int,
    chunks_per_dispatch: int = 32,
) -> jnp.ndarray:
    """:func:`spmm_streamed` split into MULTIPLE device dispatches.

    Identical math (same chunk body, same f32 accumulator — donated
    across segments, so exactly one [N, F] buffer lives regardless of
    segment count), but no single XLA program runs longer than
    ``chunks_per_dispatch`` chunks, and the host loop between dispatches
    is where the segmented train steps (train/streamed.py) splice their
    manual backward. Two compilations per
    (shape, seg): the full segment and, when ``seg ∤ n_chunks``, the
    remainder. The chunk offset ``lo`` is a traced scalar, so advancing
    through the stream never retraces. NOT differentiable — used by the
    manual-backward segmented train step (train/streamed.py).
    """
    seg = max(1, min(chunks_per_dispatch, n_chunks))
    acc = jnp.zeros((n_nodes, x.shape[1]), dtype=jnp.float32)
    n_full = n_chunks // seg
    for k in range(n_full):
        acc = _spmm_stream_segment(
            edge_fn, x, acc, jnp.asarray(k * seg, jnp.int32), seg, n_nodes
        )
    rem = n_chunks - n_full * seg
    if rem:
        acc = _spmm_stream_segment(
            edge_fn, x, acc, jnp.asarray(n_full * seg, jnp.int32), rem,
            n_nodes,
        )
    return acc


@partial(jax.jit, donate_argnums=(0,))
def _hostfed_chunk_add(acc, row, col, val, x):
    """One host-fed chunk scatter-added into the DONATED accumulator
    (same drop/fill padding semantics as the device-generated stream)."""
    gathered = jnp.take(
        x, col, axis=0, mode="fill", fill_value=0, unique_indices=False
    )
    contrib = gathered * val[:, None].astype(x.dtype)
    return acc.at[row].add(
        contrib.astype(jnp.float32),
        indices_are_sorted=False,
        unique_indices=False,
        mode="drop",
    )


def spmm_streamed_hostfed(chunks, x: jnp.ndarray, n_nodes: int) -> jnp.ndarray:
    """``Â @ x`` over edge chunks that live on HOST (disk / RAM) only.

    The device-generated stream (:func:`spmm_streamed`) covers synthetic
    and HBM-resident edge sources; REAL beyond-HBM graphs keep their edge
    list on disk. This consumes any (re-)iterable of host ``(row, col,
    val)`` chunk triples — e.g. :func:`edge_chunks_from_memmap` over
    ``np.memmap`` files — transferring one chunk at a time with a
    ONE-CHUNK LOOKAHEAD: chunk i+1's host→device copy is issued (JAX
    transfers are async) before chunk i's scatter-add is dispatched, so
    PCIe/DMA overlaps compute. Only ``x``, the f32 accumulator, and at
    most two chunks are ever on device.

    Differentiable indirectly: for symmetric Â the backward is this same
    function applied to the cotangent — the segmented train steps accept
    it through their ``stream_fn`` hook (each of the 2k passes re-reads
    the chunk source; that re-read is the honest cost of edges that
    cannot be resident).
    """
    acc = jnp.zeros((n_nodes, x.shape[1]), dtype=jnp.float32)
    it = iter(chunks)
    try:
        nxt = next(it)
    except StopIteration:
        return acc
    pending = tuple(jax.device_put(jnp.asarray(a)) for a in nxt)
    while pending is not None:
        cur = pending
        pending = None
        try:
            nxt = next(it)
            pending = tuple(jax.device_put(jnp.asarray(a)) for a in nxt)
        except StopIteration:
            pass
        acc = _hostfed_chunk_add(acc, cur[0], cur[1], cur[2], x)
    return acc


def edge_chunks_from_memmap(
    row_path: str,
    col_path: str,
    val_path: str,
    chunk_e: int = 4_000_000,
    n_edges: int = None,
):
    """Re-iterable host chunk source over ``np.memmap`` edge files
    (int32 row/col, float32 val) — the on-disk feed for
    :func:`spmm_streamed_hostfed`. The OS page cache does the disk
    prefetching; chunks are yielded as numpy views (copied only at the
    host→device transfer). The final partial chunk is padded with the
    drop/fill convention (row = col = n... callers pass padded ids via
    the files themselves or accept the zero-val pad here).
    """
    import numpy as np

    class _Source:
        def __iter__(self):
            row = np.memmap(row_path, dtype=np.int32, mode="r")
            col = np.memmap(col_path, dtype=np.int32, mode="r")
            val = np.memmap(val_path, dtype=np.float32, mode="r")
            e = len(row) if n_edges is None else n_edges
            for lo in range(0, e, chunk_e):
                hi = min(lo + chunk_e, e)
                r, c, v = row[lo:hi], col[lo:hi], val[lo:hi]
                if hi - lo < chunk_e:  # static shapes: pad the tail
                    pad = chunk_e - (hi - lo)
                    big = np.iinfo(np.int32).max  # drops on scatter,
                    # fills 0 on gather (out of range either way)
                    r = np.concatenate([r, np.full(pad, big, np.int32)])
                    c = np.concatenate([c, np.full(pad, big, np.int32)])
                    v = np.concatenate([v, np.zeros(pad, np.float32)])
                yield r, c, v

    return _Source()


@partial(jax.custom_vjp, nondiff_argnums=(0, 2, 3))
def spmm_streamed_sym(
    edge_fn,
    x: jnp.ndarray,
    n_nodes: int,
    n_chunks: int,
) -> jnp.ndarray:
    """:func:`spmm_streamed` for SYMMETRIC Â, differentiable in ``x``.

    Normalized GCN adjacencies are symmetric (Â = ÂT), so the backward
    ``ÂT @ g`` is just another streamed pass over the SAME edge stream —
    no transpose materialization, no stored [E, F] residuals. This makes
    beyond-HBM graphs *trainable*, not just inferable: the edge list never
    exists on device in either direction of autodiff.

    Caller asserts symmetry: ``edge_fn`` must enumerate both (u, v) and
    (v, u) (or equivalently the stream's scatter/gather roles must be
    exchangeable). For directed graphs use :func:`spmm_streamed` under
    ``jax.lax.stop_gradient`` or provide a transposed stream by hand.
    """
    return spmm_streamed(edge_fn, x, n_nodes, n_chunks)


def _spmm_streamed_sym_fwd(edge_fn, x, n_nodes, n_chunks):
    # residual is a REFERENCE to x (no copy; x is resident anyway) — only
    # its dtype is needed to type the cotangent
    return spmm_streamed(edge_fn, x, n_nodes, n_chunks), x


def _spmm_streamed_sym_bwd(edge_fn, n_nodes, n_chunks, x_res, g):
    dx = spmm_streamed(edge_fn, g.astype(x_res.dtype), n_nodes, n_chunks)
    return (dx.astype(x_res.dtype),)


spmm_streamed_sym.defvjp(_spmm_streamed_sym_fwd, _spmm_streamed_sym_bwd)


def spmm(
    graph: Union[SparseGraph, DenseGraph, StreamedGraph],
    x: jnp.ndarray,
    method: str = "auto",
) -> jnp.ndarray:
    """Â @ x with dispatch on the graph container type.

    ``DenseGraph`` → one matmul; ``SparseGraph`` → ``method`` "segment"
    (default) or "dense" (materialize per call — tests only; prefer
    ``DenseGraph``); host-resident ``StreamedGraph`` → the host-fed edge
    stream. The device branches are differentiable in ``x``.
    """
    if isinstance(graph, StreamedGraph):
        # the edge chunks stay on the host and stream through
        # spmm_streamed_hostfed; they never cross a jit boundary
        return spmm_streamed_hostfed(graph.chunks(), x, graph.n_nodes)
    return _spmm_jit(graph, x, method)


@partial(jax.jit, static_argnames=("method",))
def _spmm_jit(graph, x, method="auto"):
    if isinstance(graph, DenseGraph):
        return spmm_dense(graph.a, x)
    if method == "auto":
        method = "segment"
    if method == "segment":
        return spmm_coo_segment(
            graph.row, graph.col, graph.val, x, graph.n_nodes
        )
    if method == "dense":
        return spmm_dense(graph.to_dense(), x)
    raise ValueError(f"unknown spmm method: {method}")
