"""Graph-format selection.

The framework stores every built graph as a normalized :class:`SparseGraph`
(row-sorted COO). Which container aggregates it is a performance choice,
not a semantics choice — all formats compute the same ``Â @ x`` (the
reference has exactly one path, ``torch.spmm``, reference layer.py:102,106).
This module converts a ``SparseGraph`` into the container whose SpMM
dispatch (:func:`textgcn.ops.spmm.spmm`) suits the graph and the device:

==========  ==============================================================
format      what aggregates it
==========  ==============================================================
segment     gather + ``segment_sum`` (XLA gather and atomic scatter-add).
            Always correct; the oracle.
dense       one [N, N] @ [N, F] GEMM on the materialized table.
streamed    the host-resident edge list fed to the device chunk by chunk
            (:class:`textgcn.graph.structs.StreamedGraph`).
auto        :func:`choose_format`: from the graph's size and the device's
            budgets and peaks (:mod:`textgcn.device`).
==========  ==============================================================
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from textgcn.device import DeviceModel, device_model
from textgcn.graph.structs import DenseGraph, SparseGraph, StreamedGraph

SPMM_FORMATS = ("auto", "segment", "dense", "streamed")


def resident_bytes(n: int, e: int, f: int) -> int:
    """Device bytes a resident format needs: the COO (12 B/edge) next to
    an [N, f] f32 input and output."""
    return 12 * e + 8 * n * f


def dense_pass_bound(n: int, f: int, dm: DeviceModel) -> float:
    """Least time of one dense pass: the f32 [N, N] table and [N, f] input
    and output moved at the memory peak, or the TF32 GEMM's 2·N²·f flops
    at the tensor-core peak, whichever is larger."""
    return max(
        (4 * n * n + 8 * n * f) / dm.hbm_bytes_per_s,
        2.0 * n * n * f / dm.tf32_flops,
    )


def segment_pass_bound(n: int, e: int, f: int, dm: DeviceModel) -> float:
    """Least time of one segment pass: its compulsory traffic — 12 B of
    COO per edge and the [N, f] input and output — at the memory peak,
    with every gathered row served from cache."""
    return (12 * e + 8 * n * f) / dm.hbm_bytes_per_s


def estimate_pass_seconds(
    n: int, e: int, f: int, dm: DeviceModel
) -> Dict[str, float]:
    """Expected seconds of one Â @ X pass per resident format, from the
    device's measured dense efficiency and segment gather rate."""
    return {
        "dense": dense_pass_bound(n, f, dm) / dm.dense_pass_efficiency,
        "segment": 4.0 * e * f / dm.segment_gather_bytes_per_s,
    }


def choose_format(
    g: SparseGraph, f: int = 200, model: Optional[DeviceModel] = None
) -> str:
    """The format ``auto`` picks for ``g`` at feature width ``f``.

    ``streamed`` when the resident formats would not fit the device's
    resident budget; ``dense`` when the [N, N] table fits the dense budget
    and its expected pass is no slower than the segment pass
    (:func:`estimate_pass_seconds`); otherwise ``segment``. On the H100
    the crossover sits near a density E/N² of 2.5%: every text graph this
    repository ships is sparser and gets ``segment``.
    """
    dm = model if model is not None else device_model()
    n, e = g.n_nodes, g.n_edges
    if resident_bytes(n, e, f) > dm.resident_bytes_budget:
        return "streamed"
    if n <= dm.dense_max_nodes:
        est = estimate_pass_seconds(n, e, f, dm)
        if est["dense"] <= est["segment"]:
            return "dense"
    return "segment"


def convert_graph(
    g: SparseGraph,
    fmt: str = "auto",
    *,
    f: int = 200,
    model: Optional[DeviceModel] = None,
):
    """SparseGraph → the container for ``fmt`` (``auto`` resolved by
    :func:`choose_format` at width ``f`` on ``model``, default the live
    device)."""
    if fmt not in SPMM_FORMATS:
        raise ValueError(
            f"unknown spmm format {fmt!r}; choose one of {SPMM_FORMATS}"
        )
    if fmt == "auto":
        fmt = choose_format(g, f=f, model=model)
    if fmt == "segment":
        return g
    if fmt == "dense":
        return DenseGraph.from_sparse_graph(g)
    e = g.n_edges
    return StreamedGraph.from_coo(
        np.asarray(g.row)[:e],
        np.asarray(g.col)[:e],
        np.asarray(g.val)[:e],
        g.n_nodes,
    )
