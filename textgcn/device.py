"""What the framework knows about the accelerator it runs on.

One table, keyed by ``jax.Device.device_kind``, of published peak rates,
and the memory budgets derived from them and from what the process may
allocate (``device.memory_stats()["bytes_limit"]``). The ``auto`` graph
format, the segment SpMM's chunking and the benchmark's roofline shares
all read it. A device that is not in the table is an error, not a default:
a format choice priced for another machine is a silent wrong answer.

The CPU is the test host, not a device this table prices; only the segment
SpMM's chunk cap (:func:`gather_bytes_limit`) has a host value.
"""
from __future__ import annotations

import dataclasses
import math

# Share of the process's device memory each budget may claim. A resident
# graph leaves half for activations, gradients, Adam moments and XLA's
# temporaries; one [N, N] table (or one transient [E, F] gather product)
# may take an eighth, since dense GAT keeps several [N, N] temporaries
# alive per layer and autodiff keeps two layers' worth.
RESIDENT_FRACTION = 1 / 2
DENSE_FRACTION = 1 / 8
GATHER_FRACTION = 1 / 8

# Cap on the transient [E, F] gather product when running on the host (the
# CPU test backend): a fixed 2 GiB, independent of any accelerator.
HOST_GATHER_BYTES_LIMIT = 2 << 30


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    """Published peaks of one accelerator and the budgets derived from them.

    ``bytes_limit`` is what one process may allocate; :func:`device_model`
    fills it from the live device, the table holds the card's capacity.
    """

    kind: str
    hbm_bytes_per_s: float
    bf16_flops: float
    tf32_flops: float
    memory_bytes: int
    source: str
    # measured on this kind of card, for the auto format choice: the share
    # of its bound a dense Â @ X pass reaches, and the rate at which the
    # segment pass moves its E·F·4 gathered bytes (the gathered rows are
    # mostly served from cache, so it runs faster than device memory)
    dense_pass_efficiency: float = 0.0
    segment_gather_bytes_per_s: float = 0.0
    measured: str = ""
    bytes_limit: int = 0

    def _limit(self) -> int:
        return self.bytes_limit or self.memory_bytes

    @property
    def resident_bytes_budget(self) -> int:
        """Device bytes a resident graph format may claim before ``auto``
        routes to edge streaming."""
        return int(self._limit() * RESIDENT_FRACTION)

    @property
    def dense_bytes_budget(self) -> int:
        """Cap on one f32 [N, N] table (dense GCN / dense GAT)."""
        return int(self._limit() * DENSE_FRACTION)

    @property
    def dense_max_nodes(self) -> int:
        """Largest N whose f32 [N, N] table fits the dense budget."""
        return math.isqrt(self.dense_bytes_budget // 4)

    @property
    def gather_bytes_limit(self) -> int:
        """Cap on the segment SpMM's transient [E, F] gather product."""
        return int(self._limit() * GATHER_FRACTION)


_H100_SOURCE = (
    "NVIDIA H100 Tensor Core GPU datasheet, SXM5: 3.35 TB/s HBM3, "
    "989 TFLOP/s dense bf16, 495 TFLOP/s dense TF32, 80 GB"
)

DEVICES = {
    "NVIDIA H100 80GB HBM3": DeviceModel(
        kind="NVIDIA H100 80GB HBM3",
        hbm_bytes_per_s=3.35e12,
        bf16_flops=989e12,
        tf32_flops=495e12,
        memory_bytes=80 * 10**9,
        source=_H100_SOURCE,
        dense_pass_efficiency=0.28,
        segment_gather_bytes_per_s=4.8e12,
        measured=(
            "A@X passes at F=200 on R8 topic, R8 doc-word and mr doc-word, "
            "H100 SXM at 700 W: dense reached 0.28-0.41 of its bound, "
            "segment moved 4.8-5.2 TB/s of gathered rows on the doc-word "
            "graphs (benchmark: bench.spmm_pass_perf)"
        ),
    ),
}


def device_model(device=None) -> DeviceModel:
    """The table entry for ``device`` (default: the first JAX device), with
    ``bytes_limit`` read from the live device. Raises ``ValueError`` for a
    device kind the table does not hold."""
    import jax

    device = device if device is not None else jax.devices()[0]
    kind = device.device_kind
    if kind not in DEVICES:
        raise ValueError(
            f"no device model for {kind!r} (platform {device.platform}); "
            f"known kinds: {sorted(DEVICES)}. Add its published peaks to "
            "textgcn.device.DEVICES, or pass an explicit DeviceModel."
        )
    stats = device.memory_stats() or {}
    limit = int(stats.get("bytes_limit", 0))
    return dataclasses.replace(DEVICES[kind], bytes_limit=limit)


def gather_bytes_limit(device=None) -> int:
    """Chunk cap for the segment SpMM's [E, F] gather product on ``device``
    (default: the first JAX device)."""
    import jax

    device = device if device is not None else jax.devices()[0]
    if device.platform == "cpu":
        return HOST_GATHER_BYTES_LIMIT
    return device_model(device).gather_bytes_limit
