"""Profiling and timing utilities.

The reference's only tracing is wall-clock prints (SURVEY.md §5). Here:
- :class:`StageTimer` — hierarchical named wall-clock scopes with a report;
- :func:`trace` — context manager around ``jax.profiler`` traces (view in
  TensorBoard / Perfetto);
- :func:`device_memory_stats` — live per-device memory (the JAX analogue
  of the reference's pynvml GPU accounting, utils.py:112-145).
"""
from __future__ import annotations

import contextlib
import time
from collections import OrderedDict
from typing import Dict, Iterator, Optional


class StageTimer:
    def __init__(self):
        self.times: "OrderedDict[str, float]" = OrderedDict()

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] = self.times.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def report(self) -> str:
        total = sum(self.times.values())
        lines = [f"{'stage':<30} {'seconds':>10} {'share':>7}"]
        for name, t in self.times.items():
            share = t / total if total else 0.0
            lines.append(f"{name:<30} {t:>10.2f} {share:>6.1%}")
        lines.append(f"{'TOTAL':<30} {total:>10.2f}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/jax-trace") -> Iterator[None]:
    """jax.profiler trace scope; open the dir in TensorBoard/Perfetto."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """Per-device memory stats in MB (where the backend reports them)."""
    import jax

    out: Dict[str, Dict[str, float]] = {}
    for d in jax.devices():
        try:
            stats = d.memory_stats()
        except Exception:
            stats = None
        if stats:
            out[str(d)] = {
                "bytes_in_use_mb": stats.get("bytes_in_use", 0) / 1e6,
                "peak_bytes_in_use_mb": stats.get("peak_bytes_in_use", 0)
                / 1e6,
                "bytes_limit_mb": stats.get("bytes_limit", 0) / 1e6,
            }
    return out
