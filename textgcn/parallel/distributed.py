"""Multi-host (multi-process) scaffolding over ``jax.distributed``.

The reference has no distributed code at all (SURVEY.md §2 rows 23-24);
here ``jax.distributed.initialize`` connects the processes of a
multi-process job, after which ``jax.devices()`` spans every device in the
job and the existing mesh code (:func:`textgcn.parallel.sharded.make_mesh`,
:class:`textgcn.parallel.trainer.ShardedTrainer`) works unchanged — XLA
hands the same ``psum``/``ppermute`` collectives to NCCL (NVLink between
the cards of one host, the network between hosts). No hand-written
transport exists anywhere in this framework; the collectives ARE the
backend.

One process drives every card of a host, so single-host runs never need
this module. See
``docs/DISTRIBUTED.md`` for the launch recipe. The multi-process path is
EXECUTED in the test suite: tests/test_distributed.py launches two real OS
processes with a localhost coordinator (4 virtual CPU devices each), runs
``init_distributed`` in each, and trains one sharded step over the global
8-device mesh, asserting loss parity with the single-process run — the
same code path a multi-host GPU job takes.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional


@dataclasses.dataclass(frozen=True)
class DistributedConfig:
    """Process-level topology, resolvable from standard launcher env vars."""

    coordinator_address: Optional[str] = None  # "host:port"
    num_processes: Optional[int] = None
    process_id: Optional[int] = None

    @staticmethod
    def from_env(env=None) -> "DistributedConfig":
        """Read the common launcher conventions.

        Checked in order (first hit wins per field):
        - explicit JAX vars: ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
          ``JAX_PROCESS_ID``;
        - generic MPI-ish vars: ``OMPI_COMM_WORLD_SIZE``/``_RANK``,
          ``SLURM_NTASKS``/``SLURM_PROCID`` (coordinator still needs the
          explicit address var).
        """
        env = env if env is not None else os.environ
        addr = env.get("JAX_COORDINATOR_ADDRESS")
        nproc = env.get("JAX_NUM_PROCESSES")
        pid = env.get("JAX_PROCESS_ID")
        if nproc is None:
            nproc = env.get("OMPI_COMM_WORLD_SIZE") or env.get("SLURM_NTASKS")
        if pid is None:
            pid = env.get("OMPI_COMM_WORLD_RANK") or env.get("SLURM_PROCID")
        return DistributedConfig(
            coordinator_address=addr,
            num_processes=int(nproc) if nproc is not None else None,
            process_id=int(pid) if pid is not None else None,
        )

    @property
    def is_multiprocess(self) -> bool:
        return (self.num_processes or 1) > 1 or (
            self.coordinator_address is not None
        )


_initialized = False


def init_distributed(
    config: Optional[DistributedConfig] = None, force: bool = False
) -> bool:
    """Connect this process to the job via ``jax.distributed.initialize``.

    Call ONCE, before any other JAX API touches the backend. Returns True
    when a multi-process runtime was initialized, False for the
    single-process no-op (laptop, one host, CI) — in which case all
    existing code paths run unchanged. Without a cluster manager that
    JAX recognizes, every process needs the coordinator address, the
    process count and its own id (``JAX_COORDINATOR_ADDRESS``,
    ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``).
    """
    global _initialized
    if _initialized and not force:
        return True
    cfg = config or DistributedConfig.from_env()
    if not cfg.is_multiprocess and not force:
        return False
    import jax

    kwargs = {}
    if cfg.coordinator_address is not None:
        kwargs["coordinator_address"] = cfg.coordinator_address
    if cfg.num_processes is not None:
        kwargs["num_processes"] = cfg.num_processes
    if cfg.process_id is not None:
        kwargs["process_id"] = cfg.process_id
    jax.distributed.initialize(**kwargs)
    _initialized = True
    return True


def global_mesh(axis: str = "nodes"):
    """1-D mesh over EVERY device in the job (all processes).

    After :func:`init_distributed`, ``jax.devices()`` is the global device
    list ordered so that each process's local devices are contiguous —
    contiguous 1-D row partitions therefore keep a shard's halo neighbors
    on the same host wherever possible, with only the ring's hops between
    hosts crossing the network.
    """
    import jax
    import numpy as np
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()), (axis,))


def process_summary() -> str:
    """One-line description of this process's view of the job."""
    import jax

    return (
        f"process {jax.process_index()}/{jax.process_count()}: "
        f"{jax.local_device_count()} local / {jax.device_count()} global "
        f"devices"
    )
