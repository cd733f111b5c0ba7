"""Sharded-SpMM scaling benchmark over a device mesh.

Measures edges/s for the all-gather and ring-halo aggregation paths at
1..P shards. On real multi-device hardware this measures interconnect-limited scaling
efficiency (the BASELINE ≥80% target); on a CPU-forced virtual mesh
(``--virtual``) the devices share one machine, so the numbers validate
*methodology and compiled collectives*, not real bandwidth —
``__graft_entry__.dryrun_multichip`` covers compile/execute correctness
the same way.

Run: python benchmarks/scaling_bench.py [--virtual] [--n 200000] [--deg 25]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_train(args) -> int:
    """Halo-partitioned TRAINING at ≥1M nodes on the 8-way mesh (round-2
    verdict item #3's reduced-scale requirement): the full ShardedTrainer
    semantics — scan-blocked epochs, psum'd loss, confusion-matrix eval,
    ring ppermute aggregation — run for a few epochs at 1M nodes / ~2x
    ``deg``M symmetrized edges. On the virtual CPU mesh the wall-clock
    validates methodology (shared cores), not interconnect bandwidth."""
    import jax
    import jax.numpy as jnp  # noqa: F401

    from textgcn.graph.normalize import sym_normalize_coo
    from textgcn.graph.structs import SparseGraph
    from textgcn.parallel.trainer import ShardedTrainer
    from textgcn.train.trainer import TrainConfig

    n, e = args.n, args.n * args.deg
    rng = np.random.RandomState(0)
    print(f"[train] building {n}-node graph, {e} directed edges",
          file=sys.stderr, flush=True)
    row = rng.randint(0, n, e)
    col = rng.randint(0, n, e)
    val = rng.rand(e)
    r, c, v = sym_normalize_coo(row, col, val, n)
    g = SparseGraph.from_coo(r, c, v, n, pad_to_multiple=8192)
    x = rng.randn(n, args.f).astype(np.float32)
    target = rng.randint(0, 16, n).astype(np.int64)
    idx = np.arange(n)
    is_train = rng.rand(n) < 0.5
    t_part = time.perf_counter()
    trainer = ShardedTrainer(
        g, x, target, idx[is_train], idx[~is_train], 16,
        config=TrainConfig(
            n_hidden=args.f, max_epoch=args.epochs, early_stopping=100,
            dropout=0.5, seed=0, epoch_block=args.epochs,
        ),
        n_shards=min(8, len(jax.devices())),
        partition="halo",
    )
    part_s = time.perf_counter() - t_part
    t0 = time.perf_counter()
    trainer.fit(verbose=False)
    fit_s = time.perf_counter() - t0
    res = trainer.test()
    print(
        json.dumps(
            {
                "phase": "halo_sharded_training",
                "n_nodes": n,
                "n_edges_sym": g.n_edges,
                "f": args.f,
                "shards": trainer.n_shards,
                "partition_s": part_s,
                "epochs": len(trainer.history),
                "s_per_epoch": fit_s / max(len(trainer.history), 1),
                "edges_per_s_fwdbwd": 6 * g.n_edges
                * len(trainer.history) / fit_s,
                "final_train_loss": trainer.history[-1]["train_loss"],
                "test_acc": res["acc"],
            }
        ),
        flush=True,
    )
    assert np.isfinite(res["test_loss"])
    return 0


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--virtual", action="store_true", help="8 virtual CPU devices")
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--deg", type=int, default=20)
    p.add_argument("--f", type=int, default=128)
    p.add_argument(
        "--train",
        action="store_true",
        help="full halo-partitioned ShardedTrainer run (use with "
        "--n 1000000 --deg 8 --f 32 --epochs 2 on the virtual mesh)",
    )
    p.add_argument("--epochs", type=int, default=2)
    args = p.parse_args()

    if args.virtual:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8"
        )
    import jax

    if args.virtual:
        jax.config.update("jax_platforms", "cpu")
    if args.train:
        return run_train(args)
    import jax.numpy as jnp

    from textgcn.graph.normalize import sym_normalize_coo
    from textgcn.graph.structs import SparseGraph
    from textgcn.ops.spmm import spmm
    from textgcn.parallel.halo import partition_rows_halo, spmm_halo
    from textgcn.parallel.partition import pad_features, partition_rows
    from textgcn.parallel.sharded import make_mesh, spmm_sharded

    n, e = args.n, args.n * args.deg
    rng = np.random.RandomState(0)
    row = rng.randint(0, n, e)
    col = rng.randint(0, n, e)
    val = rng.rand(e)
    r, c, v = sym_normalize_coo(row, col, val, n)
    g = SparseGraph.from_coo(r, c, v, n, pad_to_multiple=8192)
    x = rng.randn(n, args.f).astype(np.float32)
    n_edges = g.n_edges

    def timeit(fn, *fargs, iters=10):
        out = fn(*fargs)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*fargs)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / iters

    dt1 = timeit(lambda a: spmm(g, a), jnp.asarray(x))
    base = n_edges / dt1
    print(json.dumps({"shards": 1, "path": "single", "ms": dt1 * 1e3,
                      "edges_per_s": base, "efficiency": 1.0}))

    n_dev = len(jax.devices())
    for shards in (2, 4, 8):
        if shards > n_dev:
            break
        mesh = make_mesh(shards)
        pg = partition_rows(g, shards)
        hg = partition_rows_halo(g, shards)
        xp = jnp.asarray(pad_features(x, pg.n_pad))
        for path, fn in (
            ("allgather", lambda a: spmm_sharded(pg, a, mesh)),
            ("halo", lambda a: spmm_halo(hg, a, mesh)),
        ):
            dt = timeit(fn, xp)
            eps = n_edges / dt
            print(
                json.dumps(
                    {
                        "shards": shards,
                        "path": path,
                        "ms": dt * 1e3,
                        "edges_per_s": eps,
                        "efficiency": eps / (base * shards),
                    }
                )
            )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
