"""Smoke run of the training path on the GPU.

    python chip_smoke.py             # one card: every single-card phase
    python chip_smoke.py --chips 4   # four cards: the sharded phases only

Drives the system through the entry points a user calls (``run_experiment``,
``Trainer``, ``convert_graph``, ``ShardedTrainer``, the streamed step
factories) at the widths of the repository's text graphs, checks every
result against a plain reference, and prints as its last line

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Every phase that fails raises; nothing is caught. With no GPU (every JAX
device must be one) the script exits non-zero before printing a result.
The R8 topic GCN run's report goes to ``results/chip_smoke/``.

Precision: the trainer keeps JAX's default matmul precision, which on this
card runs float32 matmuls in TF32 (about three decimal digits); the
references that decide a tolerance set ``jax.default_matmul_precision
("highest")``. Each tolerance below names the precision it assumes.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "results", "chip_smoke")
# 10M nodes / 500M symmetric edges / F=128: the README's scale configuration
SCALE = dict(n=10_000_000, deg=25, f=128, hidden=16, classes=8,
             chunk=4_000_000)


def log(msg: str) -> None:
    print(msg, flush=True)


def device_check(want: int):
    """Every device is a GPU and there are ``want`` of them; print what
    the card and the software are."""
    import jax

    devs = jax.devices()
    if any(d.platform != "gpu" for d in devs) or len(devs) < want:
        sys.exit(
            f"chip_smoke needs {want} GPU(s); JAX sees {devs}. "
            "No CPU fallback."
        )
    smi = shutil.which("nvidia-smi")
    if smi is None:
        sys.exit("nvidia-smi not found")
    q = subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    for line in q.stdout.strip().splitlines():
        log(line.strip())
    from textgcn.utils.compile_cache import enable_compile_cache

    log(f"jax {jax.__version__}; devices {[d.device_kind for d in devs]}")
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS')!r}; "
        f"compile cache {enable_compile_cache()}")
    return devs


def epoch_seconds(trainer) -> float:
    """Steady-state seconds per epoch: a second fit of a fitted trainer,
    which reuses its compiled epoch block, so no compilation is timed."""
    done = len(trainer.history)
    trainer.fit(verbose=False)
    return trainer.train_time / (len(trainer.history) - done)


def phase_r8_topic_gcn(min_acc: float = 0.935) -> None:
    """The flagship: R8 topic GCN with the default TrainConfig (hidden 200,
    200-epoch budget with early stopping), seed 7, spmm auto."""
    from textgcn.graph.format import choose_format
    from textgcn.train.prepare import prepare_topic_data
    from textgcn.train.run import run_experiment
    from textgcn.train.trainer import TrainConfig, Trainer

    pre = prepare_topic_data("R8", data_root=os.path.join(REPO, "data"))
    fmt = choose_format(pre.graph)
    cfg = TrainConfig()
    summary = run_experiment(
        "R8", seeds=[7], pre_data=pre, config=cfg, verbose=False,
        output_dir=OUT, data_root=os.path.join(REPO, "data"),
    )
    acc = summary["test_accuracy"]["mean"]
    run = summary["runs"][0]
    from textgcn.train.prepare import apply_spmm_format

    p = apply_spmm_format(pre, "auto")
    t = Trainer(p.graph, p.features, p.labels.target, p.labels.train_idx,
                p.labels.test_idx, p.labels.n_classes,
                config=dataclasses.replace(cfg, seed=7))
    t.fit(verbose=False)
    spe = epoch_seconds(t)
    log(f"[R8 topic GCN] auto chose {fmt}; {run['epochs_run']} epochs; "
        f"steady {spe:.6f} s/epoch (compile excluded); "
        f"first fit {run['test']['train_time']:.3f} s incl. compile; "
        f"test acc {acc * 100:.2f}%")
    if not acc >= min_acc:
        raise AssertionError(f"R8 topic GCN acc {acc} < {min_acc}")


def phase_r8_docword_gcn(dataset: str = "R8", epochs: int = 8) -> None:
    """R8 doc-word GCN through auto, segment and dense: per-epoch train
    loss agreement and one Â @ X pass at F=200 against a float32 dense
    reference at ``highest`` precision."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from textgcn.graph.format import convert_graph
    from textgcn.graph.structs import DenseGraph
    from textgcn.ops.spmm import spmm
    from textgcn.train.prepare import apply_spmm_format, prepare_docword_data
    from textgcn.train.trainer import TrainConfig, Trainer

    pre = prepare_docword_data(dataset, data_root=os.path.join(REPO, "data"))
    g = pre.graph
    cfg = TrainConfig(max_epoch=epochs, early_stopping=10 * epochs,
                      epoch_block=epochs, seed=7)
    losses = {}
    for fmt in ("auto", "segment", "dense"):
        p = apply_spmm_format(pre, fmt)
        t = Trainer(p.graph, p.features, p.labels.target,
                    p.labels.train_idx, p.labels.test_idx,
                    p.labels.n_classes, config=cfg)
        t.fit(verbose=False)
        losses[fmt] = np.array([h["train_loss"] for h in t.history])
        log(f"[{dataset} doc-word GCN] {fmt} ({type(p.graph).__name__}): "
            f"{epoch_seconds(t):.6f} s/epoch; train loss "
            f"{losses[fmt][0]:.6f} -> {losses[fmt][-1]:.6f}")
    # auto resolves to one of the two formats: same arithmetic up to the
    # order of float32 atomic adds (segment) -> 1e-4 relative
    ref_fmt = "dense" if isinstance(
        convert_graph(g, "auto"), DenseGraph) else "segment"
    np.testing.assert_allclose(losses["auto"], losses[ref_fmt], rtol=1e-4)
    # dense aggregates in a TF32 GEMM, segment in float32 adds: the loss
    # trajectories agree to 1e-2 relative over the epochs run
    np.testing.assert_allclose(losses["dense"], losses["segment"], rtol=1e-2)
    log(f"[{dataset} doc-word GCN] loss per epoch: auto==segment within "
        f"1e-4 (max rel "
        f"{np.max(np.abs(losses['auto'] / losses[ref_fmt] - 1)):.2e}); "
        f"dense vs segment within 1e-2 (max rel "
        f"{np.max(np.abs(losses['dense'] / losses['segment'] - 1)):.2e})")

    x = jax.random.normal(jax.random.PRNGKey(0), (g.n_nodes, 200),
                          jnp.float32)
    dg = DenseGraph.from_sparse_graph(g)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jnp.dot(dg.a, x))
    scale = float(np.max(np.abs(ref)))
    for fmt, graph, tol in (
        # float32 gather and atomic scatter-add: order of adds only
        ("segment", g, 1e-5),
        # JAX's default precision: the GEMM runs in TF32
        ("dense", dg, 1e-2),
    ):
        got = np.asarray(spmm(graph, x))
        err = float(np.max(np.abs(got - ref))) / scale
        log(f"[{dataset} doc-word A@X F=200] {fmt}: max |err| / max |ref| "
            f"= {err:.2e} (limit {tol:g})")
        if not err <= tol:
            raise AssertionError(f"{fmt} A@X error {err} > {tol}")


def phase_r8_topic_gat(epochs: int = 5) -> None:
    """R8 topic GAT: auto (the segment COO) against the dense
    log-adjacency, first-epoch loss parity."""
    import numpy as np

    from textgcn.train.prepare import prepare_topic_data
    from textgcn.train.run import _make_trainer, _prepare_for_training
    from textgcn.train.trainer import TrainConfig

    data = os.path.join(REPO, "data")
    pre = prepare_topic_data("R8", data_root=data)
    first = {}
    for spmm in ("auto", "dense"):
        cfg = TrainConfig(model="gat", spmm=spmm, max_epoch=epochs,
                          epoch_block=epochs, early_stopping=10 * epochs,
                          seed=7)
        p = _prepare_for_training("R8", "topic", data, cfg, pre, None)
        t = _make_trainer(p, cfg, None, "halo")
        t.fit(verbose=False)
        first[spmm] = t.history[0]["train_loss"]
        log(f"[R8 topic GAT] {spmm} ({type(p.graph).__name__}): "
            f"{epoch_seconds(t):.6f} s/epoch; first-epoch loss "
            f"{first[spmm]:.6f}")
    # the dense layout stores log(val) in bf16 and aggregates in a bf16
    # matmul: 2e-2 relative on the first-epoch loss
    np.testing.assert_allclose(first["dense"], first["auto"], rtol=2e-2)


def _gcn_masked_loss(params, graph, x, y, mask):
    import jax
    import jax.numpy as jnp

    from textgcn.models.gcn import gcn_forward

    logits = gcn_forward(params, graph, x, train=False)
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, y[:, None], axis=1)[:, 0]
    return jnp.sum(nll * mask) / jnp.sum(mask)


def _streamed_inputs(n, f, c):
    import jax
    import jax.numpy as jnp

    x = jax.jit(lambda k: jax.random.normal(k, (n, f), jnp.float32))(
        jax.random.PRNGKey(0))
    y = jax.jit(lambda k: jax.random.randint(k, (n,), 0, c, jnp.int32))(
        jax.random.PRNGKey(1))
    mask = jax.jit(
        lambda k: (jax.random.uniform(k, (n,)) < 0.5).astype(jnp.float32)
    )(jax.random.PRNGKey(2))
    return x, y, mask


def phase_streamed(scale=SCALE, parity_n: int = 20_000) -> None:
    """One streamed GCN train step through the plain XLA edge stream at
    the scale configuration, after a loss-parity check against the
    resident segment step at a size that fits resident."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, os.path.join(REPO, "benchmarks"))
    from synthetic_large import make_random_edge_fn

    from textgcn.graph.structs import SparseGraph
    from textgcn.train.streamed import (
        init_streamed,
        make_streamed_train_step_segmented,
        symmetrize_edge_fn,
    )

    f, h, c, chunk = scale["f"], scale["hidden"], scale["classes"], 65_536
    # parity: the same symmetrized stream, materialized as a resident COO
    n = parity_n
    n_dir = -(-n * scale["deg"] // chunk)
    edge_fn = symmetrize_edge_fn(make_random_edge_fn(n, chunk, seed=3),
                                 n_dir)
    parts = [tuple(np.asarray(a) for a in edge_fn(i))
             for i in range(2 * n_dir)]
    row, col, val = (np.concatenate(z) for z in zip(*parts))
    g = SparseGraph.from_coo(row, col, val, n)
    x, y, mask = _streamed_inputs(n, f, c)
    params, _, opt_state = init_streamed(jax.random.PRNGKey(3), f, h, c)
    with jax.default_matmul_precision("highest"):
        want = float(_gcn_masked_loss(params, g, x, y, mask))
    step = make_streamed_train_step_segmented(
        edge_fn, n, 2 * n_dir, chunks_per_dispatch=16,
        stream_dtype=jnp.float32,
    )
    with jax.default_matmul_precision("highest"):
        _, _, loss = step(params, opt_state, x, y, mask)
    got = float(loss)
    log(f"[streamed parity] n={n} e={len(row)} F={f}: streamed step loss "
        f"{got:.6f}, resident segment loss {want:.6f}")
    # both sides float32 at highest matmul precision: they differ in the
    # order of float32 adds only, 1e-4 relative
    np.testing.assert_allclose(got, want, rtol=1e-4)

    n = scale["n"]
    n_dir = -(-n * scale["deg"] // scale["chunk"])
    edge_fn = symmetrize_edge_fn(make_random_edge_fn(n, scale["chunk"]),
                                 n_dir)
    x, y, mask = _streamed_inputs(n, f, c)
    x = x.astype(jnp.bfloat16)
    params, _, opt_state = init_streamed(jax.random.PRNGKey(3), f, h, c)
    step = make_streamed_train_step_segmented(
        edge_fn, n, 2 * n_dir, chunks_per_dispatch=16)
    t0 = time.perf_counter()
    params, opt_state, loss = step(params, opt_state, x, y, mask)
    first = float(loss)
    t1 = time.perf_counter()
    params, opt_state, loss = step(params, opt_state, x, y, mask)
    second = float(loss)
    t2 = time.perf_counter()
    e = 2 * n_dir * scale["chunk"]
    log(f"[streamed scale] {n} nodes, {e} symmetric edges, F={f}: first "
        f"step {t1 - t0:.3f} s incl. compile, steady {t2 - t1:.3f} s/step; "
        f"loss {first:.6f} -> {second:.6f}")
    if not (np.isfinite(first) and np.isfinite(second)):
        raise AssertionError("streamed scale step loss is not finite")


def phase_sharded_r8(n_shards: int = 4, epochs: int = 30) -> None:
    """ShardedTrainer on R8 topic GCN, halo and allgather partitions,
    per epoch against the one-card Trainer (dropout off, so both draw
    no random masks)."""
    import numpy as np

    from textgcn.parallel.trainer import ShardedTrainer
    from textgcn.train.prepare import prepare_topic_data
    from textgcn.train.trainer import TrainConfig, Trainer

    pre = prepare_topic_data("R8", data_root=os.path.join(REPO, "data"))
    lab = pre.labels
    args = (pre.graph, pre.features, lab.target, lab.train_idx,
            lab.test_idx, lab.n_classes)
    cfg = TrainConfig(dropout=0.0, max_epoch=epochs,
                      early_stopping=10 * epochs, seed=7)
    single = Trainer(*args, config=cfg)
    single.fit(verbose=False)
    s_loss = np.array([h["train_loss"] for h in single.history])
    s_val = np.array([h["val_loss"] for h in single.history])
    s_acc = single.test()["acc"]
    log(f"[sharded R8 topic GCN] one card: {epoch_seconds(single):.6f} "
        f"s/epoch; test acc {s_acc * 100:.2f}%")
    for partition in ("halo", "allgather"):
        t = ShardedTrainer(*args, config=cfg, n_shards=n_shards,
                           partition=partition)
        t.fit(verbose=False)
        loss = np.array([h["train_loss"] for h in t.history])
        val = np.array([h["val_loss"] for h in t.history])
        acc = t.test()["acc"]
        err = max(np.max(np.abs(loss - s_loss)), np.max(np.abs(val - s_val)))
        log(f"[sharded R8 topic GCN] {partition} x{n_shards}: "
            f"{epoch_seconds(t):.6f} s/epoch; test acc "
            f"{acc * 100:.2f}%; max |loss diff| vs one card "
            f"over {len(loss)} epochs {err:.2e} (limit 2e-3)")
        # TF32 transforms tiled differently per shard, float32 sums in
        # another order: 2e-3 absolute on train and val loss
        if not (len(loss) == len(s_loss) and err <= 2e-3):
            raise AssertionError(f"{partition} diverges from one card")


def phase_streamed_ring(n_shards: int = 4, f: int = 200) -> None:
    """The unsorted streamed ppermute ring over R8 doc-word's halo
    buckets, against the one-card host-fed stream of the same graph; then
    one ring pass at the 10M-node scale configuration."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    sys.path.insert(0, REPO)
    import bench
    from textgcn.graph.structs import StreamedGraph
    from textgcn.ops.spmm import spmm
    from textgcn.parallel.halo import partition_rows_halo
    from textgcn.parallel.sharded import make_mesh
    from textgcn.parallel.streamed import halo_bucket_stream, \
        spmm_streamed_mesh
    from textgcn.train.prepare import prepare_docword_data

    g = prepare_docword_data("R8", data_root=os.path.join(REPO, "data")).graph
    e = g.n_edges
    mesh = make_mesh(n_shards)
    hg = partition_rows_halo(g, n_shards)
    h_fn, h_chunks, h_args = halo_bucket_stream(hg, chunk_e=1 << 16)
    h_args = tuple(
        jax.device_put(a, NamedSharding(mesh, P("nodes"))) for a in h_args)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (g.n_nodes, f)))
    xp = np.zeros((hg.n_pad, f), np.float32)
    xp[: g.n_nodes] = x
    xs = jax.device_put(xp, NamedSharding(mesh, P("nodes", None)))
    dims = (hg.rows_per_shard, n_shards, h_chunks)
    ring_pass = jax.jit(
        lambda v, a: spmm_streamed_mesh(h_fn, v, mesh, dims, a))
    ring = ring_pass(xs, h_args)
    ring.block_until_ready()
    t0 = time.perf_counter()
    ring = ring_pass(xs, h_args)
    ring.block_until_ready()
    t_ring = time.perf_counter() - t0
    sg = StreamedGraph.from_coo(np.asarray(g.row)[:e], np.asarray(g.col)[:e],
                                np.asarray(g.val)[:e], g.n_nodes)
    x1 = jax.device_put(jnp.asarray(x), jax.devices()[0])
    one = spmm(sg, x1)
    one.block_until_ready()
    t0 = time.perf_counter()
    one = spmm(sg, x1)
    one.block_until_ready()
    t_one = time.perf_counter() - t0
    got = np.asarray(ring)[: g.n_nodes]
    want = np.asarray(one)
    err = float(np.max(np.abs(got - want))) / float(np.max(np.abs(want)))
    log(f"[streamed ring] R8 doc-word {g.n_nodes} nodes / {e} edges F={f}: "
        f"ring x{n_shards} {t_ring:.6f} s/pass, one-card host-fed stream "
        f"{t_one:.6f} s/pass; max |diff| / max |one card| = {err:.2e} "
        f"(limit 1e-5)")
    # float32 gathers and atomic adds on both sides: order of adds only
    if not err <= 1e-5:
        raise AssertionError(f"streamed ring diverges: {err}")
    res = bench.streamed_mesh_scale_perf(n=SCALE["n"], deg=2 * SCALE["deg"],
                                         f=SCALE["f"])
    log(f"[streamed ring scale] {res['n_nodes']} nodes / {res['n_edges']} "
        f"edges F={res['f']} over {res['n_shards']} cards: "
        f"{res['full_pass_s']:.3f} s/pass")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-card sharded phases")
    args = ap.parse_args(argv)
    os.makedirs(OUT, exist_ok=True)
    devs = device_check(args.chips)
    t0 = time.perf_counter()
    if args.chips == 4:
        phases = (phase_sharded_r8, phase_streamed_ring)
    else:
        phases = (phase_r8_topic_gcn, phase_r8_docword_gcn,
                  phase_r8_topic_gat, phase_streamed)
    for phase in phases:
        t = time.perf_counter()
        phase()
        log(f"[phase {phase.__name__}] ok in {time.perf_counter() - t:.1f} s")
    log(f"[chip_smoke] all phases ok in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": devs[0].platform,
            "kind": devs[0].device_kind,
            "count": len(devs),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
