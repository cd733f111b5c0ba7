"""Multi-seed training runner + human/machine reports.

Capability parity with the reference's ``main``/report writer
(reference trainer.py:409-593): prepares data once, trains ``times`` seeds
(random seeds from range(0, 100000), reference utils.py:179-182), aggregates
mean/max/min over accuracy and macro-F1, and writes
``{ds}_topic_training_results.txt`` (human) and ``.json`` (machine, with full
per-epoch histories and hyperparameters).
"""
from __future__ import annotations

import dataclasses
import json
import os
import random
import time
from typing import Any, Dict, List, Optional

import numpy as np

from textgcn.train.prepare import PreparedData, prepare_topic_data
from textgcn.train.trainer import TrainConfig, Trainer


def generate_seeds(nums: int, master_seed: Optional[int] = None) -> List[int]:
    rng = random.Random(master_seed)
    return rng.sample(range(0, 100000), nums)


def aggregate(values: List[float]) -> Dict[str, float]:
    return {
        "mean": float(np.mean(values)),
        "max": float(np.max(values)),
        "min": float(np.min(values)),
    }


def _prepare_for_training(
    dataset: str,
    graph_family: str,
    data_root: str,
    config: TrainConfig,
    pre_data: Optional[PreparedData],
    n_shards: Optional[int],
) -> PreparedData:
    """Shared validation + data-prep pipeline for :func:`run_experiment`
    AND :func:`resume_training` (one copy, so the resume path cannot drift
    from the fresh-run path: same sharded-model/spmm/GAT gates, same
    format application, same sgc_pre precompute)."""
    model = getattr(config, "model", "gcn")
    if n_shards is not None:
        from textgcn.parallel.trainer import SHARDED_MODELS

        if model not in SHARDED_MODELS:
            raise ValueError(
                "sharded training supports the "
                f"{', '.join(sorted(SHARDED_MODELS))} families (sgc_pre's "
                "precompute removes the graph from training — use --model "
                "sgc with --shards)"
            )
        if config.spmm not in ("auto", "segment"):
            raise ValueError(
                "with --shards, each shard aggregates its rows with the "
                "segment SpMM: pass --spmm auto or segment"
            )
    if pre_data is None:
        if graph_family == "docword":
            from textgcn.train.prepare import prepare_docword_data

            pre_data = prepare_docword_data(dataset, data_root=data_root)
        else:
            pre_data = prepare_topic_data(dataset, data_root=data_root)
    from textgcn.train.prepare import (
        apply_dense_attention_format,
        apply_spmm_format,
    )

    if n_shards is None:
        if model == "gat":
            if config.spmm == "streamed":
                raise ValueError("GAT has no streamed form")
            # auto keeps GAT on the segment COO: the dense log-adjacency
            # (models/gat.py DenseAttentionGraph) trained slower on every
            # text graph measured on the H100, R8 topic included
            if config.spmm == "dense":
                pre_data = apply_dense_attention_format(pre_data)
        else:
            pre_data = apply_spmm_format(pre_data, config.spmm)
        from textgcn.graph.structs import StreamedGraph

        if isinstance(pre_data.graph, StreamedGraph):
            raise ValueError(
                f"{dataset}'s graph does not fit the device's resident "
                "budget, and the Trainer trains resident graphs only; "
                "beyond-memory training runs through textgcn.train.streamed"
            )
    if model == "sgc_pre":
        # precompute stage: hoist Â^K X out of training entirely — the
        # compiled train step that follows contains no sparse op at all
        # (models/sgc.py sgc_precompute)
        from textgcn.models.sgc import sgc_precompute

        if pre_data.features is None:
            raise ValueError(
                "sgc_pre needs dense node features to precompute Â^K X; "
                "identity-feature (docword) graphs have none — use --model "
                "sgc instead"
            )
        pre_data = dataclasses.replace(
            pre_data,
            features=np.asarray(
                sgc_precompute(pre_data.graph, pre_data.features)
            ),
        )
    return pre_data


def _make_trainer(
    pre_data: PreparedData,
    cfg: TrainConfig,
    n_shards: Optional[int],
    partition: str,
):
    """Construct the (Sharded)Trainer — the one construction site shared by
    fresh runs and resumes."""
    if n_shards is not None:
        from textgcn.parallel.trainer import ShardedTrainer

        return ShardedTrainer(
            pre_data.graph,
            pre_data.features,
            pre_data.labels.target,
            pre_data.labels.train_idx,
            pre_data.labels.test_idx,
            pre_data.labels.n_classes,
            config=cfg,
            n_shards=n_shards,
            partition=partition,
        )
    return Trainer(
        pre_data.graph,
        pre_data.features,
        pre_data.labels.target,
        pre_data.labels.train_idx,
        pre_data.labels.test_idx,
        pre_data.labels.n_classes,
        config=cfg,
    )


def run_experiment(
    dataset: str,
    times: int = 1,
    graph_family: str = "topic",
    data_root: str = "data",
    output_dir: str = "results",
    config: TrainConfig = TrainConfig(),
    seeds: Optional[List[int]] = None,
    pre_data: Optional[PreparedData] = None,
    verbose: bool = True,
    save_model: Optional[str] = None,
    save_state: Optional[str] = None,
    n_shards: Optional[int] = None,
    partition: str = "halo",
) -> Dict[str, Any]:
    """Train `times` seeds on `dataset`; write reports; return summary.

    ``save_model``: optional checkpoint directory — the best-accuracy run's
    parameters are saved there via Orbax (the reference's checkpoint path is
    dead code, reference utils.py:244,254 — here it is a working CLI flag).

    ``save_state``: optional RESUMABLE checkpoint directory — the best run's
    full training state (params + Adam moments + epoch/early-stop counters),
    restorable with ``resume_training`` / ``cli train --resume``.

    ``n_shards``: when set, each seed trains on an ``n_shards``-device 1-D
    mesh via :class:`textgcn.parallel.trainer.ShardedTrainer` (row-
    partitioned Â and features, ``partition`` = "halo" ppermute ring or
    "allgather"), with identical train/val/early-stop/test semantics.
    """
    pre_data = _prepare_for_training(
        dataset, graph_family, data_root, config, pre_data, n_shards
    )
    seeds = seeds or generate_seeds(times)

    best_acc = -1.0
    best_trainer = None
    runs: List[Dict[str, Any]] = []
    for i, seed in enumerate(seeds):
        cfg = dataclasses.replace(config, seed=seed)
        trainer = _make_trainer(pre_data, cfg, n_shards, partition)
        trainer.fit(verbose=verbose)
        test_desc = trainer.test()
        if verbose:
            print(f"[run {i + 1}/{len(seeds)} seed={seed}] {test_desc}")
        if test_desc["acc"] > best_acc:
            best_acc = test_desc["acc"]
            best_trainer = trainer
        runs.append(
            {
                "seed": seed,
                "test": test_desc,
                "epochs_run": len(trainer.history),
                "history": trainer.history,
            }
        )

    accs = [r["test"]["acc"] for r in runs]
    f1s = [r["test"]["macro_f1"] for r in runs]
    from textgcn.utils.profiling import device_memory_stats

    import jax

    dev = jax.devices()[0]
    summary = {
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
        "device_memory": device_memory_stats(),
        "dataset": dataset,
        "graph_family": graph_family,
        "times": len(seeds),
        "hyperparameters": dataclasses.asdict(config),
        "test_accuracy": aggregate(accs),
        "test_macro_f1": aggregate(f1s),
        "model_param": runs[0]["test"]["model_param"],
        "train_time": aggregate([r["test"]["train_time"] for r in runs]),
        "runs": runs,
        "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
    }
    if n_shards is not None:
        summary["sharding"] = {
            "n_shards": n_shards,
            "partition": partition,
        }
    if save_model:
        path = best_trainer.save(save_model)
        summary["checkpoint"] = path
        if verbose:
            print(f"saved best-run checkpoint (acc={best_acc:.4f}) to {path}")
    if save_state:
        path = best_trainer.save_training_state(save_state)
        summary["resumable_checkpoint"] = path
        if verbose:
            print(f"saved resumable training state to {path}")
    write_reports(summary, output_dir)
    return summary


def resume_training(
    dataset: str,
    resume_dir: str,
    graph_family: str = "topic",
    data_root: str = "data",
    output_dir: str = "results",
    config: TrainConfig = TrainConfig(),
    pre_data: Optional[PreparedData] = None,
    verbose: bool = True,
    save_model: Optional[str] = None,
    save_state: Optional[str] = None,
    n_shards: Optional[int] = None,
    partition: str = "halo",
) -> Dict[str, Any]:
    """Continue an interrupted single-seed run from a resumable checkpoint
    (written by ``save_training_state`` / ``cli train --save_state``).

    The seed is read from the checkpoint so the dropout-key stream and
    train/val split continue identically; the resumed trajectory is
    bit-identical to an uninterrupted run (test-pinned in
    tests/test_checkpoint.py). Data prep, validation, and trainer
    construction go through the same :func:`_prepare_for_training` /
    :func:`_make_trainer` as :func:`run_experiment` — the spmm format
    and sgc_pre precompute a run was trained with apply identically on
    resume.

    ``save_model`` saves an eval (params-only) checkpoint of the resumed
    run; ``save_state`` saves a new resumable state (as in
    :func:`run_experiment`). With ``n_shards``, training resumes on an
    ``n_shards``-device mesh — the checkpoint is mesh-independent
    (host-gathered numpy), so a single-device run can resume sharded and
    vice versa.
    """
    from textgcn.train.checkpoint import restore_checkpoint

    saved_seed = int(restore_checkpoint(resume_dir)["metadata"]["seed"])
    config = dataclasses.replace(config, seed=saved_seed)
    pre_data = _prepare_for_training(
        dataset, graph_family, data_root, config, pre_data, n_shards
    )
    trainer = _make_trainer(pre_data, config, n_shards, partition)
    trainer.fit(verbose=verbose, resume_from=resume_dir)
    test_desc = trainer.test()
    if verbose:
        print(f"[resumed seed={saved_seed}] {test_desc}")
    summary = {
        "dataset": dataset,
        "graph_family": graph_family,
        "times": 1,
        "resumed_from": resume_dir,
        "hyperparameters": dataclasses.asdict(config),
        "test_accuracy": aggregate([test_desc["acc"]]),
        "test_macro_f1": aggregate([test_desc["macro_f1"]]),
        "model_param": test_desc["model_param"],
        "train_time": aggregate([test_desc["train_time"]]),
        "runs": [
            {
                "seed": saved_seed,
                "test": test_desc,
                "epochs_run": len(trainer.history),
                "history": trainer.history,
            }
        ],
        "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
    }
    if save_model:
        summary["checkpoint"] = trainer.save(save_model)
    if save_state:
        summary["resumable_checkpoint"] = trainer.save_training_state(
            save_state
        )
    write_reports(summary, output_dir)
    return summary


def evaluate_checkpoint(
    dataset: str,
    checkpoint_path: str,
    graph_family: str = "topic",
    data_root: str = "data",
    pre_data: Optional[PreparedData] = None,
    spmm: str = "auto",
    model: str = "gcn",
) -> Dict[str, float]:
    """Restore params from an Orbax checkpoint and evaluate on the test split
    (the ``--load_model`` CLI path)."""
    from textgcn.train.prepare import apply_spmm_format
    from textgcn.train.trainer import Trainer

    if pre_data is None:
        if graph_family == "docword":
            from textgcn.train.prepare import prepare_docword_data

            pre_data = prepare_docword_data(dataset, data_root=data_root)
        else:
            pre_data = prepare_topic_data(dataset, data_root=data_root)
    if model != "gat":
        pre_data = apply_spmm_format(pre_data, spmm)
    if model == "sgc_pre":
        import dataclasses as _dc

        import numpy as _np

        from textgcn.models.sgc import sgc_precompute

        pre_data = _dc.replace(
            pre_data,
            features=_np.asarray(
                sgc_precompute(pre_data.graph, pre_data.features)
            ),
        )
    trainer = Trainer(
        pre_data.graph,
        pre_data.features,
        pre_data.labels.target,
        pre_data.labels.train_idx,
        pre_data.labels.test_idx,
        pre_data.labels.n_classes,
        config=TrainConfig(model=model),
    )
    trainer.load(checkpoint_path)
    return trainer.evaluate(trainer.test_idx, prefix="test")


def write_reports(summary: Dict[str, Any], output_dir: str) -> None:
    os.makedirs(output_dir, exist_ok=True)
    ds = summary["dataset"]
    fam = summary.get("graph_family", "topic")
    json_path = os.path.join(output_dir, f"{ds}_{fam}_training_results.json")
    with open(json_path, "w", encoding="utf-8") as f:
        json.dump(summary, f, indent=2)

    txt_path = os.path.join(output_dir, f"{ds}_{fam}_training_results.txt")
    with open(txt_path, "w", encoding="utf-8") as f:
        f.write(f"{fam} GCN training results — {ds}\n")
        f.write("=" * 60 + "\n")
        f.write(f"generated: {summary['timestamp']}\n")
        f.write(f"runs: {summary['times']}\n\n")
        f.write("Hyperparameters:\n")
        for k, v in summary["hyperparameters"].items():
            f.write(f"  {k}: {v}\n")
        f.write(f"\nModel parameters: {summary['model_param']}\n\n")
        for metric in ("test_accuracy", "test_macro_f1"):
            agg = summary[metric]
            f.write(
                f"{metric}: mean={agg['mean']:.4f} "
                f"max={agg['max']:.4f} min={agg['min']:.4f}\n"
            )
        f.write("\nPer-run results:\n")
        for r in summary["runs"]:
            t = r["test"]
            f.write(
                f"  seed={r['seed']} acc={t['acc']:.4f} "
                f"macro_f1={t['macro_f1']:.4f} epochs={r['epochs_run']} "
                f"train_time={t['train_time']:.1f}s\n"
            )
