"""YAML-driven experiment orchestrator.

Replaces the reference's subprocess-chaining ``run_experiment.py``
(reference run_experiment.py:24-164) with a **single-process** pipeline —
build → train → inspect share in-memory artifacts and one JAX runtime, with
per-stage logs and the config copied into the experiment directory.

YAML schema (same shape as the reference's experiments/r8.yaml:1-18):

  dataset: R8
  build:
    num_topics: 50
    doc_topic_threshold: 0.02
    topic_topic_threshold: 0.3
    min_df: 2
    max_df: 0.95
    use_word2vec: true
  train:
    times: 1
    shards: 8          # optional: sharded training over an 8-device mesh
    partition: halo    # halo (ppermute ring) | allgather
  inspect:
    top_n_words: 10
    top_n_docs: 5
    heatmap: true
"""
from __future__ import annotations

import os
import shutil
import sys
import time
from contextlib import contextmanager
from typing import Any, Dict

import yaml


@contextmanager
def _stage_log(log_dir: str, stage: str):
    """Tee stdout to a per-stage log (reference run_command's streaming)."""
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{stage}.log")
    f = open(path, "w", encoding="utf-8")
    orig = sys.stdout

    class Tee:
        def write(self, s):
            orig.write(s)
            f.write(s)

        def flush(self):
            orig.flush()
            f.flush()

    sys.stdout = Tee()
    t0 = time.time()
    try:
        yield
    finally:
        sys.stdout = orig
        f.write(f"\n[stage {stage} took {time.time() - t0:.1f}s]\n")
        f.close()


def load_config(path: str) -> Dict[str, Any]:
    with open(path, encoding="utf-8") as f:
        return yaml.safe_load(f)


def run_experiment_config(config_path: str) -> int:
    from textgcn.utils.compile_cache import enable_compile_cache
    from textgcn.utils.config import ExperimentConfig
    from textgcn.utils.profiling import StageTimer

    enable_compile_cache()
    timer = StageTimer()
    # typed, validated config: unknown keys fail loud BEFORE any stage runs
    # (the reference silently forwards whatever the YAML holds,
    # run_experiment.py:49-78)
    cfg = ExperimentConfig.from_yaml(config_path)
    dataset = cfg.dataset
    family = cfg.graph  # "topic" (TopicGCN) | "docword" (classic TextGCN)
    exp_dir = os.path.join(
        "experiments", dataset if family == "topic" else f"{dataset}_{family}"
    )
    log_dir = os.path.join(exp_dir, "logs")
    res_dir = os.path.join(exp_dir, "results")
    os.makedirs(res_dir, exist_ok=True)
    shutil.copy(config_path, os.path.join(exp_dir, "config_used.yaml"))

    data_root = cfg.data_root

    with _stage_log(log_dir, "build"), timer.stage("build"):
        if family == "docword":
            from textgcn.graph.build_textgcn import TextGCNGraphBuilder

            builder = TextGCNGraphBuilder(
                dataset,
                window_size=cfg.build.window,
                data_root=data_root,
            )
            builder.build()
            builder.save()
        else:
            from textgcn.graph.build_topic import TopicGraphBuilder

            builder = TopicGraphBuilder(
                dataset,
                num_topics=cfg.build.num_topics,
                doc_topic_threshold=cfg.build.doc_topic_threshold,
                topic_topic_threshold=cfg.build.topic_topic_threshold,
                min_df=cfg.build.min_df,
                max_df=cfg.build.max_df,
                use_word2vec=cfg.build.use_word2vec,
                lda_backend=cfg.build.lda_backend,
                lda_max_iter=cfg.build.lda_max_iter,
                data_root=data_root,
            )
            builder.build()
            builder.save()

    with _stage_log(log_dir, "train"), timer.stage("train"):
        from textgcn.train.run import run_experiment

        tc = cfg.train.to_train_config()
        pre = None
        if family == "docword":
            from textgcn.train.prepare import prepare_docword_data

            pre = prepare_docword_data(dataset, data_root=data_root)
        summary = run_experiment(
            dataset,
            times=cfg.train.times,
            graph_family=family,
            data_root=data_root,
            output_dir=res_dir,
            config=tc,
            pre_data=pre,
            n_shards=cfg.train.shards,
            partition=cfg.train.partition,
        )
        acc = summary["test_accuracy"]
        print(f"test accuracy: mean={acc['mean']:.4f} max={acc['max']:.4f}")

    # topic inspection only applies to the topic family
    if cfg.inspect.enabled and family == "topic":
        with _stage_log(log_dir, "inspect"), timer.stage("inspect"):
            from textgcn.inspect.topics import inspect_topics

            inspect_topics(
                dataset,
                data_root=data_root,
                top_n_words=cfg.inspect.top_n_words,
                top_n_docs=cfg.inspect.top_n_docs,
                heatmap=cfg.inspect.heatmap,
                output_dir=res_dir,
            )

    # per-stage wall-clock report (replaces the reference's ad-hoc time()
    # prints, SURVEY.md §5) — printed and kept with the experiment logs
    report = timer.report()
    print(report)
    with open(
        os.path.join(log_dir, "stage_times.txt"), "w", encoding="utf-8"
    ) as f:
        f.write(report + "\n")
    return 0
