"""Command-line entry points.

Replaces the reference's per-script argparse CLIs (build_graph.py:235-265,
trainer.py:596-608, inspect_topics.py:361-397, run_experiment.py:130-164)
with one ``python -m textgcn.cli <command>`` multiplexer:

  clean        — clean a raw corpus into clean_corpus/{ds}.txt
  build-graph  — fit topic model, build + save the doc-topic-topic graph
  train        — train the GCN on a built graph, write reports
  inspect      — topic inspection report (top words/docs, similarity stats)
  experiment   — YAML-driven build → train → inspect, single process

The reference's data_processor.py:216-222 hardcodes its dataset despite the
README claiming a ``--dataset`` flag; ``clean`` here provides the real flag.
"""
from __future__ import annotations

import argparse
import sys


def _add_build_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dataset", required=True)
    p.add_argument("--num_topics", type=int, default=50)
    p.add_argument("--doc_topic_threshold", type=float, default=0.02)
    p.add_argument("--topic_topic_threshold", type=float, default=0.3)
    p.add_argument("--min_df", type=int, default=2)
    p.add_argument("--max_df", type=float, default=0.95)
    p.add_argument("--no_word2vec", action="store_true")
    p.add_argument("--lda_backend", default="jax", choices=["jax", "sklearn"])
    p.add_argument("--lda_max_iter", type=int, default=60)
    p.add_argument("--data_root", default="data")


def cmd_build_graph(args) -> int:
    from textgcn.graph.build_topic import TopicGraphBuilder

    b = TopicGraphBuilder(
        args.dataset,
        num_topics=args.num_topics,
        doc_topic_threshold=args.doc_topic_threshold,
        topic_topic_threshold=args.topic_topic_threshold,
        min_df=args.min_df,
        max_df=args.max_df,
        use_word2vec=not args.no_word2vec,
        lda_backend=args.lda_backend,
        lda_max_iter=args.lda_max_iter,
        data_root=args.data_root,
    )
    g = b.build()
    b.save()
    print(f"built {args.dataset}: {g.n_nodes} nodes, {g.n_edges} edges")
    return 0


def cmd_build_docword(args) -> int:
    from textgcn.graph.build_textgcn import TextGCNGraphBuilder

    b = TextGCNGraphBuilder(
        args.dataset, window_size=args.window, data_root=args.data_root
    )
    g = b.build()
    b.save()
    print(
        f"built {args.dataset} doc-word graph: {g.n_nodes} nodes "
        f"({g.num_docs} docs + {g.num_words} words), {len(g.src)} edges"
    )
    return 0


def cmd_train(args) -> int:
    from textgcn.train.run import run_experiment
    from textgcn.train.trainer import TrainConfig

    cfg = TrainConfig(
        n_hidden=args.nhid,
        lr=args.lr,
        dropout=args.dropout,
        max_epoch=args.max_epoch,
        early_stopping=args.early_stopping,
        val_ratio=args.val_ratio,
        epoch_block=args.epoch_block,
        spmm=args.spmm,
        model=args.model,
    )
    pre_data = None
    if args.graph == "docword":
        from textgcn.train.prepare import prepare_docword_data

        pre_data = prepare_docword_data(args.dataset, data_root=args.data_root)
    if args.resume:
        from textgcn.train.run import resume_training

        summary = resume_training(
            args.dataset,
            args.resume,
            graph_family=args.graph,
            data_root=args.data_root,
            output_dir=args.output_dir,
            config=cfg,
            pre_data=pre_data,
            verbose=not args.quiet,
            save_model=args.save_model,
            save_state=args.save_state,
            n_shards=args.shards,
            partition=args.partition,
        )
        acc = summary["test_accuracy"]["mean"]
        print(f"{args.dataset} (resumed): acc={acc:.4f}")
        return 0
    if args.load_model:
        from textgcn.train.run import evaluate_checkpoint

        out = evaluate_checkpoint(
            args.dataset,
            args.load_model,
            graph_family=args.graph,
            data_root=args.data_root,
            pre_data=pre_data,
            spmm=args.spmm,
            model=args.model,
        )
        print(
            f"{args.dataset} (checkpoint {args.load_model}): "
            f"acc={out['acc']:.4f} macro_f1={out['macro_f1']:.4f}"
        )
        return 0
    import contextlib

    trace_ctx = contextlib.nullcontext()
    if args.trace:
        from textgcn.utils.profiling import trace

        trace_ctx = trace(args.trace)
        print(f"writing jax.profiler trace to {args.trace}")
    with trace_ctx:
        summary = run_experiment(
            args.dataset,
            times=args.times,
            graph_family=args.graph,
            data_root=args.data_root,
            output_dir=args.output_dir,
            config=cfg,
            pre_data=pre_data,
            verbose=not args.quiet,
            save_model=args.save_model,
            save_state=args.save_state,
            n_shards=args.shards,
            partition=args.partition,
        )
    acc = summary["test_accuracy"]
    print(
        f"{args.dataset}: acc mean={acc['mean']:.4f} "
        f"max={acc['max']:.4f} min={acc['min']:.4f}"
    )
    return 0


def cmd_inspect(args) -> int:
    from textgcn.inspect.topics import inspect_topics

    inspect_topics(
        args.dataset,
        data_root=args.data_root,
        top_n_words=args.top_n_words,
        top_n_docs=args.top_n_docs,
        heatmap=not args.no_heatmap,
        output_dir=args.output_dir,
    )
    return 0


def cmd_clean(args) -> int:
    from textgcn.text.clean import CorpusProcess

    CorpusProcess(args.dataset, data_root=args.data_root)
    return 0


def cmd_experiment(args) -> int:
    from textgcn.runner import run_experiment_config

    return run_experiment_config(args.config)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="textgcn")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("clean", help="clean a raw corpus")
    p.add_argument("--dataset", required=True)
    p.add_argument("--data_root", default="data")
    p.set_defaults(fn=cmd_clean)

    p = sub.add_parser("build-graph", help="build topic graph artifacts")
    _add_build_args(p)
    p.set_defaults(fn=cmd_build_graph)

    p = sub.add_parser(
        "build-docword", help="build classic TextGCN doc-word graph"
    )
    p.add_argument("--dataset", required=True)
    p.add_argument("--window", type=int, default=20)
    p.add_argument("--data_root", default="data")
    p.set_defaults(fn=cmd_build_docword)

    p = sub.add_parser("train", help="train GCN on a built graph")
    p.add_argument("--dataset", required=True)
    p.add_argument(
        "--graph", default="topic", choices=["topic", "docword"],
        help="graph family: topic (TopicGCN) or docword (classic TextGCN)",
    )
    p.add_argument("--times", type=int, default=1)
    p.add_argument("--data_root", default="data")
    p.add_argument("--output_dir", default="results")
    p.add_argument("--nhid", type=int, default=200)
    p.add_argument("--lr", type=float, default=0.02)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--max_epoch", type=int, default=200)
    p.add_argument("--early_stopping", type=int, default=10)
    p.add_argument("--val_ratio", type=float, default=0.1)
    p.add_argument(
        "--epoch_block",
        type=int,
        default=10,
        help="epochs per compiled lax.scan block (1 = dispatch per epoch); "
        "results are bit-identical across block sizes, larger blocks "
        "amortize host->device dispatch",
    )
    p.add_argument(
        "--spmm",
        default="auto",
        choices=["auto", "segment", "dense"],
        help="graph format of the aggregation: segment (gather + atomic "
        "scatter-add over the COO), dense (one GEMM on the [N, N] table; "
        "for gat, the dense log-adjacency). auto picks from the graph's "
        "size and density and the device's memory and peaks "
        "(textgcn.graph.format.choose_format); gat's auto is segment.",
    )
    p.add_argument(
        "--save_model",
        default=None,
        help="directory to save the best run's Orbax checkpoint",
    )
    p.add_argument(
        "--load_model",
        default=None,
        help="restore an Orbax checkpoint and evaluate on the test split "
        "(skips training)",
    )
    p.add_argument(
        "--save_state",
        default=None,
        metavar="DIR",
        help="after training, save the best run's RESUMABLE state (params "
        "+ Adam moments + epoch/early-stop counters) to DIR",
    )
    p.add_argument(
        "--resume",
        default=None,
        metavar="DIR",
        help="continue an interrupted run from a --save_state checkpoint "
        "(seed and dropout-key stream are restored from it; the resumed "
        "trajectory is bit-identical to an uninterrupted run)",
    )
    p.add_argument(
        "--model",
        default="gcn",
        choices=["gcn", "gat", "sgc", "sgc_pre", "appnp", "sage", "gin",
                 "gcnii"],
        help="model family: gcn (fixed normalized adjacency), gat "
        "(per-edge attention via weighted softmax), sgc (linear A^2XW "
        "classifier), sgc_pre (SGC with A^2X hoisted out of training — the "
        "compiled step is gather-free; topic graphs only), appnp "
        "(MLP + 10-step personalized-PageRank propagation), sage "
        "(GraphSAGE mean aggregator: separate self/neighbor transforms), "
        "gin ((1+eps)·h + Âh through a 2-layer MLP, learnable eps), gcnii "
        "(deep GCN with initial residual and identity mapping)",
    )
    p.add_argument(
        "--shards",
        type=int,
        default=None,
        metavar="N",
        help="train sharded over an N-device 1-D mesh (row-partitioned "
        "adjacency + features under shard_map; full train/val/early-stop/"
        "test semantics on the mesh). Requires N visible devices.",
    )
    p.add_argument(
        "--partition",
        default="halo",
        choices=["halo", "allgather"],
        help="sharded aggregation layout: halo = ppermute feature ring, "
        "O(N/P) memory per device (the scaling path); allgather = replicate "
        "features per step, fewer hops on small graphs",
    )
    p.add_argument("--quiet", action="store_true")
    p.add_argument(
        "--trace",
        default=None,
        metavar="DIR",
        help="emit a jax.profiler trace of the training run to DIR "
        "(view in TensorBoard / Perfetto)",
    )
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("inspect", help="topic inspection report")
    p.add_argument("--dataset", required=True)
    p.add_argument("--data_root", default="data")
    p.add_argument("--output_dir", default="results")
    p.add_argument("--top_n_words", type=int, default=10)
    p.add_argument("--top_n_docs", type=int, default=5)
    p.add_argument("--no_heatmap", action="store_true")
    p.set_defaults(fn=cmd_inspect)

    p = sub.add_parser("experiment", help="YAML-driven pipeline")
    p.add_argument("--config", required=True)
    p.set_defaults(fn=cmd_experiment)

    args = parser.parse_args(argv)
    from textgcn.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
