"""Run THE REFERENCE's trainer on repo-built topic artifacts (torch CPU).

Settles VERDICT r1 item 6: is mr TopicGCN ≈57.6% (benchmarks/RESULTS.md) a
parity bug in this framework or inherent to the model? We execute
``/root/reference``'s own ``PrepareData`` + ``TopicGCNTrainer``
(reference trainer.py:74-406) unmodified on the SAME artifacts
(``data/graph/{ds}_topic.txt`` + θ/embeddings from our topic model) and
compare its accuracy with ours.

θ-source note (same device as tests/test_golden_reference.py): the
reference re-infers θ through its pickled sklearn LDA at train time
(trainer.py:179); our artifact stores a JAX LDA, so the pickle handed to
the reference wraps the SAME θ our pipeline computes, via a duck-typed
``lda_model.transform``. Both trainers therefore see identical inputs.

Usage:
  PYTHONPATH=. python benchmarks/reference_crosscheck.py --dataset mr --times 3
Writes the reference's report files under results/reference_crosscheck/.
"""
from __future__ import annotations

import argparse
import os
import pickle
import sys
import tempfile
import types

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = "/root/reference"
sys.path.insert(0, REPO)


class _ThetaOracle:
    def __init__(self, theta):
        self.theta = np.asarray(theta)

    def transform(self, dtm):
        return self.theta


class _NoopVectorizer:
    def transform(self, docs):
        return None


def _compat_shims():
    """Environment-compat shims so the unmodified reference runs here:
    NumPy 2 removed ``np.Inf`` (reference utils.py:234 uses it)."""
    np.Inf = np.inf  # noqa: NPY201 — restoring the pre-2.0 alias
    _stub_prettytable()


def _stub_prettytable():
    if "prettytable" in sys.modules:
        return
    mod = types.ModuleType("prettytable")

    class PrettyTable:
        def __init__(self, *a, **k):
            self.field_names = []

        def add_row(self, row):
            pass

        def __str__(self):
            return "<table>"

    mod.PrettyTable = PrettyTable
    sys.modules["prettytable"] = mod


def stage_workdir(dataset: str, work: str) -> None:
    """Build the data/ layout the reference hardcodes, with a θ-shim pickle."""
    from textgcn.topics.model import TopicModel, load_documents_from_file

    data_root = os.path.join(REPO, "data")
    os.makedirs(os.path.join(work, "data", "graph"), exist_ok=True)
    os.makedirs(os.path.join(work, "data", "text_dataset"), exist_ok=True)
    os.symlink(
        os.path.join(data_root, "graph", f"{dataset}_topic.txt"),
        os.path.join(work, "data", "graph", f"{dataset}_topic.txt"),
    )
    os.symlink(
        os.path.join(data_root, "text_dataset", f"{dataset}.txt"),
        os.path.join(work, "data", "text_dataset", f"{dataset}.txt"),
    )
    os.symlink(
        os.path.join(data_root, "text_dataset", "clean_corpus"),
        os.path.join(work, "data", "text_dataset", "clean_corpus"),
    )

    tm = TopicModel(num_topics=50)
    tm.load(os.path.join(data_root, "graph", f"{dataset}_topic_model.pkl"))
    docs = load_documents_from_file(
        os.path.join(data_root, "text_dataset", "clean_corpus", f"{dataset}.txt")
    )
    theta = tm.get_document_topic_distribution(docs)
    if tm.topic_embeddings is None:
        tm.get_topic_embeddings(top_n=20)
    with open(
        os.path.join(work, "data", "graph", f"{dataset}_topic_model.pkl"), "wb"
    ) as f:
        pickle.dump(
            {
                "lda_model": _ThetaOracle(theta),
                "vectorizer": _NoopVectorizer(),
                "vocabulary_": {
                    str(w): i for i, w in enumerate(tm.vocabulary_)
                },
                "topic_word_distribution": tm.topic_word_distribution,
                "topic_embeddings": tm.topic_embeddings,
                "num_topics": tm.num_topics,
                "word2vec_model": None,
            },
            f,
        )


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="mr")
    ap.add_argument("--times", type=int, default=3)
    ap.add_argument(
        "--output_dir",
        default=os.path.join(REPO, "results", "reference_crosscheck"),
    )
    args = ap.parse_args()

    work = tempfile.mkdtemp(prefix="refxcheck_")
    stage_workdir(args.dataset, work)
    _compat_shims()
    sys.path.insert(0, REF)
    os.makedirs(args.output_dir, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        import importlib

        ref_trainer = importlib.import_module("trainer")
        ref_trainer.main(
            args.dataset, args.times, output_dir=args.output_dir
        )
    finally:
        os.chdir(cwd)
    print(
        f"\nreference trainer done; reports in {args.output_dir}/"
        f"{args.dataset}_topic_training_results.txt"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
