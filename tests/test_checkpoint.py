"""Orbax checkpoint round-trip + interrupted/resume training equivalence."""
import dataclasses

import jax
import numpy as np
import optax
import pytest

from textgcn.graph.structs import SparseGraph
from textgcn.models.gcn import gcn_init
from textgcn.train.checkpoint import restore_checkpoint, save_checkpoint
from textgcn.train.trainer import TrainConfig, Trainer


def _toy_problem(n=60, f=12, c=3, seed=0):
    """Small random symmetric graph + features + labels with signal."""
    rng = np.random.RandomState(seed)
    row = rng.randint(0, n, size=4 * n)
    col = rng.randint(0, n, size=4 * n)
    row, col = np.concatenate([row, col]), np.concatenate([col, row])
    val = np.ones_like(row, dtype=np.float64)
    from textgcn.graph.normalize import sym_normalize_coo

    r, c_, v = sym_normalize_coo(row, col, val, n)
    g = SparseGraph.from_coo(r, c_, v, n, pad_to_multiple=256)
    y = rng.randint(0, c, size=n)
    x = rng.randn(n, f).astype(np.float32) + np.eye(c)[y][:, :f % c + 1].sum(
        axis=1, keepdims=True
    )
    idx = rng.permutation(n)
    return g, x.astype(np.float32), y, idx[: n // 2], idx[n // 2:], c


def _fit(g, x, y, tr, te, c, max_epoch, resume_from=None, epoch_block=4):
    t = Trainer(
        g, x, y, tr, te, c,
        config=TrainConfig(
            n_hidden=8, max_epoch=max_epoch, epoch_block=epoch_block,
            early_stopping=1000, seed=7,
        ),
    )
    t.fit(verbose=False, resume_from=resume_from)
    return t


def test_resume_matches_uninterrupted(tmp_path):
    """10 epochs + save_training_state + resume to 20 == straight 20 epochs,
    bit-identically (same dropout-key stream, same Adam moments)."""
    g, x, y, tr, te, c = _toy_problem()

    full = _fit(g, x, y, tr, te, c, max_epoch=20)

    part = _fit(g, x, y, tr, te, c, max_epoch=10)
    ckpt = part.save_training_state(str(tmp_path / "state"))
    resumed = _fit(g, x, y, tr, te, c, max_epoch=20, resume_from=ckpt)

    for pa, pb in zip(
        jax.tree_util.tree_leaves(full.params),
        jax.tree_util.tree_leaves(resumed.params),
    ):
        np.testing.assert_array_equal(np.asarray(pa), np.asarray(pb))
    # epoch numbering continues across the boundary
    assert [h["epoch"] for h in part.history] == list(range(10))
    assert [h["epoch"] for h in resumed.history] == list(range(10, 20))
    # and the recorded losses line up with the uninterrupted run
    full_losses = [h["train_loss"] for h in full.history[10:]]
    res_losses = [h["train_loss"] for h in resumed.history]
    np.testing.assert_allclose(full_losses, res_losses, rtol=0, atol=0)


def test_resume_restores_early_stop_state(tmp_path):
    """Early-stop patience counters survive the save/resume boundary; a
    checkpoint from an already-stopped run refuses to resume."""
    g, x, y, tr, te, c = _toy_problem()
    t = Trainer(
        g, x, y, tr, te, c,
        config=TrainConfig(n_hidden=8, max_epoch=8, epoch_block=4, seed=7),
    )
    t.fit(verbose=False)
    ckpt = t.save_training_state(str(tmp_path / "s2"))
    st = restore_checkpoint(ckpt)
    assert int(st["metadata"]["epoch"]) == 8
    assert int(st["metadata"]["seed"]) == 7

    # forge a stopped checkpoint and check the refusal path
    t._stopped = True
    ckpt2 = t.save_training_state(str(tmp_path / "s3"))
    t2 = Trainer(
        g, x, y, tr, te, c,
        config=TrainConfig(n_hidden=8, max_epoch=16, seed=7),
    )
    with pytest.raises(ValueError, match="early-stopped"):
        t2.fit(verbose=False, resume_from=ckpt2)


def test_resume_training_api(tmp_path, monkeypatch):
    """The run-level resume entry point restores the seed from the
    checkpoint and writes a report."""
    import json
    import os

    from textgcn.train.prepare import PreparedData
    from textgcn.train.run import resume_training

    g, x, y, tr, te, c = _toy_problem()
    from textgcn.text.datasets import DatasetLabels

    labels = DatasetLabels(
        target=y, label_names=[str(i) for i in range(c)],
        train_idx=tr, test_idx=te,
    )
    pre = PreparedData(
        graph=g, features=x, labels=labels, n_feat=x.shape[1],
        num_docs=len(y), num_topics=0,
    )
    part = _fit(g, x, y, tr, te, c, max_epoch=6)
    ckpt = part.save_training_state(str(tmp_path / "s4"))
    monkeypatch.chdir(tmp_path)
    summary = resume_training(
        "toy", ckpt,
        config=TrainConfig(n_hidden=8, max_epoch=12, epoch_block=4,
                           early_stopping=1000),
        pre_data=pre, verbose=False, output_dir=str(tmp_path / "out"),
    )
    assert summary["resumed_from"] == ckpt
    assert summary["runs"][0]["seed"] == 7  # restored from checkpoint
    assert os.path.exists(
        os.path.join(tmp_path, "out", "toy_topic_training_results.json")
    )
    json.loads(
        open(
            os.path.join(tmp_path, "out", "toy_topic_training_results.json")
        ).read()
    )


def test_checkpoint_roundtrip(tmp_path):
    params = gcn_init(jax.random.PRNGKey(0), 10, 8, 3)
    opt = optax.adam(1e-2)
    opt_state = opt.init(params)
    path = save_checkpoint(
        str(tmp_path / "ckpt"), params, opt_state, metadata={"epoch": 7}
    )
    restored = restore_checkpoint(path)
    np.testing.assert_allclose(
        np.asarray(restored["params"]["gc1"]["w"]),
        np.asarray(params["gc1"]["w"]),
    )
    assert int(restored["metadata"]["epoch"]) == 7
    # structure of opt state preserved
    flat_a = jax.tree_util.tree_leaves(restored["opt_state"])
    flat_b = jax.tree_util.tree_leaves(opt_state)
    assert len(flat_a) == len(flat_b)


def test_save_training_state_under_restore_best(tmp_path):
    """restore_best=True snapshots best-epoch params into self.params, but
    the RESUMABLE state must pair the end-of-run params with the
    end-of-run Adam moments: resuming it (restore_best off) must match an
    uninterrupted run exactly."""
    g, x, y, tr, te, c = _toy_problem()
    cfg = TrainConfig(
        n_hidden=8, max_epoch=10, epoch_block=4, early_stopping=1000,
        seed=7, restore_best=True,
    )
    a = Trainer(g, x, y, tr, te, c, config=cfg)
    a.fit(verbose=False)
    ckpt = a.save_training_state(str(tmp_path / "rb"))

    resumed = _fit(g, x, y, tr, te, c, max_epoch=20, resume_from=ckpt)
    full = _fit(g, x, y, tr, te, c, max_epoch=20)
    for pa, pb in zip(
        jax.tree_util.tree_leaves(full.params),
        jax.tree_util.tree_leaves(resumed.params),
    ):
        np.testing.assert_array_equal(np.asarray(pa), np.asarray(pb))


@pytest.mark.parametrize("partition", ["halo", "allgather"])
def test_resume_training_forwards_mesh_partition(tmp_path, monkeypatch,
                                                 partition):
    """resume_training builds its trainer through the same pipeline as
    run_experiment: a sharded run must resume on the same mesh partition,
    continuing the uninterrupted sharded trajectory exactly."""
    import os

    from textgcn.text.datasets import DatasetLabels
    from textgcn.train.prepare import PreparedData
    from textgcn.train.run import resume_training, run_experiment

    g, x, y, tr, te, c = _toy_problem()
    labels = DatasetLabels(
        target=y, label_names=[str(i) for i in range(c)],
        train_idx=tr, test_idx=te,
    )
    pre = PreparedData(
        graph=g, features=x, labels=labels, n_feat=x.shape[1],
        num_docs=len(y), num_topics=0,
    )
    cfg = TrainConfig(
        n_hidden=8, max_epoch=6, epoch_block=3, early_stopping=1000,
        seed=7, spmm="segment",
    )
    monkeypatch.chdir(tmp_path)
    run_experiment(
        "toy", times=1, seeds=[7], pre_data=pre, config=cfg,
        n_shards=2, verbose=False, output_dir=str(tmp_path / "o1"),
        save_state=str(tmp_path / "st"), partition=partition,
    )
    full = run_experiment(
        "toy", times=1, seeds=[7], pre_data=pre,
        config=dataclasses.replace(cfg, max_epoch=12),
        n_shards=2, verbose=False, output_dir=str(tmp_path / "o2"),
        partition=partition,
    )
    resumed = resume_training(
        "toy", str(tmp_path / "st"), pre_data=pre,
        config=dataclasses.replace(cfg, max_epoch=12),
        n_shards=2, verbose=False, output_dir=str(tmp_path / "o3"),
        partition=partition,
    )
    want = [h["train_loss"] for h in full["runs"][0]["history"][6:]]
    got = [h["train_loss"] for h in resumed["runs"][0]["history"]]
    np.testing.assert_allclose(got, want, rtol=0, atol=0)


def test_resume_training_applies_sgc_precompute(tmp_path, monkeypatch):
    """A resumed sgc_pre run must train on the SAME precomputed A^2 X
    features as the original run (resume_training shares run_experiment's
    prep pipeline), continuing the uninterrupted trajectory."""
    from textgcn.text.datasets import DatasetLabels
    from textgcn.train.prepare import PreparedData
    from textgcn.train.run import resume_training, run_experiment

    g, x, y, tr, te, c = _toy_problem()
    labels = DatasetLabels(
        target=y, label_names=[str(i) for i in range(c)],
        train_idx=tr, test_idx=te,
    )
    pre = PreparedData(
        graph=g, features=x, labels=labels, n_feat=x.shape[1],
        num_docs=len(y), num_topics=0,
    )
    cfg = TrainConfig(
        n_hidden=8, max_epoch=6, epoch_block=3, early_stopping=1000,
        seed=7, model="sgc_pre",
    )
    monkeypatch.chdir(tmp_path)
    run_experiment(
        "toy", times=1, seeds=[7], pre_data=pre, config=cfg,
        verbose=False, output_dir=str(tmp_path / "o1"),
        save_state=str(tmp_path / "st"),
    )
    full = run_experiment(
        "toy", times=1, seeds=[7], pre_data=pre,
        config=dataclasses.replace(cfg, max_epoch=12),
        verbose=False, output_dir=str(tmp_path / "o2"),
    )
    resumed = resume_training(
        "toy", str(tmp_path / "st"), pre_data=pre,
        config=dataclasses.replace(cfg, max_epoch=12),
        verbose=False, output_dir=str(tmp_path / "o3"),
    )
    want = [h["train_loss"] for h in full["runs"][0]["history"][6:]]
    got = [h["train_loss"] for h in resumed["runs"][0]["history"]]
    np.testing.assert_allclose(got, want, rtol=0, atol=0)
