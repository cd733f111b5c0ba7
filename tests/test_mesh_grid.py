"""The sharded segment path against the single-device trainer, over
partitions × shard counts × model families, on the virtual 8-device CPU
mesh; plus scan-block invariance and identity-feature (doc-word) runs."""
import dataclasses

import numpy as np
import pytest

from textgcn.parallel.trainer import SHARDED_MODELS, ShardedTrainer
from textgcn.train.trainer import TrainConfig, Trainer


def _data(seed=0, n_docs=96, n_classes=4):
    import os
    import sys

    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    from __graft_entry__ import _synthetic_graph

    g, x, y = _synthetic_graph(
        n_docs=n_docs, n_topics=12, n_feat=24, seed=seed
    )
    rng = np.random.RandomState(seed)
    target = (y[:n_docs] % n_classes).astype(np.int64)
    is_train = rng.rand(n_docs) < 0.7
    idx = np.arange(n_docs)
    return g, x, target, idx[is_train], idx[~is_train], n_classes


CFG = TrainConfig(
    n_hidden=16, max_epoch=4, early_stopping=100, dropout=0.0, seed=3,
    epoch_block=2,
)
FAMILIES = ("gcn", "gat", "sage", "sgc", "appnp", "gin", "gcnii")


def test_grid_covers_every_sharded_family():
    assert set(FAMILIES) == set(SHARDED_MODELS)


@pytest.mark.parametrize("model", FAMILIES)
@pytest.mark.parametrize("n_shards", [2, 8])
@pytest.mark.parametrize("partition", ["halo", "allgather"])
def test_sharded_matches_single_device_trainer(partition, n_shards, model):
    """Epoch-by-epoch train/val loss and accuracy parity with the
    single-device Trainer (f32 on the CPU; only the summation order
    differs: 1e-3 on losses, GAT's online halo softmax included)."""
    g, x, target, tr, te, C = _data(seed=21)
    cfg = dataclasses.replace(CFG, model=model)
    single = Trainer(g, x, target, tr, te, C, config=cfg)
    single.fit(verbose=False)
    sharded = ShardedTrainer(
        g, x, target, tr, te, C, config=cfg, n_shards=n_shards,
        partition=partition,
    )
    sharded.fit(verbose=False)
    assert len(single.history) == len(sharded.history)
    for hs, hd in zip(single.history, sharded.history):
        assert abs(hs["train_loss"] - hd["train_loss"]) < 1e-3, (hs, hd)
        assert abs(hs["val_loss"] - hd["val_loss"]) < 1e-3, (hs, hd)
    ts, td = single.test(), sharded.test()
    assert abs(ts["acc"] - td["acc"]) < 2e-2, (ts, td)
    assert ts["model_param"] == td["model_param"]


def test_sharded_epoch_block_invariance():
    """The sharded trainer's scan-blocked epochs are bit-identical across
    block sizes (the single-device trainer pins the same property)."""
    g, x, target, tr, te, C = _data(seed=2)
    runs = []
    for block in (1, 4):
        t = ShardedTrainer(
            g, x, target, tr, te, C,
            config=dataclasses.replace(CFG, max_epoch=8, epoch_block=block,
                                       dropout=0.5),
            n_shards=4,
        )
        t.fit(verbose=False)
        runs.append(t)
    a, b = runs
    assert len(a.history) == len(b.history)
    for ha, hb in zip(a.history, b.history):
        assert ha["train_loss"] == hb["train_loss"], (ha, hb)
        assert ha["val_loss"] == hb["val_loss"], (ha, hb)


@pytest.mark.parametrize("model", ["sage", "sgc", "gcnii", "gat"])
def test_sharded_identity_features(model):
    """Identity features (doc-word family): layer 1's node-indexed weights
    are row-sharded [n_pad, ·] tables; training runs and the loss falls."""
    g, _, target, tr, te, C = _data(seed=10)
    t = ShardedTrainer(
        g, None, target, tr, te, C,
        config=dataclasses.replace(CFG, model=model, max_epoch=6,
                                   epoch_block=3),
        n_shards=4, partition="halo",
    )
    t.fit(verbose=False)
    assert t.history[-1]["train_loss"] < t.history[0]["train_loss"]
    assert np.isfinite(t.test()["test_loss"])
    layer1 = SHARDED_MODELS[model][2]
    tables = [
        w for w in t.params[layer1].values()
        if getattr(w, "ndim", 0) == 2 and w.shape[0] == t.n_pad
    ]
    assert tables
    for w in tables:
        assert len(w.sharding.device_set) == 4, w.sharding


def test_sharded_state_metadata_best_val_is_raw_loss(tmp_path):
    """The checkpoint's best_val field is a raw (positive) val loss — the
    single-device trainer compares val_loss < best_val on resume, so a
    negated score would permanently disable best-val tracking."""
    from textgcn.train.checkpoint import restore_checkpoint

    g, x, target, tr, te, C = _data(seed=47)
    t = ShardedTrainer(
        g, x, target, tr, te, C,
        config=TrainConfig(n_hidden=8, max_epoch=4, early_stopping=1000,
                           dropout=0.0, seed=7),
        n_shards=2,
    )
    t.fit(verbose=False)
    ckpt = t.save_training_state(str(tmp_path / "bv"))
    md = restore_checkpoint(ckpt)["metadata"]
    min_vloss = min(h["val_loss"] for h in t.history)
    np.testing.assert_allclose(float(md["best_val"]), min_vloss, rtol=1e-6)
