"""End-to-end trainer test on a synthetic two-community graph: the GCN must
fit it to high accuracy, early stopping and history must behave."""
import numpy as np
import scipy.sparse as sp

from textgcn.graph.normalize import sym_normalize_coo
from textgcn.graph.structs import SparseGraph
from textgcn.train.trainer import (
    EarlyStopping,
    TrainConfig,
    Trainer,
    train_val_split,
)


def _two_blobs_graph(n=120, seed=0):
    """Two dense communities with sparse cross-links + noisy features."""
    rng = np.random.RandomState(seed)
    labels = (np.arange(n) >= n // 2).astype(np.int64)
    rows, cols = [], []
    for _ in range(n * 8):
        a = rng.randint(0, n)
        same = rng.rand() < 0.95
        if same:
            b = rng.randint(0, n // 2) + (n // 2) * labels[a]
        else:
            b = rng.randint(0, n // 2) + (n // 2) * (1 - labels[a])
        rows.append(a)
        cols.append(b)
    m = sp.coo_matrix(
        (np.ones(len(rows)), (np.array(rows), np.array(cols))), shape=(n, n)
    )
    m = m.maximum(m.T).tocoo()
    r, c, v = sym_normalize_coo(m.row, m.col, m.data, n)
    g = SparseGraph.from_coo(r, c, v, n, pad_to_multiple=512)
    x = rng.randn(n, 16).astype(np.float32) * 0.1
    x[:, 0] += labels * 0.3  # weak signal
    return g, x, labels


def test_trainer_fits_synthetic_graph():
    g, x, y = _two_blobs_graph()
    n = len(y)
    rng = np.random.RandomState(1)
    perm = rng.permutation(n)
    train_idx, test_idx = perm[: n // 2], perm[n // 2 :]
    cfg = TrainConfig(n_hidden=32, max_epoch=100, seed=7, val_ratio=0.2)
    tr = Trainer(g, x, y, train_idx, test_idx, num_classes=2, config=cfg)
    tr.fit(verbose=False)
    res = tr.test()
    assert res["acc"] > 0.9, res
    assert res["model_param"] == 16 * 32 + 32 + 32 * 2 + 2
    assert len(tr.history) >= 10
    assert {"epoch", "train_loss", "val_loss", "acc", "macro_f1"} <= set(
        tr.history[0]
    )


def test_early_stopping_semantics():
    es = EarlyStopping(patience=3)
    assert not es(1.0)
    assert not es(0.9)  # improvement resets
    assert not es(0.95)  # worse: 1
    assert not es(0.95)  # worse: 2
    assert es(0.99)  # worse: 3 → stop
    es2 = EarlyStopping(patience=2)
    assert not es2(1.0)
    assert not es2(1.1)
    assert es2(1.2)


def test_train_val_split_disjoint_and_sized():
    idx = np.arange(100)
    tr, va = train_val_split(idx, 0.1, seed=3)
    assert len(va) == 10 and len(tr) == 90
    assert set(tr).isdisjoint(set(va))
    assert set(tr) | set(va) == set(range(100))
    tr2, va2 = train_val_split(idx, 0.1, seed=3)
    np.testing.assert_array_equal(tr, tr2)


def test_epoch_block_invariance():
    """Training trajectory must be identical for any epoch_block size."""
    g, x, y = _two_blobs_graph(n=80, seed=2)
    n = len(y)
    rng = np.random.RandomState(4)
    perm = rng.permutation(n)
    train_idx, test_idx = perm[: n // 2], perm[n // 2 :]
    results = []
    for block in (1, 7, 25):
        cfg = TrainConfig(
            n_hidden=16, max_epoch=25, seed=11, val_ratio=0.2,
            epoch_block=block,
        )
        tr = Trainer(g, x, y, train_idx, test_idx, num_classes=2, config=cfg)
        tr.fit(verbose=False)
        results.append((len(tr.history), tr.test()["acc"],
                        [e["val_loss"] for e in tr.history]))
    assert results[0][0] == results[1][0] == results[2][0]
    np.testing.assert_allclose(results[0][2], results[1][2], rtol=1e-5)
    np.testing.assert_allclose(results[0][2], results[2][2], rtol=1e-5)
    assert abs(results[0][1] - results[1][1]) < 1e-6


def test_identity_features_textgcn_mode():
    """features=None (X = I) trains via the embedding-table first layer."""
    g, x, y = _two_blobs_graph(n=60, seed=5)
    n = len(y)
    rng = np.random.RandomState(6)
    perm = rng.permutation(n)
    cfg = TrainConfig(n_hidden=16, max_epoch=60, seed=3, val_ratio=0.2)
    tr = Trainer(g, None, y, perm[: n // 2], perm[n // 2 :],
                 num_classes=2, config=cfg)
    tr.fit(verbose=False)
    res = tr.test()
    # identity features let the model memorize structure: should fit well
    assert res["acc"] > 0.75, res
    assert res["model_param"] == g.n_nodes * 16 + 16 + 16 * 2 + 2
