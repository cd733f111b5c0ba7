"""Metrics vs the reference's conventions, oracled by torch-free numpy."""
import jax.numpy as jnp
import numpy as np

from textgcn.train.metrics import accuracy, macro_f1


def _ref_macro_f1(pred, targ, num_classes):
    """Independent numpy re-statement of the reference metric
    (utils.py:25-86): per-class P/R with NaN→0, F1 of macro-averages."""
    tp = np.array([np.sum((pred == i) & (targ == i)) for i in range(num_classes)])
    fp = np.array([np.sum((pred == i) & (targ != i)) for i in range(num_classes)])
    fn = np.array([np.sum((pred != i) & (targ == i)) for i in range(num_classes)])
    with np.errstate(invalid="ignore"):
        prec = tp / (tp + fp)
        rec = tp / (tp + fn)
    prec[np.isnan(prec)] = 0
    rec[np.isnan(rec)] = 0
    p, r = prec.mean(), rec.mean()
    f1 = 2 * p * r / (p + r) if (p + r) > 0 else 0.0
    return f1, p, r


def _logits_for(pred, num_classes):
    logits = np.zeros((len(pred), num_classes), dtype=np.float32)
    logits[np.arange(len(pred)), pred] = 1.0
    return logits


def test_accuracy():
    targ = np.array([0, 1, 2, 1, 0])
    pred = np.array([0, 1, 1, 1, 2])
    logits = _logits_for(pred, 3)
    got = float(accuracy(jnp.asarray(logits), jnp.asarray(targ)))
    assert abs(got - 0.6) < 1e-6


def test_macro_f1_matches_reference_convention():
    rng = np.random.RandomState(0)
    for ncls in [2, 5, 8]:
        targ = rng.randint(0, ncls, 200)
        pred = rng.randint(0, ncls, 200)
        logits = _logits_for(pred, ncls)
        f1, p, r = macro_f1(jnp.asarray(logits), jnp.asarray(targ), ncls)
        wf1, wp, wr = _ref_macro_f1(pred, targ, ncls)
        np.testing.assert_allclose(float(p), wp, rtol=1e-6)
        np.testing.assert_allclose(float(r), wr, rtol=1e-6)
        np.testing.assert_allclose(float(f1), wf1, rtol=1e-6)


def test_macro_f1_absent_class_nan_to_zero():
    # class 2 never appears in targ nor pred → P=R=0 for it
    targ = np.array([0, 0, 1, 1])
    pred = np.array([0, 1, 1, 0])
    logits = _logits_for(pred, 3)
    f1, p, r = macro_f1(jnp.asarray(logits), jnp.asarray(targ), 3)
    wf1, wp, wr = _ref_macro_f1(pred, targ, 3)
    np.testing.assert_allclose(float(p), wp, rtol=1e-6)
    np.testing.assert_allclose(float(f1), wf1, rtol=1e-6)
