"""Evaluation metrics, jittable.

Reproduces the reference's conventions (reference utils.py:25-109):
- accuracy = mean(argmax(logits) == target);
- macro P/R from per-class TP/FP/FN with NaN→0 per class, and
- **F1 computed from the macro-averaged P and R** (not the mean of per-class
  F1s) — a quirk of the reference kept for comparability
  (reference utils.py:84).

Implemented with one-hot confusion counts (matmul-shaped)
instead of a Python per-class loop.
"""
from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp


def accuracy(logits: jnp.ndarray, target: jnp.ndarray) -> jnp.ndarray:
    pred = jnp.argmax(logits, axis=1)
    return jnp.mean((pred == target).astype(jnp.float32))


def confusion_counts(
    logits: jnp.ndarray, target: jnp.ndarray, num_classes: int
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Per-class (TP, FP, FN) as float32 [C] arrays."""
    pred = jnp.argmax(logits, axis=1)
    pred_1h = _one_hot(pred, num_classes)
    targ_1h = _one_hot(target, num_classes)
    tp = jnp.sum(pred_1h * targ_1h, axis=0)
    fp = jnp.sum(pred_1h * (1.0 - targ_1h), axis=0)
    fn = jnp.sum((1.0 - pred_1h) * targ_1h, axis=0)
    return tp, fp, fn


def _one_hot(x: jnp.ndarray, n: int) -> jnp.ndarray:
    return (x[:, None] == jnp.arange(n)[None, :]).astype(jnp.float32)


def macro_f1(
    logits: jnp.ndarray, target: jnp.ndarray, num_classes: int
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Return (f1, macro_precision, macro_recall), reference convention."""
    tp, fp, fn = confusion_counts(logits, target, num_classes)
    prec = jnp.where(tp + fp > 0, tp / jnp.maximum(tp + fp, 1.0), 0.0)
    rec = jnp.where(tp + fn > 0, tp / jnp.maximum(tp + fn, 1.0), 0.0)
    p = jnp.mean(prec)
    r = jnp.mean(rec)
    f1 = jnp.where(p + r > 0, 2.0 * p * r / jnp.maximum(p + r, 1e-30), 0.0)
    return f1, p, r
