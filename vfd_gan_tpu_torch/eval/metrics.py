"""Pixel-level ROC / PR / F1 of a test sweep (port of
``vfd_gan_tpu.eval.metrics``).

Reference lib/evaluate.py:14-91: ROC AUC with the equal error rate, PR
AUC, and F1 at the fixed threshold 0.20.  The JAX package calls sklearn;
the card's machine has no sklearn, so ``roc_curve``,
``precision_recall_curve`` and ``auc`` are restated here in numpy with
sklearn's semantics: one curve point per distinct score (ties share a
point), collinear ROC points dropped, the (0, 0) ROC start, and the
(recall 0, precision 1) PR end.  The EER uses scipy (``brentq`` on the
interpolated curve), as the JAX package does.

When a curve beats ``best``, its points are written as a CSV
(``ROC_%03d`` / ``PR_%03d``, the reference's names); the PNG plot of the
JAX package waits (no matplotlib on the card's machine).
"""

from __future__ import annotations

import csv
import os

import numpy as np


def _clf_curve(labels: np.ndarray, scores: np.ndarray):
    """False/true positive counts and thresholds at each distinct score,
    scores descending (sklearn's ``_binary_clf_curve``)."""
    labels = (np.asarray(labels).ravel() == 1).astype(np.float64)
    scores = np.asarray(scores).ravel()
    order = np.argsort(scores, kind="mergesort")[::-1]
    scores = scores[order]
    labels = labels[order]
    distinct = np.where(np.diff(scores))[0]
    idx = np.r_[distinct, labels.size - 1]
    tps = np.cumsum(labels)[idx]
    fps = 1 + idx - tps
    return fps, tps, scores[idx]


def roc_curve(labels, scores):
    """``(fpr, tpr, thresholds)`` as ``sklearn.metrics.roc_curve`` with
    ``drop_intermediate=True``."""
    fps, tps, thr = _clf_curve(labels, scores)
    if len(fps) > 2:
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2),
                                                  np.diff(tps, 2)), True])[0]
        fps, tps, thr = fps[keep], tps[keep], thr[keep]
    tps = np.r_[0.0, tps]
    fps = np.r_[0.0, fps]
    thr = np.r_[np.inf, thr.astype(np.float64)]
    fpr = np.full(fps.shape, np.nan) if fps[-1] <= 0 else fps / fps[-1]
    tpr = np.full(tps.shape, np.nan) if tps[-1] <= 0 else tps / tps[-1]
    return fpr, tpr, thr


def precision_recall_curve(labels, scores):
    """``(precision, recall, thresholds)`` as
    ``sklearn.metrics.precision_recall_curve``."""
    fps, tps, thr = _clf_curve(labels, scores)
    ps = tps + fps
    precision = np.divide(tps, ps, out=np.zeros_like(tps), where=ps != 0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    return (np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0],
            thr[::-1])


def auc(x, y) -> float:
    """Trapezoidal area under a monotonic curve (``sklearn.metrics.auc``)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if x.shape[0] < 2:
        raise ValueError("auc needs at least 2 points")
    direction = 1.0
    dx = np.diff(x)
    if np.any(dx < 0):
        if not np.all(dx <= 0):
            raise ValueError("x is neither increasing nor decreasing")
        direction = -1.0
    return float(direction * np.sum(dx * (y[1:] + y[:-1]) / 2.0))


def f1_at(labels, scores, threshold: float = 0.20) -> float:
    """F1 of ``scores >= threshold`` against the labels (positive class 1;
    0 when there are no positives at all, as sklearn's zero_division)."""
    labels = np.asarray(labels).ravel() == 1
    pred = np.asarray(scores).ravel() >= threshold
    tp = float(np.sum(labels & pred))
    denom = 2 * tp + float(np.sum(~labels & pred)) + float(
        np.sum(labels & ~pred))
    return 2 * tp / denom if denom > 0 else 0.0


def roc_auc_with_eer(labels, scores):
    """Returns ``(auc, eer, fpr, tpr)``."""
    from scipy.interpolate import interp1d
    from scipy.optimize import brentq

    fpr, tpr, _ = roc_curve(labels, scores)
    area = auc(fpr, tpr)
    try:
        eer = brentq(lambda x: 1.0 - x - interp1d(fpr, tpr)(x), 0.0, 1.0)
    except ValueError:  # degenerate curve
        eer = float("nan")
    return area, eer, fpr, tpr


def pr_auc(labels, scores):
    """Returns ``(auc, precision, recall)``."""
    precision, recall, _ = precision_recall_curve(labels, scores)
    return auc(recall, precision), precision, recall


def _save_csv(path: str, xs, ys) -> None:
    with open(path, "w", newline="") as f:
        csv.writer(f).writerows(zip(xs, ys))


def evaluate(labels, scores, best: float | None = None,
             step: int | None = None, saveto: str | None = None,
             metric: str = "roc") -> float:
    """Metric dispatch of reference ``evaluate`` (lib/evaluate.py:14-27)."""
    labels = np.asarray(labels).ravel()
    scores = np.asarray(scores).ravel()
    if metric == "roc":
        area, _, fpr, tpr = roc_auc_with_eer(labels, scores)
        if saveto is not None and best is not None and area > best:
            _save_csv(os.path.join(saveto, "ROC_%03d" % step), fpr, tpr)
        return float(area)
    if metric == "pr":
        area, precision, recall = pr_auc(labels, scores)
        if saveto is not None and best is not None and area > best:
            _save_csv(os.path.join(saveto, "PR_%03d" % step), recall,
                      precision)
        return float(area)
    if metric == "f1_score":
        return f1_at(labels, scores, 0.20)
    raise NotImplementedError(f"unknown evaluation metric {metric!r}")
