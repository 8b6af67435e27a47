"""ROC / EER / PR / F1 of pixel score tensors, computed where the tensors
lie (port of ``vfd_gan_tpu.eval.device_metrics``, ``--device_scoring``).

The host path (``eval/metrics.py``) copies every sweep batch's gt and
prediction to the host and sorts them there.  Here one sort and a few
cumulative sums run on the tensors' device, and only four scalars come
back.  The curve artifacts (CSV) are not written: they need the host
arrays this path avoids.

The arithmetic is the JAX package's, float32 throughout, so the functions
agree with it on the CPU (``tests/test_torch_port_device_metrics.py``):

* ROC-AUC by the Mann-Whitney rank sum with midranks for ties, which is
  the trapezoidal area under ``roc_curve`` (one point per distinct score);
* EER solves ``1 - x - interp(tpr over fpr)(x) = 0`` on the segment of the
  curve where the sign changes (the root the host path's ``brentq``
  finds);
* PR-AUC is the trapezoidal area of precision over recall at the distinct
  scores (the reference's ``auc(recall, precision)``, lib/evaluate.py:88,
  not average precision);
* F1 at the reference's fixed 0.20 threshold (test.py:49-52).

Float32 counts and ranks are exact up to 2^24; a sweep of more pixels
rounds them.
"""

from __future__ import annotations

import torch


def _flat(labels: torch.Tensor, scores: torch.Tensor):
    return (labels.reshape(-1).to(torch.float32),
            scores.reshape(-1).to(torch.float32))


def roc_auc(labels: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """ROC-AUC (a float32 0-dim tensor; NaN for single-class labels)."""
    labels, scores = _flat(labels, scores)
    n = scores.shape[0]
    s_sorted = torch.sort(scores).values
    # midrank among all scores (1-based): a run of ties shares the mean of
    # its ranks, (left + right + 1) / 2
    lo = torch.searchsorted(s_sorted, scores, side="left")
    hi = torch.searchsorted(s_sorted, scores, side="right")
    midrank = (lo + hi + 1).to(torch.float32) * 0.5
    npos = labels.sum()
    nneg = n - npos
    area = ((midrank * labels).sum() - npos * (npos + 1.0) * 0.5) / (
        npos * nneg)
    return torch.where((npos > 0) & (nneg > 0), area,
                       torch.full_like(area, float("nan")))


def _descending(labels: torch.Tensor, scores: torch.Tensor):
    """Cumulative true and false positives at each score, scores
    descending (stable among ties), and the index of the last element of
    each run of equal scores, the rest pointing at the last element (a
    repeat of the terminal point adds no area)."""
    labels, scores = _flat(labels, scores)
    order = torch.argsort(-scores, stable=True)
    s_desc = scores[order]
    l_desc = labels[order]
    tps = torch.cumsum(l_desc, 0)
    fps = torch.cumsum(1.0 - l_desc, 0)
    n = scores.shape[0]
    is_last = torch.cat([s_desc[1:] != s_desc[:-1],
                         torch.ones(1, dtype=torch.bool,
                                    device=scores.device)])
    arange = torch.arange(n, device=scores.device)
    idx = torch.sort(torch.where(is_last, arange,
                                 torch.full_like(arange, n - 1))).values
    return tps, fps, idx


def _curve(labels: torch.Tensor, scores: torch.Tensor):
    """fpr and tpr at the distinct scores, descending, from (0, 0), padded
    to n + 1 points with the terminal one."""
    tps, fps, idx = _descending(labels, scores)
    npos, nneg = tps[-1], fps[-1]
    tpr = tps / npos.clamp_min(1.0)
    fpr = fps / nneg.clamp_min(1.0)
    zero = torch.zeros(1, device=tps.device)
    return (torch.cat([zero, fpr[idx]]), torch.cat([zero, tpr[idx]]), npos,
            nneg)


def roc_eer(labels: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """EER: the x where ``interp(tpr over fpr)(x) == 1 - x`` (test.py:68)."""
    fpr, tpr, npos, nneg = _curve(labels, scores)
    # g(x) = 1 - x - tpr(x) does not increase; solve g = 0 on the first
    # segment where it crosses 0
    g = 1.0 - fpr - tpr
    crosses = (g[:-1] > 0) & (g[1:] <= 0)
    i = torch.argmax(crosses.to(torch.int32))
    x0, x1, t0, t1 = fpr[i], fpr[i + 1], tpr[i], tpr[i + 1]
    dx = x1 - x0
    one = torch.ones_like(dx)
    slope = torch.where(dx > 0, (t1 - t0) / torch.where(dx > 0, dx, one),
                        torch.zeros_like(dx))
    x = (1.0 - t0 + slope * x0) / (1.0 + slope)
    x = torch.where(dx > 0, x, x0)       # a vertical segment: x = x0
    ok = (npos > 0) & (nneg > 0) & crosses.any()
    return torch.where(ok, x.clamp(0.0, 1.0),
                       torch.full_like(x, float("nan")))


def pr_auc(labels: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """Trapezoidal area of precision over recall at the distinct scores
    (``auc(recall, precision)`` on ``precision_recall_curve``)."""
    tps, fps, idx = _descending(labels, scores)
    npos = tps[-1]
    precision = tps / (tps + fps).clamp_min(1.0)
    recall = tps / npos.clamp_min(1.0)
    # the curve runs from recall 1 to 0 and ends at (recall 0, precision
    # 1); repeated padding points add no area
    r = torch.cat([recall[idx].flip(0), torch.zeros(1, device=tps.device)])
    p = torch.cat([precision[idx].flip(0), torch.ones(1, device=tps.device)])
    area = ((r[1:] - r[:-1]) * (p[1:] + p[:-1]) * 0.5).sum().abs()
    return torch.where(npos > 0, area, torch.full_like(area, float("nan")))


def f1_at(labels: torch.Tensor, scores: torch.Tensor,
          threshold: float = 0.20) -> torch.Tensor:
    """F1 of ``scores >= threshold`` (test.py:49-52); 0 without any
    positive."""
    labels, scores = _flat(labels, scores)
    pred = (scores >= threshold).to(torch.float32)
    tp = (pred * labels).sum()
    fp = (pred * (1.0 - labels)).sum()
    fn = ((1.0 - pred) * labels).sum()
    denom = 2.0 * tp + fp + fn
    return torch.where(denom > 0, 2.0 * tp / denom.clamp_min(1.0),
                       torch.zeros_like(denom))


def score_sweep(gts: torch.Tensor, preds: torch.Tensor):
    """``(roc, eer, pr, f1)`` of a sweep as 0-dim float32 tensors on the
    inputs' device.  ``gts`` is truncated to integers first, the
    reference's ``np.asarray(gts, dtype=np.int32)`` (models/mygannet.py:
    444), which sends fractional mask edges to 0."""
    labels = gts.reshape(-1).to(torch.int32).to(torch.float32)
    scores = preds.reshape(-1).to(torch.float32)
    return (roc_auc(labels, scores), roc_eer(labels, scores),
            pr_auc(labels, scores), f1_at(labels, scores))
