"""Losses with the reference's semantics (port of ``vfd_gan_tpu.ops.losses``).

Reference definitions: lib/utils.py:59-71 (``l2_loss``, ``weighted_bce``)
and ``torch.nn.BCELoss`` (models/mygannet.py:267).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def l2_loss(x: torch.Tensor, y: torch.Tensor,
            size_average: bool = True) -> torch.Tensor:
    """Mean (or elementwise) squared error (lib/utils.py:59-63)."""
    sq = (x - y).square()
    return sq.mean() if size_average else sq


def weighted_bce(pred: torch.Tensor, target: torch.Tensor,
                 pos_weight: float | None = 2.0) -> torch.Tensor:
    """Weighted BCE (lib/utils.py:65-71).  The reference's quirk is kept:
    the weight multiplies the *negative* (background) term; inputs are
    clamped to [1e-8, 1 - 1e-8] before the logs."""
    p = pred.clamp(1e-8, 1.0 - 1e-8)
    w = 1.0 if pos_weight is None else pos_weight
    ll = target * torch.log(p) + w * (1.0 - target) * torch.log(1.0 - p)
    return -ll.mean()


def bce(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``torch.nn.BCELoss``: the mean, each log floored at -100 (the
    target read in the prediction's dtype)."""
    return F.binary_cross_entropy(pred, target.to(pred.dtype))
