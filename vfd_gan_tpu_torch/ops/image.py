"""Elementwise video utilities (port of ``vfd_gan_tpu.ops.image``)."""

from __future__ import annotations

import torch


def threshold(x: torch.Tensor, t: float = 0.5) -> torch.Tensor:
    """Binarise at ``t`` (reference lib/utils.py:149-152; strict >), keeping
    the input dtype."""
    return (x > t).to(x.dtype)


def to_channel_last(x: torch.Tensor) -> torch.Tensor:
    """torch layout ``(B, C, T, H, W)`` -> framework layout ``(B, T, H, W, C)``."""
    return x.permute(0, 2, 3, 4, 1)


def to_channel_first(x: torch.Tensor) -> torch.Tensor:
    """Framework layout ``(B, T, H, W, C)`` -> torch layout ``(B, C, T, H, W)``."""
    return x.permute(0, 4, 1, 2, 3)
