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


def minmax_normalize(x: torch.Tensor, dims=None) -> torch.Tensor:
    """Shift/scale to [0, 1) by the global (or per-``dims``) min and max,
    with the reference's +1e-5 in the denominator (lib/utils.py:81-89), so
    a constant input maps to 0, not NaN."""
    if dims is None:
        mn, mx = x.min(), x.max()
    else:
        mn = x.amin(dim=dims, keepdim=True)
        mx = x.amax(dim=dims, keepdim=True)
    return (x - mn) / (mx - mn + 1e-5)


# ITU-R BT.601 luma weights, cv2.cvtColor(RGB2GRAY)'s (reference
# lib/utils.py:108,134)
_LUMA = (0.299, 0.587, 0.114)


def rgb_to_gray(video: torch.Tensor) -> torch.Tensor:
    """BT.601 luma of a channel-last video: ``(..., 3) -> (..., 1)``
    (reference lib/utils.py:131-136)."""
    r, g, b = video[..., 0], video[..., 1], video[..., 2]
    return (_LUMA[0] * r + _LUMA[1] * g + _LUMA[2] * b)[..., None]


def gray2rgb(video: torch.Tensor) -> torch.Tensor:
    """Repeat a channel-last single channel ``(..., 1)`` to ``(..., 3)``
    (reference lib/utils.py:91-92)."""
    return torch.cat([video, video, video], dim=-1)
