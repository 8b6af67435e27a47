"""Linear resampling (port of ``vfd_gan_tpu.ops.resize``).

The reference decoders upsample with ``nn.Upsample(mode='trilinear',
align_corners=True)`` (models/mygannet.py:50); the port calls
``F.interpolate`` for that.  ``resize_bilinear`` (half-pixel sampling, no
antialias) is the flow pipeline's resize: the pyramid, the per-level flow
upsample, ``flow_scale`` and the RGB upsample.  It is written, as in the
JAX package, as one ``(out, in)`` interpolation matrix per axis applied in
float32, so the two agree to float32 rounding.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from vfd_gan_tpu_torch.ops.image import to_channel_first, to_channel_last


def upsample_ncdhw(x: torch.Tensor, scale: tuple[int, int, int] = (2, 2, 2),
                   align_corners: bool = True) -> torch.Tensor:
    """Trilinear upsample of ``(B, C, T, H, W)`` by integer ``scale``."""
    t, h, w = x.shape[2:]
    return F.interpolate(x, size=(t * scale[0], h * scale[1], w * scale[2]),
                         mode="trilinear", align_corners=align_corners)


def upsample2x(x: torch.Tensor, scale: tuple[int, int, int] = (2, 2, 2),
               align_corners: bool = True) -> torch.Tensor:
    """``nn.Upsample(scale_factor=scale, mode='trilinear')`` on a
    channel-last ``(B, T, H, W, C)`` video."""
    return to_channel_last(upsample_ncdhw(to_channel_first(x), scale,
                                          align_corners))


@lru_cache(maxsize=None)
def _linear_matrix(n_in: int, n_out: int,
                   align_corners: bool = True) -> np.ndarray:
    """Dense ``(n_out, n_in)`` linear-interpolation matrix (float32); with
    ``align_corners=False`` the half-pixel source position is clamped to
    ``[0, n_in - 1]`` (vfd_gan_tpu/ops/resize.py:21-37)."""
    m = np.zeros((n_out, n_in), np.float32)
    if n_out == 1 or n_in == 1:
        m[:, 0] = 1.0
        return m
    for i in range(n_out):
        if align_corners:
            src = i * (n_in - 1) / (n_out - 1)
        else:
            src = max(0.0, min(n_in - 1.0, (i + 0.5) * n_in / n_out - 0.5))
        lo = int(np.floor(src))
        hi = min(lo + 1, n_in - 1)
        frac = src - lo
        m[i, lo] += 1.0 - frac
        m[i, hi] += frac
    return m


@lru_cache(maxsize=None)
def _matrix_on(n_in: int, n_out: int, align_corners: bool,
               device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``_linear_matrix`` on ``device``, copied there once: a copy from
    pageable host memory would wait for all work queued on the card."""
    return torch.from_numpy(_linear_matrix(n_in, n_out, align_corners)).to(
        device=device, dtype=dtype)


def _resize_axis(x: torch.Tensor, axis: int, n_out: int,
                 align_corners: bool) -> torch.Tensor:
    n_in = x.shape[axis]
    if n_in == n_out:
        return x
    w = _matrix_on(n_in, n_out, align_corners, x.device, x.dtype)
    return torch.matmul(x.movedim(axis, -1), w.T).movedim(-1, axis)


def resize_bilinear(x: torch.Tensor, size: tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """Per-frame spatial resize of channel-last ``(..., H, W, C)`` to
    ``size = (H', W')``: H first, then W, as the JAX function does."""
    x = _resize_axis(x, x.dim() - 3, size[0], align_corners)
    return _resize_axis(x, x.dim() - 2, size[1], align_corners)
