"""Trilinear resampling (port of ``vfd_gan_tpu.ops.resize.upsample2x``).

The reference decoders upsample with ``nn.Upsample(mode='trilinear',
align_corners=True)`` (models/mygannet.py:50); the JAX package writes it as
interpolation matmuls for the TPU, the port calls ``F.interpolate``.
"""

from __future__ import annotations

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
