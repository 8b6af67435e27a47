"""MyGAN generator (port of ``vfd_gan_tpu.models.mygan.Generator``).

A 5-level U-Net over NCDHW ``(B, 3, T, H, W)`` video (reference NetG,
models/mygannet.py:31-101): every conv is a factored (2+1)D
``GenConvBlock``; ``avg_pool3d(2, 2, 2)`` downsamples; the decoder runs
conv -> Dropout(0.25) -> trilinear align-corners x2 upsample -> skip concat
``[upsampled, skip]``; the head is a 3x3x3 conv without bias and a float32
sigmoid, giving the mask video ``(B, 1, T, H, W)``.  T, H and W must divide
by 16.

Serving runs it in ``.eval()``: BN uses its running statistics and dropout
is inert.  The discriminators belong to the training slice.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from vfd_gan_tpu_torch.models.layers import GenConvBlock
from vfd_gan_tpu_torch.ops.resize import upsample_ncdhw
from vfd_gan_tpu_torch.utils.init import dcgan_normal_


class Generator(nn.Module):
    """U-Net mask predictor; ``generator`` seeds the reference init."""

    def __init__(self, ngf: int = 32, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = ngf
        kw = {"device": device, "generator": generator}
        self.dconv1 = GenConvBlock(3, g, **kw)
        self.dconv2 = GenConvBlock(g, g * 2, **kw)
        self.dconv3 = GenConvBlock(g * 2, g * 4, **kw)
        self.dconv4 = GenConvBlock(g * 4, g * 8, **kw)
        self.dconv5 = GenConvBlock(g * 8, g * 16, **kw)
        self.uconv5 = GenConvBlock(g * 16, g * 8, **kw)
        self.uconv4 = GenConvBlock(g * 16, g * 8, **kw)
        self.uconv3 = GenConvBlock(g * 12, g * 4, **kw)
        self.uconv2 = GenConvBlock(g * 6, g * 2, **kw)
        self.uconv1 = GenConvBlock(g * 3, g, **kw)
        self.drop = nn.Dropout(0.25)
        self.conv_last = nn.Conv3d(g, 1, 3, padding=1, bias=False,
                                   device=device)
        if generator is not None:
            dcgan_normal_(self.conv_last.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d1 = self.dconv1(x)
        d2 = self.dconv2(F.avg_pool3d(d1, 2))
        d3 = self.dconv3(F.avg_pool3d(d2, 2))
        d4 = self.dconv4(F.avg_pool3d(d3, 2))
        latent = self.dconv5(F.avg_pool3d(d4, 2))

        y = upsample_ncdhw(self.drop(self.uconv5(latent)))
        y = upsample_ncdhw(self.drop(self.uconv4(torch.cat([y, d4], 1))))
        y = upsample_ncdhw(self.drop(self.uconv3(torch.cat([y, d3], 1))))
        y = upsample_ncdhw(self.drop(self.uconv2(torch.cat([y, d2], 1))))
        y = self.uconv1(torch.cat([y, d1], 1))
        return torch.sigmoid(self.conv_last(y).float())
