"""MyGAN: the generator and the dual discriminator (port of
``vfd_gan_tpu.models.mygan``).

A 5-level U-Net over NCDHW ``(B, 3, T, H, W)`` video (reference NetG,
models/mygannet.py:31-101): every conv is a factored (2+1)D
``GenConvBlock``; ``avg_pool3d(2, 2, 2)`` downsamples; the decoder runs
conv -> Dropout(0.25) -> trilinear align-corners x2 upsample -> skip concat
``[upsampled, skip]``; the head is a 3x3x3 conv without bias and a float32
sigmoid, giving the mask video ``(B, 1, T, H, W)``.  T, H and W must divide
by 16.

Serving runs it in ``.eval()``: BN uses its running statistics and dropout
is inert.  ``drop_rate`` (default the reference's 0.25) can be set to 0 so
that a train-mode forward is deterministic.

``DualDisc`` (reference NetD, models/mygannet.py:200-213) scores a pair of
NCDHW videos: ``SpatialDisc`` the RGB mask video (6 spatial-only
DiscConvBlocks, each followed by a (1,2,2) average pool, then a global
temporal pool), ``TemporalDisc`` its optical-flow video (3 temporal-only
blocks, each followed by a (2,1,1) pool, then a global spatial pool).  Each
flattens its pooled features in NCDHW ``(C, T, H, W)`` order into a Linear
and a float32 sigmoid and returns ``(score (B,), features)``.  The Linear
input size follows the clip geometry, so the discriminators take
``nfr`` and ``isize``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from vfd_gan_tpu_torch.models.layers import (
    DiscConvBlock,
    GenConvBlock,
    TorchLinear,
    dropout,
)
from vfd_gan_tpu_torch.ops.resize import upsample_ncdhw
from vfd_gan_tpu_torch.utils.init import dcgan_normal_


class Generator(nn.Module):
    """U-Net mask predictor; ``generator`` seeds the reference init."""

    def __init__(self, ngf: int = 32, *, drop_rate: float = 0.25,
                 device=None, generator: torch.Generator | None = None):
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
        self.drop_rate = drop_rate
        self.conv_last = nn.Conv3d(g, 1, 3, padding=1, bias=False,
                                   device=device)
        if generator is not None:
            dcgan_normal_(self.conv_last.weight, generator)

    def drop(self, y: torch.Tensor,
             generator: torch.Generator | None = None) -> torch.Tensor:
        """Decoder dropout (flax ``nn.Dropout``'s function: keep with
        probability 1 - rate, scale kept values by 1 / (1 - rate)), drawn
        from ``generator``; inert in eval mode or at rate 0."""
        return dropout(y, self.drop_rate, self.training, generator)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Mask video ``(B, 1, T, H, W)``; ``generator`` draws the dropout
        masks of a train-mode forward."""
        d1 = self.dconv1(x)
        d2 = self.dconv2(F.avg_pool3d(d1, 2))
        d3 = self.dconv3(F.avg_pool3d(d2, 2))
        d4 = self.dconv4(F.avg_pool3d(d3, 2))
        latent = self.dconv5(F.avg_pool3d(d4, 2))

        g = generator
        y = upsample_ncdhw(self.drop(self.uconv5(latent), g))
        y = upsample_ncdhw(self.drop(self.uconv4(torch.cat([y, d4], 1)), g))
        y = upsample_ncdhw(self.drop(self.uconv3(torch.cat([y, d3], 1)), g))
        y = upsample_ncdhw(self.drop(self.uconv2(torch.cat([y, d2], 1)), g))
        y = self.uconv1(torch.cat([y, d1], 1))
        return torch.sigmoid(self.conv_last(y).float())


class SpatialDisc(nn.Module):
    """Spatial branch (reference SDisc, models/mygannet.py:119-162)."""

    def __init__(self, ndf: int = 32, isize: int = 128, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        widths = [3] + [ndf * m for m in (1, 2, 4, 8, 16, 32)]
        for i in range(6):
            setattr(self, f"dconv{i + 1}", DiscConvBlock(
                widths[i], widths[i + 1], (1, 3, 3), (0, 1, 1),
                device=device, generator=generator))
        side = isize // 64
        self.linear = TorchLinear(widths[-1] * side * side, 1, device=device,
                                  generator=generator)

    def forward(self, x: torch.Tensor):
        for i in range(6):
            x = F.avg_pool3d(getattr(self, f"dconv{i + 1}")(x), (1, 2, 2))
        features = x                                 # (B, C, T, s, s)
        x = F.avg_pool3d(x, (x.shape[2], 1, 1), 1)   # global temporal pool
        score = torch.sigmoid(self.linear(x.flatten(1)).float())
        return score[:, 0], features


class TemporalDisc(nn.Module):
    """Temporal branch over the flow video (reference TDisc,
    models/mygannet.py:164-196)."""

    def __init__(self, ndf: int = 32, nfr: int = 16, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        widths = [3, ndf, ndf * 2, ndf * 4]
        for i in range(3):
            setattr(self, f"dconv{i + 1}", DiscConvBlock(
                widths[i], widths[i + 1], (3, 1, 1), (1, 0, 0),
                device=device, generator=generator))
        self.linear = TorchLinear(widths[-1] * (nfr // 8), 1, device=device,
                                  generator=generator)

    def forward(self, x: torch.Tensor):
        for i in range(3):
            x = F.avg_pool3d(getattr(self, f"dconv{i + 1}")(x), (2, 1, 1))
        features = x                                 # (B, C, T/8, H, W)
        x = F.avg_pool3d(x, (1, x.shape[3], x.shape[4]), 1)  # global spatial
        score = torch.sigmoid(self.linear(x.flatten(1)).float())
        return score[:, 0], features


class DualDisc(nn.Module):
    """Spatial + temporal discriminator pair (reference NetD);
    ``forward(rgb_video, flow_video)`` ->
    ``(s_score, s_features, t_score, t_features)``."""

    def __init__(self, ndf: int = 32, nfr: int = 16, isize: int = 128, *,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.spatdisc = SpatialDisc(ndf, isize, **kw)
        self.tempdisc = TemporalDisc(ndf, nfr, **kw)

    def forward(self, x: torch.Tensor, y: torch.Tensor):
        s_cls, s_feat = self.spatdisc(x)
        t_cls, t_feat = self.tempdisc(y)
        return s_cls, s_feat, t_cls, t_feat
