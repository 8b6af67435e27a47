"""GANomaly: encoder-decoder-encoder anomaly detection on frames (port of
``vfd_gan_tpu.models.ganomaly``).

A DCGAN pyramid encoder and decoder on NCHW frames ``(N, C, H, W)`` (the
engine folds a clip's frames into the batch); the generator is Encoder ->
Decoder -> Encoder and the anomaly score of a frame is ``mean((z_in -
z_out)^2)`` (JAX models/ganomaly.py:46-192, the canonical GANomaly of the
reference's vendored, dead copy, models/ganomaly.py:160-175,372).  The
reference has no trained GANomaly and so no ``.pth`` layout: the
submodule names here are the port's own, one per JAX parameter
(``stem``, ``extra.{t}``, ``pyramid.{i}``, ``final``; ``conv`` and ``bn``
inside a block), and ``utils/weights.py`` maps the JAX tree onto them.

Every conv is bias-free with kernels ~ N(0, 0.02) and BatchNorm scales ~
N(1, 0.02).  ``dtype`` is the compute dtype of ``models/layers.py``: a
conv runs in its input's dtype, so an encoder fed float32 frames runs its
stem and its first pyramid conv in float32 (no BatchNorm lies between
them), as in JAX; the rest runs in ``dtype`` from the first BatchNorm on;
the decoder's tanh and the discriminator's sigmoid are float32.

Under ``--tp`` (a ``parallel.mesh.TensorParallel`` bound as ``tp`` on the
encoders, the decoder and the discriminator) each conv whose output
channels split, and the BatchNorm after it, holds the rank's slice
(``parallel/tensor.StateShards``; a ``ConvTranspose2d`` weight ``(Cin,
Cout, kh, kw)`` its ``weight[:, rows]``) and runs column-parallel
(``parallel/tensor.column``): on the rank's slice between ``copy_in``
and ``gather``, its BatchNorm and activation on the same slice.  The
100-channel latent splits at tp 2 and 4 and is gathered whole before the
decoder and the anomaly score; the 3-channel decoder output and the
1-channel classifier run whole on every rank.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from vfd_gan_tpu_torch.models.layers import (
    Conv2d,
    ConvTranspose2d,
    FrameBatchNorm,
    float32_or_wider,
)
from vfd_gan_tpu_torch.parallel.tensor import column
from vfd_gan_tpu_torch.utils.init import dcgan_normal_


def _init(conv: nn.Module, generator) -> nn.Module:
    if generator is not None:
        dcgan_normal_(conv.weight, generator)
    return conv


class ConvBlock2d(nn.Module):
    """A bias-free (transposed) conv and its BatchNorm."""

    tp = None

    def __init__(self, conv: nn.Module, features: int, **bkw):
        super().__init__()
        self.conv = _init(conv, bkw.get("generator"))
        self.bn = FrameBatchNorm(features, **bkw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))

    def activated(self, x: torch.Tensor, act) -> torch.Tensor:
        """``act(bn(conv(x)))``; under ``--tp`` column-parallel where the
        conv's output channels split."""
        return column(self.tp, self.conv.out_channels, x,
                      lambda x: act(self(x)))


class DcganEncoder(nn.Module):
    """Strided 4x4-conv pyramid: isize -> 4, then a 4x4 VALID conv to an
    ``(N, nz, 1, 1)`` latent unless ``add_final_conv`` is off (reference
    Encoder, ganomaly.py:24-76)."""

    tp = None

    def __init__(self, isize: int, nz: int, nc: int = 3, ndf: int = 64,
                 n_extra_layers: int = 0, add_final_conv: bool = True, *,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if isize % 16:
            raise ValueError(f"isize must be a multiple of 16, got {isize}")
        bkw = {"dtype": dtype, "device": device, "generator": generator}
        self.stem = _init(Conv2d(nc, ndf, 4, 2, 1, bias=False,
                                 device=device), generator)
        self.extra = nn.ModuleList(
            ConvBlock2d(Conv2d(ndf, ndf, 3, 1, 1, bias=False, device=device),
                        ndf, **bkw) for _ in range(n_extra_layers))
        pyramid, feat, size = [], ndf, isize // 2
        while size > 4:
            pyramid.append(ConvBlock2d(
                Conv2d(feat, feat * 2, 4, 2, 1, bias=False, device=device),
                feat * 2, **bkw))
            feat, size = feat * 2, size // 2
        self.pyramid = nn.ModuleList(pyramid)
        self.features = feat
        self.final = _init(Conv2d(feat, nz, 4, 1, 0, bias=False,
                                  device=device), generator) \
            if add_final_conv else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tp = self.tp
        x = column(tp, self.stem.out_channels, x,
                   lambda x: F.leaky_relu(self.stem(x), 0.2))
        for block in (*self.extra, *self.pyramid):
            x = block.activated(x, lambda y: F.leaky_relu(y, 0.2))
        if self.final is None:
            return x
        return column(tp, self.final.out_channels, x, self.final)


class DcganDecoder(nn.Module):
    """Transposed-conv pyramid: ``(N, nz, 1, 1)`` -> ``(N, nc, isize,
    isize)``, float32 tanh output (reference Decoder, ganomaly.py:79-131)."""

    tp = None

    def __init__(self, isize: int, nz: int, nc: int = 3, ngf: int = 64,
                 n_extra_layers: int = 0, *,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if isize % 16:
            raise ValueError(f"isize must be a multiple of 16, got {isize}")
        bkw = {"dtype": dtype, "device": device, "generator": generator}
        feat, tisize = ngf // 2, 4
        while tisize != isize:
            feat, tisize = feat * 2, tisize * 2
        self.stem = ConvBlock2d(
            ConvTranspose2d(nz, feat, 4, 1, 0, bias=False, device=device),
            feat, **bkw)
        pyramid, size = [], 4
        while size < isize // 2:
            pyramid.append(ConvBlock2d(
                ConvTranspose2d(feat, feat // 2, 4, 2, 1, bias=False,
                                device=device), feat // 2, **bkw))
            feat, size = feat // 2, size * 2
        self.pyramid = nn.ModuleList(pyramid)
        self.extra = nn.ModuleList(
            ConvBlock2d(Conv2d(feat, feat, 3, 1, 1, bias=False,
                               device=device), feat, **bkw)
            for _ in range(n_extra_layers))
        self.final = _init(ConvTranspose2d(feat, nc, 4, 2, 1, bias=False,
                                           device=device), generator)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = z
        for block in (self.stem, *self.pyramid, *self.extra):
            x = block.activated(x, F.relu)
        x = column(self.tp, self.final.out_channels, x, self.final)
        return torch.tanh(float32_or_wider(x))


class GanomalyGenerator(nn.Module):
    """Encoder -> Decoder -> Encoder; returns ``(fake (N, nc, H, W), z_in
    (N, nz), z_out (N, nz))`` (reference NetG, ganomaly.py:160-186)."""

    def __init__(self, isize: int, nz: int = 100, nc: int = 3, ngf: int = 64,
                 n_extra_layers: int = 0, *,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = {"n_extra_layers": n_extra_layers, "dtype": dtype,
              "device": device, "generator": generator}
        self.enc1 = DcganEncoder(isize, nz, nc, ngf, **kw)
        self.dec = DcganDecoder(isize, nz, nc, ngf, **kw)
        self.enc2 = DcganEncoder(isize, nz, nc, ngf, **kw)

    def forward(self, x: torch.Tensor):
        z_in = self.enc1(x)
        fake = self.dec(z_in)
        z_out = self.enc2(fake)
        return fake, z_in[:, :, 0, 0], z_out[:, :, 0, 0]


class GanomalyDiscriminator(nn.Module):
    """Encoder trunk -> features; a 4x4 conv + float32 sigmoid classifier;
    returns ``(score (N,), features)`` (reference NetD,
    ganomaly.py:139-158)."""

    tp = None

    def __init__(self, isize: int, nc: int = 3, ngf: int = 64,
                 n_extra_layers: int = 0, *,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.trunk = DcganEncoder(isize, 1, nc, ngf, n_extra_layers,
                                  add_final_conv=False, dtype=dtype,
                                  device=device, generator=generator)
        self.classifier = _init(Conv2d(self.trunk.features, 1, 4, 1, 0,
                                       bias=False, device=device), generator)

    def forward(self, x: torch.Tensor):
        feat = self.trunk(x)
        score = torch.sigmoid(float32_or_wider(column(
            self.tp, self.classifier.out_channels, feat, self.classifier)))
        return score.reshape(-1), feat


def ganomaly_anomaly_score(z_in: torch.Tensor,
                           z_out: torch.Tensor) -> torch.Tensor:
    """Per-sample mean of ``(z_in - z_out)^2`` (reference
    ganomaly.py:372)."""
    return (z_in - z_out).square().mean(dim=-1)
