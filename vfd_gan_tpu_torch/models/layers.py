"""Building blocks of the port's models (port of ``vfd_gan_tpu.models.layers``).

NCDHW ``(B, C, T, H, W)`` input.  Submodule names are the reference's, so
``state_dict`` keys match the ``.pth`` files the reference and
``vfd_gan_tpu.utils.torch_export`` write:

* ``STConv``       <- models/spatiotempconv.py:7-65 (R(2+1)D factored conv):
  ``spatial_conv``, ``bn`` (the mid BN), ``temporal_conv``
* ``GenConvBlock`` <- models/mygannet.py:13-28: ``conv`` (STConv), ``bn``
* ``DiscConvBlock``<- models/mygannet.py:104-116 (NetdConv): the same
  submodules, any kernel, LeakyReLU at torch's default slope 0.01
* ``TorchLinear``: ``nn.Linear`` with the reference's init (the
  reference's ``weights_init`` skips Linear layers, so PyTorch's default
  U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias)
* ``VideoBatchNorm``: ``nn.BatchNorm3d`` with torch's eps 1e-5 and
  momentum 0.1, whose running statistics the eval forward uses.
* ``dropout``: flax ``nn.Dropout``'s function with masks drawn from a
  ``torch.Generator``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from vfd_gan_tpu_torch.ops.convs import r2plus1d_mid_channels
from vfd_gan_tpu_torch.utils.init import bn_scale_, dcgan_normal_, torch_default_


class VideoBatchNorm(nn.BatchNorm3d):
    """BatchNorm over (B, T, H, W) per channel, scale ~ N(1, 0.02)."""

    def __init__(self, features: int, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__(features, eps=1e-5, momentum=0.1, device=device)
        if generator is not None:
            bn_scale_(self.weight, generator)


def make_conv3d(cin: int, cout: int, kernel, padding=(0, 0, 0), *,
                stride=(1, 1, 1), bias: bool = True, device=None,
                generator: torch.Generator | None = None) -> nn.Conv3d:
    """``nn.Conv3d`` with the reference init drawn from ``generator``:
    kernel ~ N(0, 0.02), bias PyTorch's default over the kernel's fan-in."""
    conv = nn.Conv3d(cin, cout, tuple(kernel), stride=tuple(stride),
                     padding=tuple(padding), bias=bias, device=device)
    if generator is not None:
        dcgan_normal_(conv.weight, generator)
        if bias:
            fan_in = cin * kernel[0] * kernel[1] * kernel[2]
            torch_default_(conv.bias, fan_in, generator)
    return conv


class STConv(nn.Module):
    """Factored (2+1)D convolution, stride 1 with biases: spatial (1,kh,kw)
    conv -> BN -> ReLU -> temporal (kt,1,1) conv, intermediate width from
    the R(2+1)D formula."""

    def __init__(self, cin: int, cout: int,
                 kernel_size: Sequence[int] = (3, 3, 3),
                 padding: Sequence[int] = (0, 0, 0), *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        kt, kh, kw = kernel_size
        pt, ph, pw = padding
        mid = r2plus1d_mid_channels(kt, kh, kw, cin, cout)
        self.spatial_conv = make_conv3d(cin, mid, (1, kh, kw), (0, ph, pw),
                                        device=device, generator=generator)
        self.bn = VideoBatchNorm(mid, device=device, generator=generator)
        self.temporal_conv = make_conv3d(mid, cout, (kt, 1, 1), (pt, 0, 0),
                                         device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.temporal_conv(F.relu(self.bn(self.spatial_conv(x))))


class GenConvBlock(nn.Module):
    """STConv -> BN -> LeakyReLU(0.2): the generator's conv block
    (models/mygannet.py:13-28, 3x3x3 with SAME padding)."""

    def __init__(self, cin: int, cout: int, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv = STConv(cin, cout, (3, 3, 3), padding=(1, 1, 1),
                           device=device, generator=generator)
        self.bn = VideoBatchNorm(cout, device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(self.bn(self.conv(x)), negative_slope=0.2)


class DiscConvBlock(nn.Module):
    """STConv -> BN -> LeakyReLU(0.01): the discriminator's conv block
    (models/mygannet.py:104-116; note the default slope, not 0.2)."""

    def __init__(self, cin: int, cout: int, kernel_size: Sequence[int],
                 padding: Sequence[int], *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv = STConv(cin, cout, kernel_size, padding=padding,
                           device=device, generator=generator)
        self.bn = VideoBatchNorm(cout, device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(self.bn(self.conv(x)), negative_slope=0.01)


def dropout(y: torch.Tensor, rate: float, training: bool,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """flax ``nn.Dropout``'s function: keep with probability 1 - rate and
    scale kept values by 1 / (1 - rate), the mask drawn from ``generator``;
    inert out of training mode or at rate 0."""
    if not training or rate == 0.0:
        return y
    keep = torch.rand(y.shape, generator=generator, device=y.device) >= rate
    return torch.where(keep, y / (1.0 - rate),
                       torch.zeros((), dtype=y.dtype, device=y.device))


class TorchLinear(nn.Linear):
    """``nn.Linear`` with PyTorch's default init drawn from ``generator``."""

    def __init__(self, fan_in: int, features: int, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__(fan_in, features, device=device)
        if generator is not None:
            torch_default_(self.weight, fan_in, generator)
            torch_default_(self.bias, fan_in, generator)
