"""Xception-3D mask predictor (port of ``vfd_gan_tpu.models.xception3d``).

Reference models/xception.py:7-174: an Xception trunk whose every kernel
is spatial-only (1,3,3) or pointwise: a stem of two convs (the first with
spatial stride 2), three strided residual entry blocks (64 -> 128 -> 256
-> 728), eight identity middle blocks at 728, an exit block (728 -> 1024,
grow last), two SepaConvs (1536, 2048), four decoder stages that upsample
(1, 2, 2) and a 1-channel (1,3,3) head with bias and a float32 sigmoid.
NCDHW ``(B, C, T, H, W)``; H and W must divide by 16.

The reference's "SepaConv" is a full (1,3,3) conv and a full pointwise
conv, each followed by ReLU (xception.py:7-21).  Submodule names and
``rep`` indices are the reference's (``block{i}.rep.{j}``, ``skip``,
``skipbn``, ``conv1..4``, ``bn1..4``, ``uconv{i}``, ``conv_last``), so
``state_dict`` keys match its ``.pth`` files.  ``width_mult`` (the
trainer's ``--xwidth``) scales every width as the JAX model does;
``drop_rate`` (default 0.25) is the decoder dropout, drawn from the
``torch.Generator`` passed to ``forward``.  ``dtype`` is the compute dtype
of ``models/layers.py`` (the stem's first conv takes the float32 clip; the
head casts to float32 before the sigmoid).

``moe_experts`` > 0 (the trainer's ``--moe_experts``, no reference
equivalent) puts a residual token-MoE block (``models/moe_block.py``,
capacity factor ``moe_capacity``, 2.0 as in JAX) after the eight middle
blocks, under the name ``moe``; it is built after every reference module,
so the other modules' initial weights do not depend on it.

``front`` (stem and entry blocks), ``middle_blocks`` and ``back`` (exit
block to head) are the three parts that ``--pp`` runs apart
(``parallel/pp_xception.py``, JAX ``Xception3D.front``/``back``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from vfd_gan_tpu_torch.models.layers import (
    VideoBatchNorm,
    dropout,
    float32_or_wider,
    make_conv3d,
)
from vfd_gan_tpu_torch.models.moe_block import MoEMlp
from vfd_gan_tpu_torch.ops.resize import upsample_ncdhw

N_MIDDLE_BLOCKS = 8
_SPATIAL = ((1, 3, 3), (0, 1, 1))


class SepaConv(nn.Module):
    """(1,3,3) conv -> ReLU -> pointwise conv -> ReLU, both bias-free."""

    def __init__(self, cin: int, cout: int, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = {"bias": False, "device": device, "generator": generator}
        self.conv1 = make_conv3d(cin, cin, *_SPATIAL, **kw)
        self.pointwise = make_conv3d(cin, cout, (1, 1, 1), **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.pointwise(F.relu(self.conv1(x))))


class XceptionBlock(nn.Module):
    """Residual block of ``reps`` SepaConvs (reference xception.py:23-72).
    ``rep`` holds [ReLU], SepaConv, BN per repetition (the first ReLU only
    with ``start_with_relu``), then a (1,3,3) max pool for a strided
    block; the skip path is a strided pointwise conv + BN when the width or
    the stride changes."""

    def __init__(self, cin: int, cout: int, reps: int, strides: int = 1,
                 start_with_relu: bool = True, grow_first: bool = True, *,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        bn = {"dtype": dtype, **kw}
        if grow_first:
            widths = [cout] * reps
        else:
            widths = [cin] * (reps - 1) + [cout]
        layers: list[nn.Module] = []
        width = cin
        for i, w in enumerate(widths):
            if i > 0 or start_with_relu:
                layers.append(nn.ReLU())
            layers += [SepaConv(width, w, **kw), VideoBatchNorm(w, **bn)]
            width = w
        if strides != 1:
            layers.append(nn.MaxPool3d((1, 3, 3), (1, strides, strides),
                                       (0, 1, 1)))
        self.rep = nn.Sequential(*layers)
        self.skip = self.skipbn = None
        if cout != cin or strides != 1:
            self.skip = make_conv3d(cin, cout, (1, 1, 1),
                                    stride=(1, strides, strides), bias=False,
                                    **kw)
            self.skipbn = VideoBatchNorm(cout, **bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skip = x if self.skip is None else self.skipbn(self.skip(x))
        return self.rep(x) + skip


class DeConvBlock(nn.Module):
    """(1,3,3) conv -> BN -> LeakyReLU(0.2) -> dropout -> (1,2,2) trilinear
    upsample (reference xception.py:74-89)."""

    # a parallel.mesh.DataParallel: dropout draws the global batch's masks
    dp = None

    def __init__(self, cin: int, cout: int, *, drop_rate: float = 0.25,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.drop_rate = drop_rate
        self.conv = make_conv3d(cin, cout, *_SPATIAL, bias=False,
                                device=device, generator=generator)
        self.bn = VideoBatchNorm(cout, dtype=dtype, device=device,
                                 generator=generator)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        y = F.leaky_relu(self.bn(self.conv(x)), negative_slope=0.2)
        y = dropout(y, self.drop_rate, self.training, generator, self.dp)
        return upsample_ncdhw(y, (1, 2, 2))


class Xception3D(nn.Module):
    """The trunk and the upsampling decoder (reference xception.py:92-174);
    ``(B, C, T, H, W)`` -> ``(B, 1, T, H, W)``."""

    def __init__(self, in_channels: int = 3, width_mult: float = 1.0, *,
                 drop_rate: float = 0.25, moe_experts: int = 0,
                 moe_capacity: float = 2.0,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()

        def w(c: int) -> int:
            return max(1, round(c * width_mult))

        kw = {"device": device, "generator": generator}
        bn = {"dtype": dtype, **kw}
        self.conv1 = make_conv3d(in_channels, w(32), (1, 3, 3), (0, 1, 1),
                                 stride=(1, 2, 2), bias=False, **kw)
        self.bn1 = VideoBatchNorm(w(32), **bn)
        self.conv2 = make_conv3d(w(32), w(64), *_SPATIAL, bias=False, **kw)
        self.bn2 = VideoBatchNorm(w(64), **bn)
        self.block1 = XceptionBlock(w(64), w(128), 2, 2, False, True, **bn)
        self.block2 = XceptionBlock(w(128), w(256), 2, 2, False, True, **bn)
        self.block3 = XceptionBlock(w(256), w(728), 2, 2, False, True, **bn)
        for i in range(N_MIDDLE_BLOCKS):
            setattr(self, f"block{i + 4}",
                    XceptionBlock(w(728), w(728), 3, 1, True, True, **bn))
        self.block12 = XceptionBlock(w(728), w(1024), 2, 1, True, False, **bn)
        self.conv3 = SepaConv(w(1024), w(1536), **kw)
        self.bn3 = VideoBatchNorm(w(1536), **bn)
        self.conv4 = SepaConv(w(1536), w(2048), **kw)
        self.bn4 = VideoBatchNorm(w(2048), **bn)
        widths = (w(2048), w(1024), w(256), w(128), w(32))
        for i in range(4):
            setattr(self, f"uconv{i + 1}", DeConvBlock(
                widths[i], widths[i + 1], drop_rate=drop_rate, **bn))
        # with bias: PyTorch's default over the 3x3 taps, as the JAX head's
        self.conv_last = make_conv3d(w(32), 1, *_SPATIAL, **kw)
        self.moe = MoEMlp(w(728), moe_experts, capacity_factor=moe_capacity,
                          dtype=dtype, **kw) if moe_experts else None

    def middle_blocks(self) -> list:
        """The eight identity middle blocks, in order (``--pp`` pipelines
        them, ``parallel/pp_xception.py``)."""
        return [getattr(self, f"block{i + 4}")
                for i in range(N_MIDDLE_BLOCKS)]

    def front(self, x: torch.Tensor) -> torch.Tensor:
        """The stem and the three entry blocks."""
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        for i in range(1, 4):
            x = getattr(self, f"block{i}")(x)
        return x

    def back(self, x: torch.Tensor,
             generator: torch.Generator | None = None) -> torch.Tensor:
        """The exit block, convs 3-4, the decoder and the head."""
        x = self.block12(x)
        x = F.relu(self.bn3(self.conv3(x)))
        x = F.relu(self.bn4(self.conv4(x)))
        for i in range(1, 5):
            x = getattr(self, f"uconv{i}")(x, generator)
        return torch.sigmoid(float32_or_wider(self.conv_last(x)))

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = self.front(x)
        for block in self.middle_blocks():
            x = block(x)
        if self.moe is not None:
            x = self.moe(x)
        return self.back(x, generator)
