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

Every op is frame-local, so under ``--sp`` (frames sharded over ranks)
the net runs on a rank's frames as it is: its BatchNorms sum over the
grid, its decoder dropout keeps the rank's frames of the global mask and
the MoE block routes over the global token axis.

``front`` (stem and entry blocks), ``middle_blocks`` and ``back`` (exit
block to head) are the three parts that ``--pp`` runs apart
(``parallel/pp_xception.py``, JAX ``Xception3D.front``/``back``).

Under ``--tp`` (a ``parallel.mesh.TensorParallel`` bound as ``tp`` on
``SepaConv``, ``XceptionBlock``, ``DeConvBlock`` and the net) each conv
whose output channels split holds the rank's slice of its weight, as
does the BatchNorm after it (``parallel/tensor.StateShards``), and runs
column-parallel (``parallel/tensor.column``): on the rank's slice
between ``copy_in`` and ``gather``, with the channel-local ops after it
on the same slice (a SepaConv's ReLUs, the BatchNorm that follows it in
a block and the block's strided max pool; the stem's and conv3/conv4's
BatchNorm and ReLU; a decoder stage's BatchNorm and LeakyReLU).  The
residual add, the decoder's dropout and upsample, the MoE block's token
views and the 1-channel head run on whole tensors: the dropout draws
the whole tensor's mask, as at tp 1 (the ``"tp_dropout"`` control draws
it on the slice).
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
from vfd_gan_tpu_torch.parallel.tensor import column

N_MIDDLE_BLOCKS = 8
_SPATIAL = ((1, 3, 3), (0, 1, 1))
# the net's eight widths at width_mult 1, each by the state_dict prefix
# of a BatchNorm that normalises it: the stem's two, the entry blocks'
# three (the middle's), the exit block's and convs 3 and 4; a width is
# max(1, round(base * width_mult))
BASE_WIDTHS = {"bn1": 32, "bn2": 64, "block1.skipbn": 128,
               "block2.skipbn": 256, "block3.skipbn": 728,
               "block12.skipbn": 1024, "bn3": 1536, "bn4": 2048}


class SepaConv(nn.Module):
    """(1,3,3) conv -> ReLU -> pointwise conv -> ReLU, both bias-free.
    ``forward``'s ``after``: the channel-local ops that follow it (its
    BatchNorm, ...), run on the pointwise conv's slice under ``--tp``."""

    tp = None

    def __init__(self, cin: int, cout: int, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = {"bias": False, "device": device, "generator": generator}
        self.conv1 = make_conv3d(cin, cin, *_SPATIAL, **kw)
        self.pointwise = make_conv3d(cin, cout, (1, 1, 1), **kw)

    def forward(self, x: torch.Tensor, after=None) -> torch.Tensor:
        x = column(self.tp, self.conv1.out_channels, x,
                   lambda x: F.relu(self.conv1(x)))

        def tail(x):
            y = F.relu(self.pointwise(x))
            return y if after is None else after(y)
        return column(self.tp, self.pointwise.out_channels, x, tail)


class XceptionBlock(nn.Module):
    """Residual block of ``reps`` SepaConvs (reference xception.py:23-72).
    ``rep`` holds [ReLU], SepaConv, BN per repetition (the first ReLU only
    with ``start_with_relu``), then a (1,3,3) max pool for a strided
    block; the skip path is a strided pointwise conv + BN when the width or
    the stride changes."""

    tp = None

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
        skip = x if self.skip is None else column(
            self.tp, self.skip.out_channels, x,
            lambda x: self.skipbn(self.skip(x)))
        return self._rep(x) + skip

    def _rep(self, x: torch.Tensor) -> torch.Tensor:
        """``rep``, each SepaConv with the BatchNorm after it (and the
        last one's max pool) as its ``after``."""
        layers = list(self.rep)
        i = 0
        while i < len(layers):
            layer = layers[i]
            if not isinstance(layer, SepaConv):
                x = layer(x)
                i += 1
                continue
            bn = layers[i + 1]
            pool = layers[i + 2] if i + 2 < len(layers) else None
            if isinstance(pool, nn.MaxPool3d):
                x = layer(x, lambda y: pool(bn(y)))
                i += 3
            else:
                x = layer(x, bn)
                i += 2
        return x


class DeConvBlock(nn.Module):
    """(1,3,3) conv -> BN -> LeakyReLU(0.2) -> dropout -> (1,2,2) trilinear
    upsample (reference xception.py:74-89)."""

    # a parallel.mesh.DataParallel: dropout draws the global batch's masks
    dp = None
    tp = None

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
        def drop(y):
            # frames on axis 2: under --sp each rank keeps its frames of
            # the global (B, T) mask
            return dropout(y, self.drop_rate, self.training, generator,
                           self.dp, frame_dim=2)

        # under --tp the mask of the whole tensor, drawn after the gather
        # (the "tp_dropout" control: drawn on the rank's slice)
        sliced = self.tp is not None and "tp_dropout" in self.tp.local_ops

        def segment(x):
            y = F.leaky_relu(self.bn(self.conv(x)), negative_slope=0.2)
            return drop(y) if sliced else y

        y = column(self.tp, self.conv.out_channels, x, segment)
        if not sliced:
            y = drop(y)
        return upsample_ncdhw(y, (1, 2, 2))


class Xception3D(nn.Module):
    """The trunk and the upsampling decoder (reference xception.py:92-174);
    ``(B, C, T, H, W)`` -> ``(B, 1, T, H, W)``."""

    tp = None

    def __init__(self, in_channels: int = 3, width_mult: float = 1.0, *,
                 drop_rate: float = 0.25, moe_experts: int = 0,
                 moe_capacity: float = 2.0,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        c1, c2, e1, e2, mid, ex, c3, c4 = (
            max(1, round(base * width_mult)) for base in BASE_WIDTHS.values())
        kw = {"device": device, "generator": generator}
        bn = {"dtype": dtype, **kw}
        self.conv1 = make_conv3d(in_channels, c1, (1, 3, 3), (0, 1, 1),
                                 stride=(1, 2, 2), bias=False, **kw)
        self.bn1 = VideoBatchNorm(c1, **bn)
        self.conv2 = make_conv3d(c1, c2, *_SPATIAL, bias=False, **kw)
        self.bn2 = VideoBatchNorm(c2, **bn)
        self.block1 = XceptionBlock(c2, e1, 2, 2, False, True, **bn)
        self.block2 = XceptionBlock(e1, e2, 2, 2, False, True, **bn)
        self.block3 = XceptionBlock(e2, mid, 2, 2, False, True, **bn)
        for i in range(N_MIDDLE_BLOCKS):
            setattr(self, f"block{i + 4}",
                    XceptionBlock(mid, mid, 3, 1, True, True, **bn))
        self.block12 = XceptionBlock(mid, ex, 2, 1, True, False, **bn)
        self.conv3 = SepaConv(ex, c3, **kw)
        self.bn3 = VideoBatchNorm(c3, **bn)
        self.conv4 = SepaConv(c3, c4, **kw)
        self.bn4 = VideoBatchNorm(c4, **bn)
        widths = (c4, ex, e2, e1, c1)
        for i in range(4):
            setattr(self, f"uconv{i + 1}", DeConvBlock(
                widths[i], widths[i + 1], drop_rate=drop_rate, **bn))
        # with bias: PyTorch's default over the 3x3 taps, as the JAX head's
        self.conv_last = make_conv3d(c1, 1, *_SPATIAL, **kw)
        self.moe = MoEMlp(mid, moe_experts, capacity_factor=moe_capacity,
                          dtype=dtype, **kw) if moe_experts else None

    @staticmethod
    def width_from_state_dict(sd: dict) -> float:
        """A ``width_mult`` whose widths are those of the checkpoint
        ``sd``: the middle of the multipliers that round each width of
        ``BASE_WIDTHS`` to its BatchNorm's in ``sd`` (a width of 1 takes
        every multiplier below 1.5 / base: the clamp).  One width's ratio
        alone can round another width otherwise (at 0.05, 102 / 2048
        makes conv3 76 wide, not 77)."""
        lo, hi = 0.0, float("inf")
        for key, base in BASE_WIDTHS.items():
            if f"{key}.weight" not in sd:   # (no skip: widths equal)
                continue
            n = sd[f"{key}.weight"].shape[0]
            if n > 1:
                lo = max(lo, (n - 0.5) / base)
            hi = min(hi, (n + 0.5) / base)
        return (lo + hi) / 2

    def middle_blocks(self) -> list:
        """The eight identity middle blocks, in order (``--pp`` pipelines
        them, ``parallel/pp_xception.py``)."""
        return [getattr(self, f"block{i + 4}")
                for i in range(N_MIDDLE_BLOCKS)]

    def front(self, x: torch.Tensor) -> torch.Tensor:
        """The stem and the three entry blocks."""
        x = column(self.tp, self.conv1.out_channels, x,
                   lambda x: F.relu(self.bn1(self.conv1(x))))
        x = column(self.tp, self.conv2.out_channels, x,
                   lambda x: F.relu(self.bn2(self.conv2(x))))
        for i in range(1, 4):
            x = getattr(self, f"block{i}")(x)
        return x

    def back(self, x: torch.Tensor,
             generator: torch.Generator | None = None) -> torch.Tensor:
        """The exit block, convs 3-4, the decoder and the head."""
        x = self.block12(x)
        x = self.conv3(x, lambda y: F.relu(self.bn3(y)))
        x = self.conv4(x, lambda y: F.relu(self.bn4(y)))
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
