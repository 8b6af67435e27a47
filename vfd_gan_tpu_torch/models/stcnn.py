"""(2+1)D residual autoencoder, the "c2plus1d" model (port of
``vfd_gan_tpu.models.stcnn``).

Reference models/mystcnn.py:6-88.  A block runs a spatial (1,3,3) conv +
BN + ReLU, then a temporal (3,1,1) conv + BN + ReLU, beside a 1x1x1-conv
residual path (with bias); a down block average-pools both paths by 2, an
up block upsamples both (trilinear, align_corners) and drops the residual
path's input with rate 0.25 first; the two paths are concatenated and
fused by a 3x3x3 conv.  The autoencoder stacks 4 down and 4 up blocks
with U-Net skip concats and a bias-free 3x3x3 sigmoid head.  NCDHW
``(B, 3, T, H, W)``; T, H and W must divide by 16.

Submodule names are the reference's (``down_sep{i}``/``up_sep{i}`` with
``spaceconv``, ``bn1``, ``pointwise``, ``bn2``, ``conv``, ``conv_last``),
so ``state_dict`` keys match its ``.pth`` files.  ``drop_rate`` (default
the reference's 0.25) can be set to 0 for a deterministic train forward;
the masks come from the ``torch.Generator`` passed to ``forward``.
``dtype`` is the compute dtype of ``models/layers.py`` (the first block's
spatial conv and residual projection take the float32 clip; the head
casts to float32 before the sigmoid).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from vfd_gan_tpu_torch.models.layers import (
    VideoBatchNorm,
    dropout,
    make_conv3d,
)
from vfd_gan_tpu_torch.ops.convs import avg_pool_ncdhw
from vfd_gan_tpu_torch.ops.resize import upsample_ncdhw

DOWN = (64, 128, 256, 512)
UP = (256, 256, 128, 64)


class C2Plus1dBlock(nn.Module):
    """Residual factored-conv block (reference mystcnn.py:6-49)."""

    def __init__(self, cin: int, cout: int, down_samp: bool, *,
                 drop_rate: float = 0.25, dtype: torch.dtype = torch.float32,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.down_samp = down_samp
        self.drop_rate = drop_rate
        self.spaceconv = make_conv3d(cin, cin, (1, 3, 3), (0, 1, 1),
                                     bias=False, **kw)
        self.bn1 = VideoBatchNorm(cin, dtype=dtype, **kw)
        self.pointwise = make_conv3d(cin, cout, (3, 1, 1), (1, 0, 0),
                                     bias=False, **kw)
        self.bn2 = VideoBatchNorm(cout, dtype=dtype, **kw)
        self.conv = make_conv3d(cin, cout, (1, 1, 1), **kw)
        self.conv_last = make_conv3d(2 * cout, cout, (3, 3, 3), (1, 1, 1),
                                     bias=False, **kw)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        y = F.relu(self.bn1(self.spaceconv(x)))
        y = F.relu(self.bn2(self.pointwise(y)))
        # the projection's biased sum (float32 below float32, see Conv3d)
        # rounds to the dtype JAX gives it, x's (JAX stcnn.py:52-62)
        if self.down_samp:
            y = avg_pool_ncdhw(y, 2)
            residual = avg_pool_ncdhw(self.conv(x), 2).to(x.dtype)
        else:
            y = upsample_ncdhw(y)
            residual = dropout(x, self.drop_rate, self.training, generator)
            residual = self.conv(upsample_ncdhw(residual)).to(x.dtype)
        return self.conv_last(torch.cat([y, residual], 1))


class AutoEncoder(nn.Module):
    """4-down / 4-up residual (2+1)D autoencoder with skip concats
    (reference mystcnn.py:52-88); ``(B, 3, T, H, W)`` -> ``(B, 1, T, H,
    W)``."""

    def __init__(self, *, drop_rate: float = 0.25,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = {"drop_rate": drop_rate, "dtype": dtype, "device": device,
              "generator": generator}
        cin = 3
        for i, f in enumerate(DOWN):
            setattr(self, f"down_sep{i + 1}", C2Plus1dBlock(cin, f, True,
                                                            **kw))
            cin = f
        # each up block after the first takes [up, skip] concatenated
        skips = (0, DOWN[2], DOWN[1], DOWN[0])
        for i, f in enumerate(UP):
            cin = (UP[i - 1] if i else DOWN[-1]) + skips[i]
            setattr(self, f"up_sep{i + 1}", C2Plus1dBlock(cin, f, False,
                                                          **kw))
        self.conv_last = make_conv3d(UP[-1], 1, (3, 3, 3), (1, 1, 1),
                                     bias=False, device=device,
                                     generator=generator)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        g = generator
        d1 = self.down_sep1(x)
        d2 = self.down_sep2(d1)
        d3 = self.down_sep3(d2)
        d4 = self.down_sep4(d3)
        y = self.up_sep1(d4, g)
        y = self.up_sep2(torch.cat([y, d3], 1), g)
        y = self.up_sep3(torch.cat([y, d2], 1), g)
        y = self.up_sep4(torch.cat([y, d1], 1), g)
        return torch.sigmoid(self.conv_last(y).float())
