"""AnoGAN: the DCGAN-style video GAN baseline (port of
``vfd_gan_tpu.models.anogan``).

Reference models/anogan.py:39-119, NCDHW video:

* ``AnoGenerator``: z in R^100 -> Linear + BatchNorm1d + ReLU -> a (512,
  T/8, S/8, S/8) volume (reshaped in torch's (C, T, H, W) order) -> four
  stages of [Dropout, transposed 3x3x3 conv, 3x3x3 conv], the first three
  followed by BatchNorm + LeakyReLU(0.01) -> float32 sigmoid RGB video.
  The reference hardcodes nfr 16 and isize 128 (anogan.py:45,76); the
  seed volume here follows ``nfr`` and ``isize``, which must divide by 8.
* ``AnoDiscriminator``: 3x3x3 convs with BatchNorm, LeakyReLU and
  AvgPool(2) between stages, then Linear + float32 sigmoid; returns
  ``(score (B,), features)``, the features flattened in NCDHW order.  It
  keeps the reference's ``nn.LeakyReLU(64)`` after its second BatchNorm, a
  negative slope of 64 (anogan.py:91), since it shapes the trained net.

Submodule names and indices are the reference's Sequential ones
(``layer1.0`` the Linear, ``layer2.1`` the first transposed conv, ...,
``fc.0``), so ``state_dict`` keys are those of its ``.pth`` files and of
``vfd_gan_tpu.utils.torch_export.anogan_{generator,discriminator}_to_torch``.
The parameter-free slots of the reference's Sequentials (Dropout, ReLU,
LeakyReLU, AvgPool) are computed in ``forward``.

Under ``--sp`` (``parallel.mesh.SeqParallel`` bound as ``sp``) both nets
run on this rank's frames.  G's seed Linear and ``BatchNorm1d`` run
replicated on the row's peers (the row shares ``z``), and its seed volume
of nfr/8 frames splits over the row once the shards hold whole frames
(at once at sp 2 and nfr 16; at sp 4 after the first stage).  A stride-2
transposed conv's output frames ``[2a, 2b)`` read input frames ``a .. b``:
a right halo of one frame, zeros past the last shard, which add nothing
(``ConvTranspose3d.valid_t``); the stride-1 one and every 3x3x3 conv take
one halo frame a side, and the dropout keeps the rank's frames of the
global mask.  D's convs take one halo frame a side, its pools are local
while a shard holds an even count (else the frames are gathered first),
and its pooled block is gathered before the flatten, so the Linear reads
the whole clip's features and every peer holds every clip's score.

``dtype`` is the compute dtype of ``models/layers.py``.  As in JAX: the
Linear runs in ``dtype``; a transposed conv's biased sum is read by the
conv after it in ``dtype``, and so is the discriminator's first conv of a
pair; the discriminator's first conv takes the float32 clip; the heads are
float32 before the sigmoid.  Dropout masks come from the
``torch.Generator`` passed to ``forward``.
"""

from __future__ import annotations

from contextlib import nullcontext

import torch
import torch.nn as nn
import torch.nn.functional as F

from vfd_gan_tpu_torch.models.layers import (
    BatchNorm1d,
    ConvTranspose3d,
    TorchLinear,
    VideoBatchNorm,
    dropout,
    float32_or_wider,
    frame_shards,
    make_conv3d,
)
from vfd_gan_tpu_torch.ops.convs import avg_pool_ncdhw
from vfd_gan_tpu_torch.utils.init import torch_default_

Z_DIM = 100
SEED_CHANNELS = 512


def _transpose_conv(cin: int, cout: int, stride: int, out_pad: int, *,
                    device=None, generator=None) -> ConvTranspose3d:
    """3x3x3 ``ConvTranspose3d`` with padding 1 and PyTorch's default init
    (the reference's ``weights_init`` skips it): fan-in ``cout * 27``."""
    conv = ConvTranspose3d(cin, cout, 3, stride=stride, padding=1,
                           output_padding=out_pad, device=device)
    if generator is not None:
        torch_default_(conv.weight, cout * 27, generator)
        torch_default_(conv.bias, cout * 27, generator)
    return conv


class AnoGenerator(nn.Module):
    """z -> video generator (reference NetG, anogan.py:39-79);
    ``generator`` seeds the reference init."""

    # a parallel.mesh.DataParallel: dropout draws the global batch's masks
    dp = None
    # a parallel.mesh.SeqParallel (--sp): the output is this rank's frames
    sp = None

    def __init__(self, nfr: int = 16, isize: int = 128, *,
                 drop_rate: float = 0.25, dtype: torch.dtype = torch.float32,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        if nfr % 8 or isize % 8:
            raise ValueError(f"AnoGAN needs nfr and isize divisible by 8 "
                             f"(the reference hardcodes 16/128), got "
                             f"nfr={nfr} isize={isize}")
        self.seed_shape = (SEED_CHANNELS, nfr // 8, isize // 8, isize // 8)
        self.drop_rate = drop_rate
        self.dtype = dtype
        kw = {"device": device, "generator": generator}
        bkw = {"dtype": dtype, **kw}
        feat = SEED_CHANNELS * self.seed_shape[1] * self.seed_shape[2] ** 2
        self.layer1 = nn.ModuleDict({"0": TorchLinear(Z_DIM, feat, **bkw),
                                     "1": BatchNorm1d(feat, **bkw)})

        def stage(cin, cout, stride, out_pad):
            """Dropout (slot 0), transposed conv (1), conv (2)."""
            return {"1": _transpose_conv(cin, cout, stride, out_pad, **kw),
                    "2": make_conv3d(cout, cout, (3, 3, 3), (1, 1, 1), **kw)}

        def shifted(d: dict) -> dict:
            return {str(int(k) + 5): v for k, v in d.items()}

        self.layer2 = nn.ModuleDict({
            **stage(512, 256, 2, 1), "3": VideoBatchNorm(256, **bkw),
            **shifted(stage(256, 128, 2, 1)), "8": VideoBatchNorm(128, **bkw)})
        self.layer3 = nn.ModuleDict({
            **stage(128, 64, 1, 0), "3": VideoBatchNorm(64, **bkw),
            **shifted(stage(64, 3, 2, 1))})

    def _up(self, layer: nn.ModuleDict, i: int, x: torch.Tensor,
            generator, sp) -> torch.Tensor:
        """Dropout, then the transposed conv at slot ``i + 1`` and the conv
        at ``i + 2``; the transposed conv's biased sum is read in the
        stage input's dtype.  With ``sp`` on this rank's frames: the
        dropout keeps them of the global mask, a stride-2 transposed conv
        takes a right halo of one frame, the stride-1 one and the conv
        after it one halo frame a side."""
        x = dropout(x, self.drop_rate, self.training, generator, self.dp,
                    frame_dim=None if sp is None else 2)
        tconv, conv = layer[str(i + 1)], layer[str(i + 2)]
        if sp is None:
            return conv(tconv(x).to(x.dtype))
        left = int(tconv.stride[0] == 1)
        y = tconv.valid_t(sp.halo(x, 1, left=bool(left)), left, x.shape[2])
        return conv.valid_t(sp.halo(y.to(x.dtype), 1))

    def forward(self, z: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Video ``(B, 3, T, H, W)`` in (0, 1) from ``z (B, 100)``, under
        ``--sp`` this rank's frames; ``generator`` draws the dropout masks
        of a train-mode forward."""
        sp = frame_shards(self)
        sharded = False

        def shard(x):
            # split the replicated frames once each shard gets whole ones
            nonlocal sharded
            if sp is not None and not sharded and x.shape[2] % sp.size == 0:
                x, sharded = sp.split(x), True
            return x

        def segment():
            return nullcontext() if sp is None else sp.segment(sharded)

        with segment():
            x = F.relu(self.layer1["1"](self.layer1["0"](z)))
        x = shard(x.view(z.shape[0], *self.seed_shape))
        for layer, i, bn in ((self.layer2, 0, "3"), (self.layer2, 5, "8"),
                             (self.layer3, 0, "3"), (self.layer3, 5, None)):
            x = shard(self._up(layer, i, x, generator,
                               sp if sharded else None))
            if bn is not None:
                with segment():
                    x = F.leaky_relu(layer[bn](x), 0.01)
        return torch.sigmoid(float32_or_wider(x))


class AnoDiscriminator(nn.Module):
    """Video discriminator (reference NetD, anogan.py:81-119).  The Linear
    input size follows the clip geometry, so it takes ``nfr`` and
    ``isize``."""

    # a parallel.mesh.SeqParallel (--sp): x is this rank's frames
    sp = None

    def __init__(self, nfr: int = 16, isize: int = 128, *,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = {"device": device, "generator": generator}
        bkw = {"dtype": dtype, **kw}

        def c3(cin, cout):
            return make_conv3d(cin, cout, (3, 3, 3), (1, 1, 1), **kw)

        self.layer1 = nn.ModuleDict({
            "0": c3(3, 32), "1": VideoBatchNorm(32, **bkw),
            "3": c3(32, 64), "4": c3(64, 64), "5": VideoBatchNorm(64, **bkw)})
        self.layer2 = nn.ModuleDict({
            "0": c3(64, 128), "1": c3(128, 128),
            "2": VideoBatchNorm(128, **bkw),
            "5": c3(128, 256), "6": VideoBatchNorm(256, **bkw)})
        feat = 256 * (nfr // 8) * (isize // 8) ** 2
        self.fc = nn.ModuleDict({"0": TorchLinear(feat, 1, **bkw)})

    def forward(self, x: torch.Tensor):
        l1, l2 = self.layer1, self.layer2
        sp = frame_shards(self)
        sharded = sp is not None

        def conv(c, h):
            # a 3x3x3 conv: one halo frame a side on a rank's frames
            return c.valid_t(sp.halo(h, 1)) if sharded else c(h)

        def bn(m, h):
            if sp is None:
                return m(h)
            with sp.segment(sharded):
                return m(h)

        def pool(h):
            nonlocal sharded
            if sharded and h.shape[2] % 2:
                h, sharded = sp.gather(h), False
            return avg_pool_ncdhw(h, 2)

        x = F.leaky_relu(bn(l1["1"], conv(l1["0"], x)), 0.01)
        x = conv(l1["4"], conv(l1["3"], x).to(x.dtype))
        # the reference's nn.LeakyReLU(64): slope 64 (anogan.py:91)
        x = pool(F.leaky_relu(bn(l1["5"], x), 64.0))
        x = conv(l2["1"], conv(l2["0"], x).to(x.dtype))
        x = pool(F.leaky_relu(bn(l2["2"], x), 0.01))
        x = pool(F.leaky_relu(bn(l2["6"], conv(l2["5"], x)), 0.01))
        if sharded:
            # the Linear reads the whole clip's (C, T, H, W) features
            x = sp.gather(x)
        features = x.flatten(1)
        score = torch.sigmoid(float32_or_wider(self.fc["0"](features)))
        return score[:, 0], features

