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
that a train-mode forward is deterministic.  ``remat`` (``--remat``)
recomputes the blocks' activations in the backward pass instead of keeping
them, all blocks or those named in ``remat_blocks`` (``--remat_blocks``; a
name that is no block matches nothing), as ``nn.remat`` does in the JAX
Generator; the output, the gradients and every BatchNorm buffer are the
plain Generator's (under ``--sp`` too: a block is recomputed in the
segment it ran in, ``rematerialized``).

``DualDisc`` (reference NetD, models/mygannet.py:200-213) scores a pair of
NCDHW videos: ``SpatialDisc`` the RGB mask video (6 spatial-only
DiscConvBlocks, each followed by a (1,2,2) average pool, then a global
temporal pool), ``TemporalDisc`` its optical-flow video (3 temporal-only
blocks, each followed by a (2,1,1) pool, then a global spatial pool).  Each
flattens its pooled features in NCDHW ``(C, T, H, W)`` order into a Linear
and a float32 sigmoid and returns ``(score (B,), features)``.  The Linear
input size follows the clip geometry, so the discriminators take
``nfr`` and ``isize``.  ``quant`` (``--int8_disc``) runs every
discriminator conv int8 forward, float backward (``quant/qdisc.py``).

Under ``--sp`` (``parallel.mesh.SeqParallel`` bound as ``sp``, whose
frame-axis operations they call) each net takes this rank's frames.  The
Generator's levels stay sharded while a level's shard count can pool by 2
alone; where it cannot (an odd count, or fewer than 2 frames: at ``nfr
16, sp 2`` the 1-frame shards of ``dconv4``'s output), the frames are
gathered and the coarser levels run replicated on every sp peer, as
GSPMD reshards there, and the decoder splits them again once its upsample
reaches a sharded level; its x2 upsample takes T on the global grid, its
3x3x3 head one halo frame a side, and its dropout masks are the global
``(B, T)`` clip's.  ``SpatialDisc``'s convs and pools are frame-local and
its global temporal pool a sum over the sp peers; ``TemporalDisc``'s
(3,1,1) convs take halos, its (2,1,1) pools stay local while a shard's
count is even (else gathered, as in the Generator), and its Linear reads
the gathered pooled features.  Both return each clip's score on every sp
peer and this rank's frames of their features.  A replicated segment's
BatchNorms take their statistics over the dp peers of the rank's shard
(each element once, ``parallel/mesh.DataParallel.bn_sum``), and its
gradients reach the sharded levels through the gather's backward.

``dtype`` (float32 or bfloat16) is the compute dtype of
``models/layers.py``: parameters float32, each first conv in its float32
input's dtype, the rest from the first BatchNorm on in ``dtype``; the
heads cast to float32 before the sigmoid (JAX models/mygan.py:96, 120,
146).
"""

from __future__ import annotations

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from vfd_gan_tpu_torch.models.layers import (
    Conv3d,
    DiscConvBlock,
    GenConvBlock,
    TorchLinear,
    dropout,
    float32_or_wider,
    frame_shards,
    upsample2x_sp,
)
from vfd_gan_tpu_torch.ops.convs import avg_pool_ncdhw
from vfd_gan_tpu_torch.ops.resize import upsample_ncdhw
from vfd_gan_tpu_torch.utils.init import dcgan_normal_


def rematerialized(block: nn.Module, x: torch.Tensor,
                   sp=None) -> torch.Tensor:
    """``block(x)`` with its activations recomputed in the backward pass
    (``torch.utils.checkpoint``, non-reentrant) instead of kept.  The
    recomputation runs the block in train mode a second time, and a
    train-mode BatchNorm would then move its running statistics and
    ``num_batches_tracked`` again, which JAX's ``nn.remat`` does not do:
    the block's buffers are put back as the forward left them.  The blocks
    draw no random numbers (dropout lies between them).

    Under ``--sp`` (``sp``, the ``SeqParallel`` the block shards over) the
    recomputation runs during the backward, outside the segment that the
    forward ran in: it re-enters the forward's ``on`` and ``replicated``,
    so that a block that ran on gathered frames is recomputed on them,
    with the forward's collectives (the halo exchanges and BatchNorm sums
    again, on every rank in the same order)."""
    forward_done = False
    segment = None if sp is None else (sp.on, sp.replicated)

    def run(x):
        nonlocal forward_done
        if not forward_done:
            forward_done = True
            return block(x)
        kept = [b.clone() for b in block.buffers()]
        ambient = None if sp is None else (sp.on, sp.replicated)
        try:
            if sp is not None:
                sp.on, sp.replicated = segment
            return block(x)
        finally:
            # also when the recomputation stops early, once it has made
            # what the backward needs
            if sp is not None:
                sp.on, sp.replicated = ambient
            with torch.no_grad():
                for b, k in zip(block.buffers(), kept):
                    b.copy_(k)

    return checkpoint(run, x, use_reentrant=False)


class Generator(nn.Module):
    """U-Net mask predictor; ``generator`` seeds the reference init."""

    BLOCKS = ("dconv1", "dconv2", "dconv3", "dconv4", "dconv5", "uconv5",
              "uconv4", "uconv3", "uconv2", "uconv1")
    # a parallel.mesh.DataParallel: dropout draws the global batch's masks
    dp = None
    # a parallel.mesh.SeqParallel (--sp): x is this rank's frames
    sp = None

    def __init__(self, ngf: int = 32, *, drop_rate: float = 0.25,
                 remat: bool = False, remat_blocks: tuple = (),
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = ngf
        kw = {"dtype": dtype, "device": device, "generator": generator}
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
        self.remat = frozenset(
            (b for b in self.BLOCKS if not remat_blocks or b in remat_blocks)
            if remat else ())
        self.conv_last = Conv3d(g, 1, 3, padding=1, bias=False,
                                device=device)
        if generator is not None:
            dcgan_normal_(self.conv_last.weight, generator)

    def drop(self, y: torch.Tensor,
             generator: torch.Generator | None = None) -> torch.Tensor:
        """Decoder dropout (flax ``nn.Dropout``'s function: keep with
        probability 1 - rate, scale kept values by 1 / (1 - rate)), drawn
        from ``generator``; inert in eval mode or at rate 0."""
        return dropout(y, self.drop_rate, self.training, generator,
                       self.dp)

    def block(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """The conv block ``name`` on ``x``, rematerialized where
        ``remat`` names it and a backward pass will follow."""
        if name in self.remat and torch.is_grad_enabled():
            return rematerialized(getattr(self, name), x, frame_shards(self))
        return getattr(self, name)(x)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Mask video ``(B, 1, T, H, W)``; ``generator`` draws the dropout
        masks of a train-mode forward."""
        sp = frame_shards(self)
        if sp is not None:
            return self._forward_sp(x, sp, generator)
        blk = self.block
        d1 = blk("dconv1", x)
        d2 = blk("dconv2", avg_pool_ncdhw(d1, 2))
        d3 = blk("dconv3", avg_pool_ncdhw(d2, 2))
        d4 = blk("dconv4", avg_pool_ncdhw(d3, 2))
        latent = blk("dconv5", avg_pool_ncdhw(d4, 2))

        g = generator
        y = upsample_ncdhw(self.drop(blk("uconv5", latent), g))
        y = upsample_ncdhw(self.drop(blk("uconv4", torch.cat([y, d4], 1)), g))
        y = upsample_ncdhw(self.drop(blk("uconv3", torch.cat([y, d3], 1)), g))
        y = upsample_ncdhw(self.drop(blk("uconv2", torch.cat([y, d2], 1)), g))
        y = blk("uconv1", torch.cat([y, d1], 1))
        return torch.sigmoid(float32_or_wider(self.conv_last(y)))

    def _forward_sp(self, x: torch.Tensor, sp,
                    generator: torch.Generator | None) -> torch.Tensor:
        """``forward`` on this rank's frames ``x`` (``--sp``)."""

        def run(name, h, sharded):
            with sp.segment(sharded):
                return self.block(name, h)

        def pool(h, sharded):
            if sharded and h.shape[2] % 2:
                h, sharded = sp.gather(h), False
            return avg_pool_ncdhw(h, 2), sharded

        def up(h, sharded, to_sharded):
            if sharded:
                return upsample2x_sp(h, sp)
            h = upsample_ncdhw(h)
            return sp.split(h) if to_sharded else h

        def drop(h, sharded):
            return dropout(h, self.drop_rate, self.training, generator,
                           self.dp, frame_dim=2 if sharded else None)

        h, sharded = x, True
        skips = []
        for name in ("dconv1", "dconv2", "dconv3", "dconv4", "dconv5"):
            if skips:
                h, sharded = pool(h, sharded)
            h = run(name, h, sharded)
            skips.append((h, sharded))
        y, y_sharded = skips.pop()
        y = run("uconv5", y, y_sharded)
        for name, (skip, skip_sharded) in zip(
                ("uconv4", "uconv3", "uconv2", "uconv1"), reversed(skips)):
            y = up(drop(y, y_sharded), y_sharded, skip_sharded)
            y_sharded = skip_sharded
            y = run(name, torch.cat([y, skip], 1), y_sharded)
        # the 3x3x3 head: one halo frame a side, SAME over H and W
        return torch.sigmoid(float32_or_wider(
            self.conv_last.valid_t(sp.halo(y, 1))))


def _temporal_mean_sp(x: torch.Tensor, sp) -> torch.Tensor:
    """The global temporal mean of this rank's frames of ``x`` (NCDHW),
    kept as a 1-frame axis: the sp peers' float32 (float64) sums summed,
    over T, rounded once to ``x``'s dtype (``avg_pool_ncdhw``'s
    arithmetic)."""
    wide = x if x.dtype == torch.float64 else x.float()
    total = sp.sum(wide.sum(2, keepdim=True))
    return (total / (x.shape[2] * sp.size)).to(x.dtype)


class SpatialDisc(nn.Module):
    """Spatial branch (reference SDisc, models/mygannet.py:119-162)."""

    sp = None

    def __init__(self, ndf: int = 32, isize: int = 128, *,
                 dtype: torch.dtype = torch.float32, quant: bool = False,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        kw = {"dtype": dtype, "device": device, "generator": generator}
        widths = [3] + [ndf * m for m in (1, 2, 4, 8, 16, 32)]
        for i in range(6):
            setattr(self, f"dconv{i + 1}", DiscConvBlock(
                widths[i], widths[i + 1], (1, 3, 3), (0, 1, 1), quant=quant,
                **kw))
        side = isize // 64
        self.linear = TorchLinear(widths[-1] * side * side, 1, **kw)

    def forward(self, x: torch.Tensor):
        for i in range(6):
            x = avg_pool_ncdhw(getattr(self, f"dconv{i + 1}")(x), (1, 2, 2))
        features = x                                 # (B, C, T, s, s)
        sp = frame_shards(self)
        if sp is None:
            x = avg_pool_ncdhw(x, (x.shape[2], 1, 1), 1)   # global temporal
        else:
            x = _temporal_mean_sp(x, sp)
        score = torch.sigmoid(float32_or_wider(self.linear(x.flatten(1))))
        return score[:, 0], features


class TemporalDisc(nn.Module):
    """Temporal branch over the flow video (reference TDisc,
    models/mygannet.py:164-196)."""

    sp = None

    def __init__(self, ndf: int = 32, nfr: int = 16, *,
                 dtype: torch.dtype = torch.float32, quant: bool = False,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        kw = {"dtype": dtype, "device": device, "generator": generator}
        widths = [3, ndf, ndf * 2, ndf * 4]
        for i in range(3):
            setattr(self, f"dconv{i + 1}", DiscConvBlock(
                widths[i], widths[i + 1], (3, 1, 1), (1, 0, 0), quant=quant,
                **kw))
        self.linear = TorchLinear(widths[-1] * (nfr // 8), 1, **kw)

    def forward(self, x: torch.Tensor):
        sp = frame_shards(self)
        if sp is None:
            for i in range(3):
                x = avg_pool_ncdhw(getattr(self, f"dconv{i + 1}")(x),
                                   (2, 1, 1))
        else:
            sharded = True
            for i in range(3):
                with sp.segment(sharded):
                    x = getattr(self, f"dconv{i + 1}")(x)
                if sharded and x.shape[2] % 2:
                    x, sharded = sp.gather(x), False
                x = avg_pool_ncdhw(x, (2, 1, 1))
        features = x                                 # (B, C, T/8, H, W)
        x = avg_pool_ncdhw(x, (1, x.shape[3], x.shape[4]), 1)  # global spatial
        if sp is not None and sharded:
            # the Linear reads (C, T/8) of the whole clip
            x = sp.gather(x)
        score = torch.sigmoid(float32_or_wider(self.linear(x.flatten(1))))
        return score[:, 0], features


class DualDisc(nn.Module):
    """Spatial + temporal discriminator pair (reference NetD);
    ``forward(rgb_video, flow_video)`` ->
    ``(s_score, s_features, t_score, t_features)``."""

    def __init__(self, ndf: int = 32, nfr: int = 16, isize: int = 128, *,
                 dtype: torch.dtype = torch.float32, quant: bool = False,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        kw = {"dtype": dtype, "quant": quant, "device": device,
              "generator": generator}
        self.spatdisc = SpatialDisc(ndf, isize, **kw)
        self.tempdisc = TemporalDisc(ndf, nfr, **kw)

    def forward(self, x: torch.Tensor, y: torch.Tensor):
        s_cls, s_feat = self.spatdisc(x)
        t_cls, t_feat = self.tempdisc(y)
        return s_cls, s_feat, t_cls, t_feat
