"""Synthetic batches made on the device (port of
``vfd_gan_tpu.data.device_synthetic``, ``--synthetic_data``).

The same moving-inpainted-square forgeries as the JAX iterator: a smooth
drifting background, a coloured square that moves a few pixels per frame,
and the square's boundary ring as the gt mask (what the dataset's
invert + Canny preparation finds, reference lib/data.py:99-109), or the
filled square with ``thick_masks``.  Each clip is a forgery with
probability ``p_fake``; a real clip has an empty mask.

The stream is a pure function of ``(seed, epoch, batch_index)``: each
batch is drawn on the device from its own ``torch.Generator``, seeded from
those three numbers, so a resumed run sets ``epoch`` and ``skip_batches``
and continues the same stream.  It is not bit-equal to the JAX iterator's
stream (another RNG).  The batches carry no ``index`` field (the JAX
iterator's repeats from pass to pass while its clips change), so
``--cache_gt_flow`` does not cache on synthetic data.
"""

from __future__ import annotations

import math

import numpy as np
import torch


class DeviceSyntheticIterator:
    """Yields staged batches like the JAX iterator's: ``data``/``real``
    ``(B, T, S, S, 3)`` uint8, ``mask`` ``(B, T, S, S, 1)`` uint8 in
    {0, 255} and ``label`` ``(B, T)`` float32 (1 for every frame of a
    forged clip, the frame-level labels GANomaly's sweep scores), on
    ``device``.  Each pass over it is the next epoch."""

    def __init__(self, batch_size: int, nfr: int, size: int, n_batches: int,
                 seed: int = 0, p_fake: float = 0.5,
                 thick_masks: bool = False, device="cpu"):
        self.batch_size = batch_size
        self.nfr = nfr
        self.size = size
        self.n_batches = n_batches
        self.seed = seed
        self.p_fake = p_fake
        self.thick_masks = thick_masks
        self.device = torch.device(device)
        self.epoch = 0          # index of the next pass
        self.skip_batches = 0   # fast-forward within the next pass (resume)
        # a --dp rank's rows of each batch (None: all of them) and an
        # --sp rank's frames of each clip (a slice): the whole batch is
        # drawn and these rows and frames kept
        self.rows = None
        self.frames = None

    def _generator(self, epoch: int, i: int) -> torch.Generator:
        seed = int(np.random.SeedSequence(
            [self.seed, epoch, i]).generate_state(1, np.uint64)[0] >> 1)
        return torch.Generator(device=self.device).manual_seed(seed)

    def batch(self, epoch: int, i: int) -> dict:
        """Batch ``i`` of pass ``epoch``."""
        b, t, s, dev = self.batch_size, self.nfr, self.size, self.device
        gen = self._generator(epoch, i)

        def rand(*shape):
            return torch.rand(shape, generator=gen, device=dev)

        def randint(lo, hi, *shape):
            return torch.randint(lo, hi, shape, generator=gen, device=dev)

        f = torch.arange(t, dtype=torch.float32, device=dev)
        axis = torch.arange(s, dtype=torch.float32, device=dev) / s
        yyf, xxf = axis[:, None], axis[None, :]
        phase = rand(b) * (2 * math.pi)
        # (B, T, S, S) drifting gradient
        g = 0.5 + 0.4 * torch.sin(
            2 * math.pi * (xxf + 0.03 * f[:, None, None])[None]
            + phase[:, None, None, None]) * torch.cos(
            2 * math.pi * (yyf - 0.02 * f[:, None, None]))[None]
        bg = torch.stack([g, torch.roll(g, 3, dims=2),
                          torch.roll(g, 5, dims=3)], dim=-1) * 255.0

        side = max(4, s // 4)
        pos = randint(0, s - side, b, 2)
        vel = randint(-2, 3, b, 2)
        ycur = (pos[:, :1] + vel[:, :1] * f[None]).clamp(0, s - side)
        xcur = (pos[:, 1:] + vel[:, 1:] * f[None]).clamp(0, s - side)
        iy = torch.arange(s, dtype=torch.float32, device=dev)[None, None]
        yc, xc = ycur[..., None], xcur[..., None]              # (B, T, 1)
        in_y = (iy >= yc) & (iy < yc + side)                   # (B, T, S)
        in_x = (iy >= xc) & (iy < xc + side)
        sq = in_y[..., :, None] & in_x[..., None, :]           # (B, T, S, S)
        edge_y = (iy == yc) | (iy == yc + side - 1)
        edge_x = (iy == xc) | (iy == xc + side - 1)
        edge = ((edge_y[..., :, None] & in_x[..., None, :])
                | (in_y[..., :, None] & edge_x[..., None, :]))

        color = randint(0, 255, b, 3).to(torch.float32)
        fake = torch.where(sq[..., None], color[:, None, None, None, :], bg)
        is_fake = rand(b) < self.p_fake
        sel = is_fake[:, None, None, None, None]
        data = torch.where(sel, fake, bg)
        gt = sq if self.thick_masks else edge
        mask = sel & gt[..., None]
        return {
            "data": data.clamp(0, 255).to(torch.uint8),
            "real": bg.clamp(0, 255).to(torch.uint8),
            "mask": mask.to(torch.uint8) * 255,
            "label": is_fake.to(torch.float32)[:, None].expand(b, t)
            .contiguous(),
        }

    def __iter__(self):
        epoch = self.epoch
        start = min(self.skip_batches, self.n_batches)
        self.skip_batches = 0
        self.epoch += 1
        for i in range(start, self.n_batches):
            batch = self.batch(epoch, i)
            if self.rows is not None:
                rows = self.rows.to(self.device)
                batch = {k: v[rows] for k, v in batch.items()}
            if self.frames is not None:
                batch = {k: v[:, self.frames].contiguous()
                         for k, v in batch.items()}
            yield batch
