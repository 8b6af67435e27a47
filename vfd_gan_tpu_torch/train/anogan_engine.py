"""AnoGAN training engine (port of ``vfd_gan_tpu.train.anogan_engine``).

Reference models/anogan.py:121-266, as the JAX engine keeps it.  One
train step:

  augment (the gather kernel) -> z ~ N(0, 1)^100 -> one G forward ->
  D step on (real -> 1, detached G(z) -> 0) -> G step: BCE(D(G(z)), 1)
  through the *updated* D (the reference steps D's optimizer before G's
  backward, anogan.py:243-250)

* G learns at 5x D's rate (anogan.py:139-140); both Adams use betas
  (0.5, 0.999).
* D's BatchNorms update their running statistics three times per step
  (real, fake, and the G step's pass); G's once.  The JAX step runs G
  twice, with the same dropout key and the same pre-step statistics, and
  keeps the second forward's update, which equals the first's: here G runs
  once and its graph serves the G step.
* The G step's gradient is taken with respect to G's parameters only, so
  D's weight gradients are not computed for it.
* Under ``--ref_mode_quirks`` the reference's stuck-in-eval latch holds
  (its ``test()`` switches both nets to eval mode and never back,
  anogan.py:145-147): from step ``freq + 1`` on both nets train without
  dropout, normalising by frozen running statistics.
* The forgery heat map is ``predict_forgery``: |G(z) - real|, min-max
  normalised per time slab, in gray (anogan.py:24-37).  The periodic test
  sweep scores the raw heat map; its threshold and opening (the opening
  kernel, every sweep batch) feed the summary panels (anogan.py:184-185).
* A best model is a ``{roc|pr}_ep{NNNN}_net{G,D}.pth`` pair with the
  reference's ``state_dict`` keys.

``--sp N``: each rank steps on its frames of its rows, with its rows'
z (the same on the row's peers).  G makes the rank's frames and D reads
them; D gathers its pooled block over the row before its Linear, so
every peer holds every clip's score and the losses are the row's; the
BatchNorm statistics and the gradients are the grid's
(``models/anogan.py``).  The sweep runs G, D and ``predict_forgery``
(its extrema are per frame) on the rank's frames and gathers the row's
fakes and heat maps before the threshold and the opening
(``EngineBase.sharded_forward``).

The nets compute in ``--compute_dtype`` (bfloat16 by default, float32
parameters and Adam state; ``models/layers.py``); G's video, D's score
and the losses are float32.
"""

from __future__ import annotations

import numpy as np
import torch

from vfd_gan_tpu_torch.models import DTYPES
from vfd_gan_tpu_torch.models.anogan import (
    Z_DIM,
    AnoDiscriminator,
    AnoGenerator,
)
from vfd_gan_tpu_torch.ops.augment import (
    augment_clips,
    normalize_clips,
    sample_clip_params,
)
from vfd_gan_tpu_torch.ops.image import (
    minmax_normalize,
    rgb_to_gray,
    threshold,
    to_channel_first,
    to_channel_last,
)
from vfd_gan_tpu_torch.ops.losses import bce
from vfd_gan_tpu_torch.ops.morphology import video_open
from vfd_gan_tpu_torch.parallel.prefetch import to_device
from vfd_gan_tpu_torch.train.engine_base import (
    EngineBase,
    SweepAccumulator,
    host_arrays,
)
from vfd_gan_tpu_torch.train.state import NetState


def predict_forgery(fake: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    """|G(z) - real|, min-max normalised per time slab over (B, H, W, C)
    jointly, then gray (reference predict_forg, anogan.py:24-37):
    channel-last ``(B, T, H, W, 3) -> (B, T, H, W, 1)``."""
    diff = (fake - real).abs()
    return rgb_to_gray(minmax_normalize(diff, dims=(0, 2, 3, 4)))


class AnoGanEngine(EngineBase):
    def __init__(self, cfg, train_iter, test_iter, *, device: torch.device):
        super().__init__(cfg, train_iter, test_iter, device=device, gan=True)
        init = torch.Generator().manual_seed(cfg.seed)
        dtype = DTYPES[cfg.compute_dtype]
        self.g = NetState.create(
            AnoGenerator(cfg.nfr, cfg.isize, dtype=dtype,
                         generator=init).to(device), 5 * cfg.lr, 0.5)
        self.d = NetState.create(
            AnoDiscriminator(cfg.nfr, cfg.isize, dtype=dtype,
                             generator=init).to(device), cfg.lr, 0.5)
        # augmentation draws, z and dropout masks
        self.rng = torch.Generator(device=device).manual_seed(cfg.seed + 1)
        # the tensors of the last train step's panels (a panel step only)
        self._viz: dict | None = None
        self._bind_dp()
        if cfg.resume:
            self.restore_into(cfg.resume, self._nets())
            print(f"\n Loaded pretrained G/D weights from {cfg.resume}\n")

    def _nets(self) -> dict:
        return {"netG": self.g, "netD": self.d}

    @property
    def netg(self) -> AnoGenerator:
        return self.g.module

    @property
    def netd(self) -> AnoDiscriminator:
        return self.d.module

    # -- the train step ----------------------------------------------------
    def _train_step_impl(self, batch: dict) -> dict:
        cfg = self.cfg
        batch = to_device(batch, self.device)
        b, _, s = batch["data"].shape[:3]
        params = self._mine(sample_clip_params(
            self.rng, self._global(b), s, cfg.isize, device=self.device))
        data, real, gt = augment_clips(params, batch["data"], batch["real"],
                                       batch["mask"], cfg.isize)
        real = real.to(self.input_dtype)
        z, = self._mine((self._draw_z(self._global(b)),))
        z = z.to(self.input_dtype)
        metrics, fake = self._ano_core(real, z, self.rng,
                                       not self.stuck_in_eval)
        # the panels' tensors, kept (not copied) on a panel step only
        self._viz = {"input": data, "real": real, "gen": fake, "gt": gt,
                     "pred": predict_forgery(fake, real)} \
            if self.panel_step else None
        return metrics

    def _draw_z(self, b: int) -> torch.Tensor:
        """z ~ N(0, 1) of a train step's global batch of ``b`` rows, from
        the engine's generator (every rank draws them all)."""
        return torch.randn((b, Z_DIM), generator=self.rng,
                           device=self.device)

    def _ano_core(self, real: torch.Tensor, z: torch.Tensor,
                  drop_gen: torch.Generator | None = None,
                  train_mode: bool = True):
        """One alternating update from the augmented channel-last ``real
        (B, T, H, W, 3)`` and ``z (B, 100)`` (the reference's
        optimize_params, anogan.py:229-250): both nets updated in place;
        returns the step's losses (0-dim tensors, on the device) and G's
        detached channel-last video.  ``train_mode=False`` is the
        ``--ref_mode_quirks`` latch: both nets in eval mode, so no running
        statistic moves (the optimizers still step)."""
        netg, netd = self.netg, self.netd
        netg.train(train_mode)
        netd.train(train_mode)
        b = real.shape[0]
        ones = torch.ones(b, device=real.device)
        zeros = torch.zeros(b, device=real.device)

        fake = netg(z, drop_gen)                    # NCDHW, graph kept
        fake_sg = fake.detach()

        # D step: real -> 1, detached fake -> 0
        s_real, _ = netd(to_channel_first(real))
        s_fake, _ = netd(fake_sg)
        d_loss = bce(s_real, ones) + bce(s_fake, zeros)
        self.d.optimizer.zero_grad(set_to_none=True)
        d_loss.backward()
        self._step_done(self.d)

        # G step through the updated D, whose BatchNorms update a third time
        s_fake_g, _ = netd(fake)
        g_loss = bce(s_fake_g, ones)
        g_params = list(netg.parameters())
        grads = torch.autograd.grad(g_loss, g_params)
        for p, grad in zip(g_params, grads):
            p.grad = grad
        self._step_done(self.g)

        metrics = {"d/err_d/train": d_loss.detach(),
                   "g/err_g/train": g_loss.detach()}
        return metrics, to_channel_last(fake_sg)

    def _update_train_videos(self) -> None:
        viz = self._viz
        if viz is None or not self.summary.videos:
            return
        t_pre, m_pre = self.viz_morphology(viz["pred"])
        d = host_arrays({**viz, "t_pre": t_pre, "m_pre": m_pre})
        self._viz = None
        self.color_videos["train/input-real-gen"] = np.concatenate(
            [d["input"], d["real"], d["gen"]], axis=2)
        self.gray_videos["train/gt-pre-th-mor"] = np.concatenate(
            [d["gt"], d["pred"], d["t_pre"], d["m_pre"]], axis=2)

    # -- the periodic test -------------------------------------------------
    @torch.no_grad()
    def _eval_step_impl(self, batch: dict):
        """Test step with G and D in eval mode, z drawn from the engine's
        generator: ``(gt, pred, metrics, viz)``, ``pred`` the raw heat map
        and ``viz`` the panels' tensors with its threshold and opening."""
        batch = to_device(batch, self.device)
        data, real, gt = normalize_clips(batch["data"], batch["real"],
                                         batch["mask"])
        data, real, gt = (x.to(self.input_dtype) for x in (data, real, gt))
        b = data.shape[0]
        ones = torch.ones(b, device=data.device)
        zeros = torch.zeros(b, device=data.device)
        z = torch.randn((b, Z_DIM), generator=self.rng,
                        device=self.device).to(self.input_dtype)
        self.netg.eval()
        self.netd.eval()
        scores = {}

        def forward(real_frames):
            fake = self.netg(z)
            scores["real"], _ = self.netd(to_channel_first(real_frames))
            scores["fake"], _ = self.netd(fake)
            fake = to_channel_last(fake)
            return fake, predict_forgery(fake, real_frames)

        # under --sp the rank's frames, the row's fakes and heat maps
        # gathered before the threshold and the opening
        fake, pred = self.sharded_forward(forward, real, dim=1)
        s_real, s_fake = scores["real"], scores["fake"]
        t_pre = threshold(pred)
        m_pre = video_open(t_pre, self.cfg.morph_plane)
        metrics = {"d/err_d/test": bce(s_real, ones) + bce(s_fake, zeros),
                   "g/err_g/test": bce(s_fake, ones)}
        viz = {"input": data, "real": real, "gen": fake, "gt": gt,
               "pred": pred, "t_pre": t_pre, "m_pre": m_pre}
        return gt, pred, metrics, viz

    def test(self) -> tuple[float, float, float]:
        sweep = SweepAccumulator(device=self.cfg.device_scoring)
        for batch in self._batches(self.test_iter):
            gt, pred, metrics, viz = self._eval_step_impl(batch)
            # the raw heat map is scored, not the opened mask
            # (anogan.py:184-185)
            sweep.add(gt, pred, metrics)
            if self.summary.videos:
                # TensorBoard-only panels (the last batch's stay)
                d = host_arrays(viz)
                self.color_videos["test/input-real-gen"] = np.concatenate(
                    [d["input"], d["real"], d["gen"]], axis=2)
                self.gray_videos["test/gt-pre-th-morph"] = np.concatenate(
                    [d["gt"], d["pred"], d["t_pre"], d["m_pre"]], axis=2)
        roc, pr, f1 = self.score_and_checkpoint(sweep.gts, sweep.preds,
                                                self._save_weights)
        self.errors.update(sweep.mean_metrics())
        print(f" >> test sweep at step {self.global_step}: {sweep.n} "
              f"batches, roc {roc:.6g} pr {pr:.6g} f1 {f1:.6g}", flush=True)
        return roc, pr, f1
