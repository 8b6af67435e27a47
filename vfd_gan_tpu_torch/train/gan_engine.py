"""MyGAN training engine (port of ``vfd_gan_tpu.train.gan_engine``).

One train step (reference models/mygannet.py:216-475, lib/train_gan.py:
59-85):

  augment -> G forward -> weighted BCE (G's only loss) -> optical flow of
  the detached (gt, predicted) mask videos -> D on real, then on fake ->
  D loss -> both Adam steps

with the reference's semantics, as the JAX engine keeps them:

* D sees gray->RGB mask videos and their flow encodings, all detached
  (models/mygannet.py:279-286): G learns from ``weighted_bce * w_con``
  alone; the adversarial feature-matching loss is telemetry.
* ``pos_weight`` is parsed but overridden: ``weighted_bce`` at its default
  2 (models/mygannet.py:265-266).
* D loss: ``((real_s + real_t)/2 + (fake_s + fake_t)/2)/2``; D's
  BatchNorms see real then fake, two running-stat updates per step.
* Both gradients come from the one pre-update forward, before either
  ``optimizer.step()``.
* The periodic test scores the morphology-opened binary masks
  (models/mygannet.py:395-399) with G and D in eval mode, and logs the
  reference's test losses, including its temporal-only ``g/err_g/test``.

The flow of both streams is one ``video_to_flow_rgb`` call with
``streams=2``; its refinement loop runs on the flow kernels of
``flow_impl`` (``ops/flow.py``).  Options of the JAX engine that are not
ported yet are refused with the ``ROADMAP.md`` item that holds them.
"""

from __future__ import annotations

import torch

from vfd_gan_tpu_torch.models.mygan import DualDisc, Generator
from vfd_gan_tpu_torch.ops.augment import (
    augment_clips,
    normalize_clips,
    sample_clip_params,
)
from vfd_gan_tpu_torch.ops.flow import video_to_flow_rgb
from vfd_gan_tpu_torch.ops.image import (
    gray2rgb,
    threshold,
    to_channel_first,
    to_channel_last,
)
from vfd_gan_tpu_torch.ops.losses import bce, l2_loss, weighted_bce
from vfd_gan_tpu_torch.ops.morphology import video_open
from vfd_gan_tpu_torch.train.checkpoints import best_ckpt_name, save_pth
from vfd_gan_tpu_torch.train.engine_base import EngineBase, SweepAccumulator
from vfd_gan_tpu_torch.train.state import NetState

class MyGanEngine(EngineBase):
    def __init__(self, cfg, train_iter, test_iter, *, device: torch.device,
                 flow_impl: str = "fused"):
        super().__init__(cfg, train_iter, test_iter, device=device, gan=True)
        init = torch.Generator().manual_seed(cfg.seed)
        self.g = NetState.create(
            Generator(cfg.ngf, generator=init).to(device), cfg.lr, cfg.beta1)
        self.d = NetState.create(
            DualDisc(cfg.ndf, cfg.nfr, cfg.isize, generator=init).to(device),
            cfg.lr, cfg.beta1)
        # augmentation draws and dropout masks
        self.rng = torch.Generator(device=device).manual_seed(cfg.seed + 1)
        self.flow_impl = flow_impl

    @property
    def netg(self) -> Generator:
        return self.g.module

    @property
    def netd(self) -> DualDisc:
        return self.d.module

    def _flow(self, video: torch.Tensor, streams: int = 1) -> torch.Tensor:
        return video_to_flow_rgb(video, scale=self.cfg.flow_scale,
                                 streams=streams, impl=self.flow_impl)

    def _disc(self, gt_3ch, gt_flow, pre_3ch, pre_flow):
        """Sequential real and fake D passes (the reference's two forward
        calls); channel-last inputs."""
        d = self.netd
        real = d(to_channel_first(gt_3ch), to_channel_first(gt_flow))
        fake = d(to_channel_first(pre_3ch), to_channel_first(pre_flow))
        return real, fake

    # -- the train step ----------------------------------------------------
    def _train_step_impl(self, batch: dict) -> dict:
        cfg = self.cfg
        b, _, s = batch["data"].shape[:3]
        params = sample_clip_params(self.rng, b, s, cfg.isize,
                                    device=self.device)
        data, _, gt = augment_clips(params, batch["data"].to(self.device),
                                    batch["real"].to(self.device),
                                    batch["mask"].to(self.device), cfg.isize)
        return self._gan_core(data, gt, self.rng)

    def _gan_core(self, data: torch.Tensor, gt: torch.Tensor,
                  drop_gen: torch.Generator | None = None) -> dict:
        """One step on augmented channel-last ``data (B, T, H, W, 3)`` and
        ``gt (B, T, H, W, 1)``: both networks updated in place; returns the
        step's metrics (0-dim tensors, on the device)."""
        cfg = self.cfg
        netg, netd = self.netg, self.netd
        netg.train()
        netd.train()
        b = data.shape[0]
        ones = torch.ones(b, device=data.device)
        zeros = torch.zeros(b, device=data.device)

        # G forward; its gradient comes from l_con alone
        pred = to_channel_last(netg(to_channel_first(data), drop_gen))
        g_con_scaled = weighted_bce(pred, gt) * cfg.w_con
        self.g.optimizer.zero_grad(set_to_none=True)
        g_con_scaled.backward()

        # flow + D inputs, all detached (models/mygannet.py:279-286); one
        # flow call for both videos, streams=2 keeps the per-video stretch
        pred_sg = pred.detach()
        gt_3ch = gray2rgb(gt)
        pre_3ch = gray2rgb(pred_sg)
        with torch.no_grad():
            flows = self._flow(torch.cat([gt_3ch, pre_3ch], dim=0),
                               streams=2)
        gt_flow, pre_flow = flows.chunk(2, dim=0)

        (s_r, sf_r, t_r, tf_r), (s_f, sf_f, t_f, tf_f) = self._disc(
            gt_3ch, gt_flow, pre_3ch, pre_flow)
        err_d_real_s = bce(s_r, ones)
        err_d_real_t = bce(t_r, ones)
        err_d_fake_s = bce(s_f, zeros)
        err_d_fake_t = bce(t_f, zeros)
        err_d_real = (err_d_real_s + err_d_real_t) * 0.5
        err_d_fake = (err_d_fake_s + err_d_fake_t) * 0.5
        err_d = (err_d_real + err_d_fake) * 0.5
        self.d.optimizer.zero_grad(set_to_none=True)
        err_d.backward()

        # both gradients are in; now both updates
        self.g.optimizer.step()
        self.d.optimizer.step()

        with torch.no_grad():
            err_g_adv_s = l2_loss(sf_r.float(), sf_f.float())
            err_g_adv_t = l2_loss(tf_r.float(), tf_f.float())
            err_g_adv = err_g_adv_s + err_g_adv_t
            g_con = g_con_scaled.detach()
            metrics = {
                "d/err_d_real_s/train": err_d_real_s,
                "d/err_d_real_t/train": err_d_real_t,
                "d/err_d_fake_s/train": err_d_fake_s,
                "d/err_d_fake_t/train": err_d_fake_t,
                "d/err_d_real/train": err_d_real,
                "d/err_d_fake/train": err_d_fake,
                "d/err_d/train": err_d,
                "g/err_g/train": err_g_adv * cfg.w_adv + g_con,
                "g/err_g_adv/train": err_g_adv,
                "g/err_g_adv_s/train": err_g_adv_s,
                "g/err_g_adv_t/train": err_g_adv_t,
                "g/err_g_con/train": g_con / cfg.w_con,
            }
        return {k: v.detach() for k, v in metrics.items()}

    # -- the periodic test -------------------------------------------------
    @torch.no_grad()
    def _eval_step_impl(self, batch: dict):
        """Test step (reference MyGAN.test body, models/mygannet.py:
        395-424) with G and D in eval mode."""
        dev = self.device
        data, real, gt = normalize_clips(batch["data"].to(dev),
                                         batch["real"].to(dev),
                                         batch["mask"].to(dev))
        self.netg.eval()
        self.netd.eval()
        pred = to_channel_last(self.netg(to_channel_first(data)))
        gt_3ch = gray2rgb(gt)
        pre_3ch = gray2rgb(pred)
        flows = self._flow(torch.cat([gt_3ch, pre_3ch], dim=0), streams=2)
        gt_flow, pre_flow = flows.chunk(2, dim=0)
        return self._eval_tail(data, gt, pred, gt_3ch, pre_3ch, gt_flow,
                               pre_flow)

    @torch.no_grad()
    def _eval_tail(self, data, gt, pred, gt_3ch, pre_3ch, gt_flow,
                   pre_flow):
        """Opened binary masks and the reference's test losses; returns
        ``(gt, m_pre, metrics)``."""
        cfg = self.cfg
        b = data.shape[0]
        ones = torch.ones(b, device=data.device)
        zeros = torch.zeros(b, device=data.device)
        m_pre = video_open(threshold(pred), cfg.morph_plane)
        (s_r, sf_r, t_r, tf_r), (s_f, sf_f, t_f, tf_f) = self._disc(
            gt_3ch, gt_flow, pre_3ch, pre_flow)
        err_g_adv_s = l2_loss(sf_r.float(), sf_f.float())
        err_g_adv_t = l2_loss(tf_r.float(), tf_f.float())
        err_g_con = weighted_bce(pred, gt)
        err_d_real_s = bce(s_r, ones)
        err_d_real_t = bce(t_r, ones)
        err_d_fake_s = bce(s_f, zeros)
        err_d_fake_t = bce(t_f, zeros)
        metrics = {
            "g/err_g_adv_s/test": err_g_adv_s,
            "g/err_g_adv_t/test": err_g_adv_t,
            "g/err_g_adv/test": err_g_adv_s + err_g_adv_t,
            "g/err_g_con/test": err_g_con,
            # the reference's combined test err_g takes the *temporal*
            # adversarial term only (models/mygannet.py:416)
            "g/err_g/test": err_g_adv_t * cfg.w_adv + err_g_con * cfg.w_con,
            "d/err_d_real_s/test": err_d_real_s,
            "d/err_d_real_t/test": err_d_real_t,
            "d/err_d_fake_s/test": err_d_fake_s,
            "d/err_d_fake_t/test": err_d_fake_t,
        }
        metrics["d/err_d_real/test"] = (err_d_real_s + err_d_real_t) * 0.5
        metrics["d/err_d_fake/test"] = (err_d_fake_s + err_d_fake_t) * 0.5
        metrics["d/err_d/test"] = (metrics["d/err_d_real/test"]
                                   + metrics["d/err_d_fake/test"]) * 0.5
        return gt, m_pre, metrics

    def test(self) -> tuple[float, float, float]:
        sweep = SweepAccumulator()
        for batch in self.test_iter:
            gt, m_pre, metrics = self._eval_step_impl(batch)
            sweep.add(gt, m_pre, metrics)
        roc, pr, f1 = self.score_and_checkpoint(sweep.gts, sweep.preds,
                                                self._save_weights)
        self.errors.update(sweep.mean_metrics())
        print(f" >> test sweep at step {self.global_step}: {sweep.n} "
              f"batches, roc {roc:.6g} pr {pr:.6g} f1 {f1:.6g}", flush=True)
        return roc, pr, f1

    def _save_weights(self, head: str) -> None:
        for net, module in (("netG", self.netg), ("netD", self.netd)):
            save_pth(self.weight_path(
                best_ckpt_name(head, self.epoch, net) + ".pth"), module,
                self.epoch)
