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
``flow_impl`` (``ops/flow.py``).

The nets compute in ``--compute_dtype`` (bfloat16 by default, float32
parameters and Adam state; ``models/layers.py``); their scores, features
for the feature-matching losses and G's mask are float32, and so are the
losses, the flow and the augment gather (JAX gan_engine.py:54-63).

Options: ``--ae`` trains the (2+1)D ``AutoEncoder`` as G (saved as
``*_netG.pth`` like any G); ``--resume latest.pt`` restores the full train
state (``EngineBase.restore_into``); ``--cache_gt_flow`` keeps each test clip's
gt flow video on the device after the first sweep and computes only the
predicted stream afterwards; ``--ref_mode_quirks`` runs the sweep as the
reference does, with G and D in train mode; ``--accum k`` runs the step
over k microbatches of the augmented batch with one optimizer step per
net (``_gan_core``); ``--remat [--remat_blocks a,b]`` recomputes the
Generator's block activations in the backward pass (not the ``--ae``
AutoEncoder's, as in JAX); ``--host_flow`` computes every flow with cv2 on
the host (``train/host_flow.py``; refused when the engine is built where
cv2 does not import); ``--int8_disc`` runs D's convs int8 forward and
float backward (``quant/qdisc.py``).  Options of the JAX engine that are
not ported yet are refused with the ``ROADMAP.md`` item that holds them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vfd_gan_tpu_torch.models import DTYPES
from vfd_gan_tpu_torch.models.layers import float32_or_wider as f32
from vfd_gan_tpu_torch.models.mygan import DualDisc, Generator
from vfd_gan_tpu_torch.models.stcnn import AutoEncoder
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
from vfd_gan_tpu_torch.parallel.prefetch import to_device
from vfd_gan_tpu_torch.train.engine_base import (
    EngineBase,
    SweepAccumulator,
    host_arrays,
)
from vfd_gan_tpu_torch.train.host_flow import (
    require_cv2,
    video_to_flow_rgb_host,
)
from vfd_gan_tpu_torch.train.state import NetState


class MyGanEngine(EngineBase):
    def __init__(self, cfg, train_iter, test_iter, *, device: torch.device,
                 flow_impl: str = "fused"):
        super().__init__(cfg, train_iter, test_iter, device=device, gan=True)
        init = torch.Generator().manual_seed(cfg.seed)
        self.dtype = DTYPES[cfg.compute_dtype]
        if cfg.ae:
            print("\n --Using C2plus1d AutoEncoder as G-- ")
            netg = AutoEncoder(dtype=self.dtype, generator=init)
        else:
            netg = Generator(cfg.ngf, remat=cfg.remat,
                             remat_blocks=tuple(
                                 b for b in cfg.remat_blocks.split(",") if b),
                             dtype=self.dtype, generator=init)
        self.g = NetState.create(netg.to(device), cfg.lr, cfg.beta1)
        self.d = NetState.create(
            DualDisc(cfg.ndf, cfg.nfr, cfg.isize, dtype=self.dtype,
                     quant=cfg.int8_disc,
                     generator=init).to(device),
            cfg.lr, cfg.beta1)
        # augmentation draws and dropout masks
        self.rng = torch.Generator(device=device).manual_seed(cfg.seed + 1)
        self.flow_impl = flow_impl
        if cfg.host_flow:
            # cv2 on the host for every flow (the train step and the
            # sweeps); where cv2 does not import, exit now, not at the
            # first step
            require_cv2()
            # under --dp the slabs' extrema over the ranks
            self._flow = functools.partial(video_to_flow_rgb_host,
                                           dp=self.dp) \
                if self.dp.grouped else video_to_flow_rgb_host
        # --cache_gt_flow: clip index -> its (T, H, W, 3) gt flow video on
        # the device
        self._gt_flow_cache: dict[int, torch.Tensor] = {}
        # the tensors of the last train step's panels (a panel step only)
        self._viz: dict | None = None
        self._bind_dp()
        if cfg.resume:
            self.restore_into(cfg.resume, self._nets())
            print(f"\n Loaded pretrained G/D weights from {cfg.resume}\n")

    def _nets(self) -> dict:
        return {"netG": self.g, "netD": self.d}

    @property
    def netg(self) -> Generator | AutoEncoder:
        return self.g.module

    @property
    def netd(self) -> DualDisc:
        return self.d.module

    def _flow(self, video: torch.Tensor, streams: int = 1) -> torch.Tensor:
        return video_to_flow_rgb(video, scale=self.cfg.flow_scale,
                                 streams=streams, impl=self.flow_impl,
                                 dp=self.dp)

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
        batch = to_device(batch, self.device)
        b, _, s = batch["data"].shape[:3]
        params = self._mine(sample_clip_params(
            self.rng, self._global(b), s, cfg.isize, device=self.device))
        data, real, gt = augment_clips(params, batch["data"], batch["real"],
                                       batch["mask"], cfg.isize)
        data, gt = data.to(self.input_dtype), gt.to(self.input_dtype)
        metrics = self._gan_core(data, gt, self.rng)
        if self._viz is not None:
            self._viz.update({"input": data, "real": real})
        return metrics

    def _gan_core(self, data: torch.Tensor, gt: torch.Tensor,
                  drop_gen: torch.Generator | None = None) -> dict:
        """One step on augmented channel-last ``data (B, T, H, W, 3)`` and
        ``gt (B, T, H, W, 1)``: both networks updated in place; returns the
        step's metrics (0-dim tensors, on the device).

        ``--accum k`` (JAX ``_gan_core_accum``): the gradients of ``k``
        consecutive microbatches, the parameters fixed and the BatchNorm
        running statistics chained through them (G's move once per
        microbatch, D's twice), summed, times ``1 / k``, then one Adam step
        per net; the metrics are the microbatches' means, the panels the
        whole batch in microbatch order.  Each microbatch's flow is its own
        ``streams=2`` call, so the per-stream stretch is over the
        microbatch."""
        k = self.cfg.accum
        self._zero_grads()
        micro = [self._gan_grads(d, g, drop_gen)
                 for d, g in zip(data.chunk(k), gt.chunk(k))]
        metrics, viz = micro[0]
        if k > 1:
            for net in (self.g, self.d):
                for p in net.module.parameters():
                    if p.grad is not None:
                        p.grad.mul_(1.0 / k)
            metrics = {name: torch.stack([m[name] for m, _ in micro]).mean(0)
                       for name in metrics}
            viz = {name: torch.cat([v[name] for _, v in micro])
                   for name in viz}
        # both gradients are in (averaged over the ranks); now both updates
        self._step_done(self.g, self.d)
        # the panels' tensors, kept (not copied) on a panel step only;
        # their thresholded and opened forms are made when flushed
        self._viz = viz if self.panel_step else None
        return metrics

    def _zero_grads(self) -> None:
        self.g.optimizer.zero_grad(set_to_none=True)
        self.d.optimizer.zero_grad(set_to_none=True)

    def _gan_grads(self, data: torch.Tensor, gt: torch.Tensor,
                   drop_gen: torch.Generator | None = None):
        """G's and D's gradients of one (micro)batch, added to the
        parameters' ``.grad``, and the BatchNorm running statistics moved
        (G's once, D's twice: real, then fake), without an optimizer step
        (JAX ``_gan_grads``); returns the metrics (0-dim tensors, on the
        device) and the panels' tensors."""
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
        err_d.backward()

        with torch.no_grad():
            err_g_adv_s = l2_loss(f32(sf_r), f32(sf_f))
            err_g_adv_t = l2_loss(f32(tf_r), f32(tf_f))
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
        viz = {"gt": gt, "pred": pred_sg, "gt_flow": gt_flow,
               "pre_flow": pre_flow}
        return {k: v.detach() for k, v in metrics.items()}, viz

    def _update_train_videos(self) -> None:
        viz = self._viz
        if viz is None or "input" not in viz:
            return
        t_pre, m_pre = self.viz_morphology(viz["pred"])
        d = host_arrays({**viz, "t_pre": t_pre, "m_pre": m_pre})
        self._viz = None
        if self.summary.videos:
            self.color_videos["train/input-real-inflow-genflow"] = \
                np.concatenate([d["input"], d["real"], d["gt_flow"],
                                d["pre_flow"]], axis=2)
            self.gray_videos["train/gt-pre-th-morph"] = np.concatenate(
                [d["gt"], d["pred"], d["t_pre"], d["m_pre"]], axis=2)
        self.hists.update({f"train/{k}": d[k].ravel()
                           for k in ("input", "gt", "pred", "t_pre", "m_pre")})

    # -- the periodic test -------------------------------------------------
    @torch.no_grad()
    def _eval_step(self, batch: dict, *, train_mode: bool = False,
                   gt_flow: torch.Tensor | None = None):
        """The body of the three test steps below: G and D in
        ``train_mode``, the gt stream's flow computed with the predicted
        one unless ``gt_flow`` is given; returns ``(gt, m_pre, metrics,
        viz)``."""
        batch = to_device(batch, self.device)
        data, real, gt = normalize_clips(batch["data"], batch["real"],
                                         batch["mask"])
        data, real, gt = (x.to(self.input_dtype) for x in (data, real, gt))
        self.netg.train(train_mode)
        self.netd.train(train_mode)
        pred = to_channel_last(self.netg(
            to_channel_first(data), self.rng if train_mode else None))
        gt_3ch = gray2rgb(gt)
        pre_3ch = gray2rgb(pred)
        if gt_flow is None:
            flows = self._flow(torch.cat([gt_3ch, pre_3ch], dim=0),
                               streams=2)
            gt_flow, pre_flow = flows.chunk(2, dim=0)
        else:
            pre_flow = self._flow(pre_3ch, streams=1)
        return self._eval_tail(data, gt, pred, gt_3ch, pre_3ch, gt_flow,
                               pre_flow, real)

    def _eval_step_impl(self, batch: dict):
        """Test step (reference MyGAN.test body, models/mygannet.py:
        395-424) with G and D in eval mode; the gt flow comes back under
        ``viz["gt_flow"]`` for the ``--cache_gt_flow`` cache."""
        return self._eval_step(batch)

    def _eval_step_cached_impl(self, batch: dict, gt_flow: torch.Tensor):
        """Test step on cached gt flows ``(B, T, H, W, 3)``: the gt masks
        are fixed per clip, so their flow of the first sweep is reused and
        only the predicted stream is computed, half of the sweep's fields.
        Near-exact: the flow's per-time-slab min-max over the batch
        (lib/utils.py:96) is the identity for a binary edge slab that holds
        both values, so a cached flow depends on the batch it was computed
        in only for all-constant slabs; that reaches D's test losses alone
        (the scores come from ``m_pre``, which no flow enters)."""
        return self._eval_step(batch, gt_flow=gt_flow)

    def _eval_step_quirk_impl(self, batch: dict):
        """``--ref_mode_quirks`` test step: the reference's MyGAN.test
        never calls ``.eval()`` (models/mygannet.py:369-441), so G runs
        with dropout on (masks from the engine's generator) and G's and
        D's BatchNorms normalise by batch statistics and update their
        running statistics during the sweep, D's twice per batch; what
        they become carries back into training."""
        return self._eval_step(batch, train_mode=True)

    @torch.no_grad()
    def _eval_tail(self, data, gt, pred, gt_3ch, pre_3ch, gt_flow,
                   pre_flow, real=None):
        """Opened binary masks and the reference's test losses, D in the
        mode the caller set; returns ``(gt, m_pre, metrics, viz)``, ``viz``
        the tensors of the test panels and the gt flow (not copied)."""
        cfg = self.cfg
        b = data.shape[0]
        ones = torch.ones(b, device=data.device)
        zeros = torch.zeros(b, device=data.device)
        t_pre = threshold(pred)
        m_pre = video_open(t_pre, cfg.morph_plane)
        (s_r, sf_r, t_r, tf_r), (s_f, sf_f, t_f, tf_f) = self._disc(
            gt_3ch, gt_flow, pre_3ch, pre_flow)
        err_g_adv_s = l2_loss(f32(sf_r), f32(sf_f))
        err_g_adv_t = l2_loss(f32(tf_r), f32(tf_f))
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
        viz = {"input": data, "real": data if real is None else real,
               "gt": gt, "pred": pred, "t_pre": t_pre, "m_pre": m_pre,
               "gt_flow": gt_flow}
        return gt, m_pre, metrics, viz

    def test(self) -> tuple[float, float, float]:
        cfg = self.cfg
        sweep = SweepAccumulator(device=cfg.device_scoring)
        for batch in self._batches(self.test_iter):
            idx = batch.get("index")
            caching = cfg.cache_gt_flow and idx is not None \
                and not cfg.ref_mode_quirks
            if cfg.ref_mode_quirks:
                # G and D stay in train mode through the sweep; the gt-flow
                # cache is bypassed, so the path is the reference's
                gt, m_pre, metrics, viz = self._eval_step_quirk_impl(batch)
            elif caching and all(int(i) in self._gt_flow_cache for i in idx):
                gt, m_pre, metrics, viz = self._eval_step_cached_impl(
                    batch, torch.stack([self._gt_flow_cache[int(i)]
                                        for i in idx]))
            else:
                gt, m_pre, metrics, viz = self._eval_step_impl(batch)
                if caching:
                    for j, i in enumerate(idx):
                        self._gt_flow_cache[int(i)] = viz["gt_flow"][j]
            sweep.add(gt, m_pre, metrics)
            if self.summary.videos:
                # TensorBoard-only panels (the last batch's stay)
                d = host_arrays({k: viz[k] for k in (
                    "input", "real", "gt", "pred", "t_pre", "m_pre")})
                self.color_videos["test/input-real"] = np.concatenate(
                    [d["input"], d["real"]], axis=2)
                self.gray_videos["test/gt-pre-th-morph"] = np.concatenate(
                    [d["gt"], d["pred"], d["t_pre"], d["m_pre"]], axis=2)
        roc, pr, f1 = self.score_and_checkpoint(sweep.gts, sweep.preds,
                                                self._save_weights)
        self.errors.update(sweep.mean_metrics())
        print(f" >> test sweep at step {self.global_step}: {sweep.n} "
              f"batches, roc {roc:.6g} pr {pr:.6g} f1 {f1:.6g}", flush=True)
        return roc, pr, f1

    def reinit_d(self) -> None:
        """Draw the discriminator anew, with a fresh Adam state (reference
        reinit_d, models/mygannet.py:346-348: a hook against collapse);
        the seed comes from the engine's generator."""
        cfg = self.cfg
        seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=self.rng,
                                 device=self.device))
        init = torch.Generator().manual_seed(seed)
        self.d = NetState.create(
            DualDisc(cfg.ndf, cfg.nfr, cfg.isize, dtype=self.dtype,
                     quant=cfg.int8_disc,
                     generator=init).to(self.device), cfg.lr, cfg.beta1)
        self._bind_dp()
        print("Reloading Net d")
