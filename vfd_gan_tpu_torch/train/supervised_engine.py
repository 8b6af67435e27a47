"""Supervised mask-prediction engine (port of
``vfd_gan_tpu.train.supervised_engine``).

Reference lib/train_stcnn.py:18-197: one of ``c2plus1d`` (the (2+1)D
AutoEncoder), ``xception`` (Xception-3D) or ``clstm`` (ConvLSTM) learns
the forgery mask under ``BCE(pred, gt)`` and Adam (``--beta1``).  One
train step:

  augment (the gather kernel) -> train-mode forward -> bce -> backward ->
  one Adam step

The periodic test sweep runs ``normalize_clips`` -> eval forward -> bce
-> ``video_open(threshold(pred))`` (the opening kernel) and scores the
opened binary mask, not ``pred`` (lib/train_stcnn.py:158-162), with the
if-roc-elif-pr rule of ``EngineBase.score_and_checkpoint``; a best model
is saved as ``{roc|pr}-{score:.4f}_step{NNNN}.pth`` with the reference's
``state_dict`` keys.  Options of the JAX engine that are not ported yet
are refused with the ``ROADMAP.md`` item that holds them.
"""

from __future__ import annotations

import torch

from vfd_gan_tpu_torch.models import build_mask_model
from vfd_gan_tpu_torch.ops.augment import (
    augment_clips,
    normalize_clips,
    sample_clip_params,
)
from vfd_gan_tpu_torch.ops.image import (
    threshold,
    to_channel_first,
    to_channel_last,
)
from vfd_gan_tpu_torch.ops.losses import bce
from vfd_gan_tpu_torch.ops.morphology import video_open
from vfd_gan_tpu_torch.train.checkpoints import save_pth
from vfd_gan_tpu_torch.train.engine_base import EngineBase, SweepAccumulator
from vfd_gan_tpu_torch.train.state import NetState


class SupervisedEngine(EngineBase):
    def __init__(self, cfg, train_iter, test_iter, *, device: torch.device):
        super().__init__(cfg, train_iter, test_iter, device=device, gan=False)
        init = torch.Generator().manual_seed(cfg.seed)
        self.net = NetState.create(
            build_mask_model(cfg.model, cfg, generator=init).to(device),
            cfg.lr, cfg.beta1)
        # augmentation draws and dropout masks
        self.rng = torch.Generator(device=device).manual_seed(cfg.seed + 1)

    @property
    def model(self) -> torch.nn.Module:
        return self.net.module

    def _train_step_impl(self, batch: dict) -> dict:
        cfg = self.cfg
        b, _, s = batch["data"].shape[:3]
        params = sample_clip_params(self.rng, b, s, cfg.isize,
                                    device=self.device)
        data, _, gt = augment_clips(params, batch["data"].to(self.device),
                                    batch["real"].to(self.device),
                                    batch["mask"].to(self.device), cfg.isize)
        return self._step(data, gt, self.rng)

    def _step(self, data: torch.Tensor, gt: torch.Tensor,
              drop_gen: torch.Generator | None = None) -> dict:
        """One step on augmented channel-last ``data (B, T, H, W, C)`` and
        ``gt (B, T, H, W, 1)``: the model updated in place; returns the
        step's loss (a 0-dim tensor, on the device)."""
        model = self.model
        model.train()
        pred = to_channel_last(model(to_channel_first(data), drop_gen))
        loss = bce(pred, gt)
        self.net.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.net.optimizer.step()
        return {"loss/err/train": loss.detach()}

    @torch.no_grad()
    def _eval_step_impl(self, batch: dict):
        """Test step: ``(bce, gt, m_pre)`` with the model in eval mode."""
        dev = self.device
        data, _, gt = normalize_clips(batch["data"].to(dev),
                                      batch["real"].to(dev),
                                      batch["mask"].to(dev))
        self.model.eval()
        pred = to_channel_last(self.model(to_channel_first(data)))
        m_pre = video_open(threshold(pred), self.cfg.morph_plane)
        return bce(pred, gt), gt, m_pre

    def test(self) -> tuple[float, float, float]:
        sweep = SweepAccumulator()
        for batch in self.test_iter:
            err, gt, m_pre = self._eval_step_impl(batch)
            # the scored prediction is the opened binary mask
            sweep.add(gt, m_pre, {"loss/err/test": err})
        roc, pr, f1 = self.score_and_checkpoint(sweep.gts, sweep.preds,
                                                self._save_weights)
        self.errors.update(sweep.mean_metrics())
        print(f" >> test sweep at step {self.global_step}: {sweep.n} "
              f"batches, roc {roc:.6g} pr {pr:.6g} f1 {f1:.6g}", flush=True)
        return roc, pr, f1

    def _save_weights(self, head: str) -> None:
        best = self.best_roc if head == "roc" else self.best_pr
        name = f"{head}-{best:.4f}_step{self.global_step:04d}"
        save_pth(self.weight_path(name + ".pth"), self.model, self.epoch)
