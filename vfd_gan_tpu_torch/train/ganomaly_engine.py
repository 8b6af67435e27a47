"""GANomaly training engine (port of ``vfd_gan_tpu.train.ganomaly_engine``).

Frame-level encoder-decoder-encoder anomaly detection, the canonical
GANomaly scheme as the JAX engine implements it (the reference's copy is
dead code, models/ganomaly.py:18-20).  A clip's frames fold into the
batch, ``(B, T, H, W, C) -> (B*T, C, H, W)``.  One train step:

  augment (the gather kernel) -> G step -> D step

* G step: G in train mode, D in eval mode (running statistics, no
  update, no gradient for D): loss = ``w_adv`` * l2(D features of the real
  frames, of the fake ones) + ``w_con`` * L1(fake, real) + 1 * l2(z_in,
  z_out) (models/ganomaly.py:160-175); the gradient with respect to G's
  parameters only.
* D step: D in train mode on the real frames and on the fake ones of the
  G step (before G's update), detached: BCE(real, 1) + BCE(fake, 0).
* The periodic test scores each frame by ``mean((z_in - z_out)^2)``,
  min-max normalised over the whole sweep (models/ganomaly.py:372,396),
  against the frame labels (``batch["label"]``): frame-level ROC only, 0.0
  for a single-class sweep (not NaN), and ``roc_ep{NNNN}_net{G,D}.pth``
  when it improves.  The scores are copied to the host, as the JAX engine
  does with or without ``--device_scoring``: they are B*T values per
  batch.

``--sp N``: each rank steps on its frames of its rows (every op works
on single frames; the L1, L2 and BCE means over equal slices and the
BatchNorm statistics summed over the grid give sp 1's step); the sweep
scores the rank's frames and gathers the row's scores back into ``(B,
T)`` order before the min-max over the whole sweep.

``--tp N`` (alone, with ``--dp`` and with ``--sp``): G and D are drawn
whole from the seed, as at tp 1, and each rank keeps its channel slice of
every leaf that JAX's ``param_spec`` shards before Adam holds state
(``EngineBase._split_state``); the convs whose output channels split
run column-parallel (``models/ganomaly.py``), the rest whole on every tp
rank, and every tp rank scores the whole latents.  A best ``.pth`` pair
and ``latest.pt`` hold the whole tensors (``_whole_state``), and a resume
loads them whole and keeps the rank's slices.

The nets compute in ``--compute_dtype`` (bfloat16 by default, float32
parameters and Adam state): each encoder's first two convs take the
float32 frames, the latents and the anomaly scores are in the compute
dtype (as are their l2 and the sweep's normalisation, as in JAX), the fake
frames, D's score and the other losses float32.
"""

from __future__ import annotations

import numpy as np
import torch

from vfd_gan_tpu_torch.eval.metrics import evaluate
from vfd_gan_tpu_torch.models import DTYPES
from vfd_gan_tpu_torch.models.ganomaly import (
    GanomalyDiscriminator,
    GanomalyGenerator,
    ganomaly_anomaly_score,
)
from vfd_gan_tpu_torch.models.layers import float32_or_wider as f32
from vfd_gan_tpu_torch.ops.augment import (
    augment_clips,
    normalize_clips,
    sample_clip_params,
)
from vfd_gan_tpu_torch.ops.losses import bce, l2_loss
from vfd_gan_tpu_torch.parallel.prefetch import to_device
from vfd_gan_tpu_torch.train.engine_base import EngineBase, host_arrays
from vfd_gan_tpu_torch.train.state import NetState

W_ENC = 1.0  # latent reconstruction weight (GANomaly's default)


def fold(video: torch.Tensor) -> torch.Tensor:
    """Channel-last clips ``(B, T, H, W, C)`` -> NCHW frames ``(B*T, C, H,
    W)``."""
    b, t, h, w, c = video.shape
    return video.reshape(b * t, h, w, c).permute(0, 3, 1, 2)


def unfold(frames: torch.Tensor, shape) -> torch.Tensor:
    """NCHW frames -> channel-last clips of ``shape``."""
    return frames.permute(0, 2, 3, 1).reshape(shape)


class GanomalyEngine(EngineBase):
    def __init__(self, cfg, train_iter, test_iter, *, device: torch.device):
        super().__init__(cfg, train_iter, test_iter, device=device, gan=True)
        init = torch.Generator().manual_seed(cfg.seed)
        dtype = DTYPES[cfg.compute_dtype]
        self.g = NetState.create(
            GanomalyGenerator(cfg.isize, dtype=dtype,
                              generator=init).to(device), cfg.lr, cfg.beta1)
        self.d = NetState.create(
            GanomalyDiscriminator(cfg.isize, dtype=dtype,
                                  generator=init).to(device),
            cfg.lr, cfg.beta1)
        # augmentation draws
        self.rng = torch.Generator(device=device).manual_seed(cfg.seed + 1)
        # the tensors of the last train step's panels (a panel step only)
        self._viz: dict | None = None
        # the last sweep's frame labels and min-max normalised scores, the
        # inputs of its ROC
        self.frame_scores: dict[str, np.ndarray] | None = None
        self._split_state()
        self._bind_dp()
        if cfg.resume:
            # (under --tp loaded whole, the rank's channel slices kept)
            with self._whole_state():
                self.restore_into(cfg.resume, self._nets())
            print(f"\n Loaded pretrained G/D weights from {cfg.resume}\n")

    def _nets(self) -> dict:
        return {"netG": self.g, "netD": self.d}

    @property
    def netg(self) -> GanomalyGenerator:
        return self.g.module

    @property
    def netd(self) -> GanomalyDiscriminator:
        return self.d.module

    # -- the train step ----------------------------------------------------
    def _train_step_impl(self, batch: dict) -> dict:
        cfg = self.cfg
        batch = to_device(batch, self.device)
        b, _, s = batch["data"].shape[:3]
        params = self._mine(sample_clip_params(
            self.rng, self._global(b), s, cfg.isize, device=self.device))
        data, real, _ = augment_clips(params, batch["data"], batch["real"],
                                      batch["mask"], cfg.isize)
        metrics, fake = self._ganomaly_core(fold(data.to(self.input_dtype)))
        self._viz = {"input": data, "real": real,
                     "gen": unfold(fake, data.shape)} \
            if self.panel_step else None
        return metrics

    def _ganomaly_core(self, frames: torch.Tensor):
        """One G step and one D step on NCHW ``frames``: both nets updated
        in place; returns the step's losses (0-dim tensors, on the device)
        and G's detached fake frames."""
        cfg = self.cfg
        netg, netd = self.netg, self.netd
        n = frames.shape[0]
        ones = torch.ones(n, device=frames.device)
        zeros = torch.zeros(n, device=frames.device)

        # G step: D in eval mode reads the features
        netg.train()
        netd.eval()
        fake, z_in, z_out = netg(frames)
        with torch.no_grad():
            _, feat_real = netd(frames)
        _, feat_fake = netd(fake)
        err_adv = l2_loss(f32(feat_real), f32(feat_fake))
        err_con = (fake - frames).abs().mean()
        err_enc = l2_loss(z_in, z_out)
        g_loss = err_adv * cfg.w_adv + err_con * cfg.w_con + err_enc * W_ENC
        g_params = list(netg.parameters())
        grads = torch.autograd.grad(g_loss, g_params)
        for p, grad in zip(g_params, grads):
            p.grad = grad
        self._step_done(self.g)

        # D step on the pre-update fake, detached
        fake_sg = fake.detach()
        netd.train()
        s_real, _ = netd(frames)
        s_fake, _ = netd(fake_sg)
        d_loss = bce(s_real, ones) + bce(s_fake, zeros)
        self.d.optimizer.zero_grad(set_to_none=True)
        d_loss.backward()
        self._step_done(self.d)

        metrics = {"g/err_g_adv/train": err_adv, "g/err_g_con/train": err_con,
                   "g/err_g_enc/train": err_enc, "g/err_g/train": g_loss,
                   "d/err_d/train": d_loss}
        return {k: v.detach() for k, v in metrics.items()}, fake_sg

    def _update_train_videos(self) -> None:
        viz = self._viz
        if viz is None or not self.summary.videos:
            return
        d = host_arrays(viz)
        self._viz = None
        self.color_videos["train/input-real-gen"] = np.concatenate(
            [d["input"], d["real"], d["gen"]], axis=2)

    # -- the periodic test -------------------------------------------------
    @torch.no_grad()
    def _eval_step_impl(self, batch: dict):
        """Test step with G in eval mode: per-frame anomaly scores ``(B,
        T)`` and the fake clips."""
        batch = to_device(batch, self.device)
        data, _, _ = normalize_clips(batch["data"], batch["real"],
                                     batch["mask"])
        data = data.to(self.input_dtype)
        self.netg.eval()

        def forward(clips):
            fake, z_in, z_out = self.netg(fold(clips))
            scores = ganomaly_anomaly_score(z_in, z_out)
            return scores.reshape(clips.shape[:2]), unfold(fake, clips.shape)

        # --sp: the rank's frames, the row's scores gathered back into
        # (B, T) order, to pair with batch["label"]
        return self.sharded_forward(forward, data, dim=1)

    def test(self) -> float:
        """Frame-level ROC of the sweep's min-max normalised scores
        (models/ganomaly.py:372-399)."""
        all_scores, all_labels = [], []
        for batch in self._batches(self.test_iter):
            scores, _ = self._eval_step_impl(batch)
            all_scores.append(scores.flatten())
            all_labels.append(torch.as_tensor(batch["label"]).flatten())
        if not all_scores:
            print(" >> test sweep produced no batches "
                  "(empty/short test split); scores are NaN")
            self.scores["score/roc"] = float("nan")
            return float("nan")
        scores = torch.cat(all_scores).cpu()
        labels = torch.cat([v.cpu() for v in all_labels]).numpy()
        lo, hi = scores.min(), scores.max()
        scores = ((scores - lo) / (hi - lo + 1e-12)).float().numpy()
        self.frame_scores = {"labels": labels, "scores": scores}
        if len(np.unique(labels)) < 2:
            roc = 0.0  # a degenerate split (no anomalies)
        else:
            roc = evaluate(labels, scores, self.best_roc, self.epoch,
                           self._curves_dir, metric="roc")
        if roc > self.best_roc:
            self.best_roc = roc
            self._save_weights("roc")
        self.scores["score/roc"] = roc
        print(f" >> test sweep at step {self.global_step}: "
              f"{len(all_scores)} batches, frame roc {roc:.6g}", flush=True)
        return roc
