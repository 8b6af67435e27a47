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
``state_dict`` keys.

The model computes in ``--compute_dtype`` (bfloat16 by default, float32
parameters and Adam state; ``models/layers.py``); its mask and the loss are
float32 (JAX supervised_engine.py:37-39).

``--resume latest.pt`` restores the full train state
(``EngineBase.restore_into``).  ``--accum k`` runs the step over k
microbatches of the augmented batch with one optimizer step (``_step``).
``--moe_experts N`` (Xception only) adds ``--moe_aux_w`` times the MoE
block's load-balancing loss to each train-mode microbatch's loss, and the
reported loss includes it, as in JAX.  ``--pp N [--pp_micro M]``
(Xception only) runs the train forward and backward through
``parallel/pp_xception.XceptionPipeline`` (GPipe over the eight middle
blocks, their BatchNorm statistics per microbatch); the sweep and the
checkpoints see the whole model, its stages gathered first.
Under ``--ref_mode_quirks`` the reference's stuck-in-eval latch holds: its
``test()`` switches the model to eval mode and never back
(lib/train_stcnn.py:143), so from step ``freq + 1`` on the model trains
without dropout and normalises by frozen BatchNorm running statistics
(gradients still flow).  ``--sp N`` (Xception, whose ops are
frame-local; c2plus1d, whose AutoEncoder exchanges halos and gathers
its coarse levels, ``models/stcnn.py``; clstm, whose recurrence is
chained along the row, ``models/convlstm.py``): each rank steps on its frames
of its rows, the augment parameters drawn for the global
batch, the BatchNorm statistics, gradients and loss over the grid, and
under ``--accum k`` its rows and frames of each microbatch (JAX
``accum_regroup``'s ``P(None, "dp", "sp")``); the sweep's eval forward
runs on the rank's frames and the row's masks are gathered before the
threshold and the opening (``EngineBase.sharded_forward``).
``--moe_shards N`` (with ``--moe_experts``, alone or with ``--dp``,
``--sp``, ``--accum``, ``--ref_mode_quirks``): the N replicas of each
rank's rows and frames hold E/N experts each and their Adam state
(``parallel/tensor.StateShards``, kept before Adam holds state); the
step's and the sweep's MoE layer dispatch to them and combine over the ep
group (``parallel/moe.py``); ``latest.pt`` and the best ``.pth`` hold
every expert (``_whole_state``), and a resume loads the whole state and
keeps the rank's experts, whatever N wrote it.  ``--tp N`` (Xception,
with every option above but ``--pp``, which JAX refuses with it): the
model is drawn whole from the seed, as at tp 1, and each rank keeps its
channel slice of every leaf that JAX's ``param_spec`` shards before the
optimizer holds state (``EngineBase._split_state``; under tp x ep
the experts are the ep axis's alone), its convs and the MoE block run
column-parallel (``models/xception3d.py``, ``models/moe_block.py``), the
augment draws, the dropout masks and the sweep's opening run replicated
on the tp ranks, and the checkpoints hold the whole tensors
(``_whole_state``).  Options of
the JAX engine that are not ported yet are refused with the
``ROADMAP.md`` item that holds them.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from vfd_gan_tpu_torch.models import DTYPES, build_mask_model
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
from vfd_gan_tpu_torch.parallel.pp_xception import XceptionPipeline
from vfd_gan_tpu_torch.parallel.prefetch import to_device
from vfd_gan_tpu_torch.train.checkpoints import save_pth
from vfd_gan_tpu_torch.train.engine_base import EngineBase, SweepAccumulator
from vfd_gan_tpu_torch.train.state import NetState


class SupervisedEngine(EngineBase):
    def __init__(self, cfg, train_iter, test_iter, *, device: torch.device):
        super().__init__(cfg, train_iter, test_iter, device=device, gan=False)
        init = torch.Generator().manual_seed(cfg.seed)
        model = build_mask_model(cfg.model, cfg,
                                 dtype=DTYPES[cfg.compute_dtype],
                                 generator=init).to(device)
        self.net = NetState.create(model, cfg.lr, cfg.beta1)
        # --moe_shards, --tp: the rank's experts and channel slices kept
        # before Adam's moments exist
        self._split_state()
        # augmentation draws and dropout masks
        self.rng = torch.Generator(device=device).manual_seed(cfg.seed + 1)
        # the tensors of the last train step's panels (a panel step only)
        self._viz: dict | None = None
        # --pp: the middle chain pipelined over the grid's stages (none in
        # a process alone: the chain run per microbatch)
        self.pipe = XceptionPipeline(self.model, self.grid,
                                     cfg.n_pp_micro) if cfg.pp > 1 else None
        self._bind_dp()
        if cfg.resume:
            # (under --moe_shards and --tp the whole state loaded, the
            # rank's experts and channel slices kept)
            with self._whole_state() if self.pipe is None \
                    else contextlib.nullcontext():
                self.restore_into(cfg.resume, self._nets())
            print(f"\n Loaded pretrained weights from {cfg.resume}\n")
        if self.pipe is not None:
            # the other stages' blocks leave this rank (loaded whole first)
            self.pipe.release(self.net.optimizer)

    def _nets(self) -> dict:
        return {"state": self.net}

    @property
    def model(self) -> torch.nn.Module:
        return self.net.module

    def _train_step_impl(self, batch: dict) -> dict:
        cfg = self.cfg
        batch = to_device(batch, self.device)
        b, _, s = batch["data"].shape[:3]
        params = self._mine(sample_clip_params(
            self.rng, self._global(b), s, cfg.isize, device=self.device))
        data, real, gt = augment_clips(params, batch["data"], batch["real"],
                                       batch["mask"], cfg.isize)
        data, gt = data.to(self.input_dtype), gt.to(self.input_dtype)
        metrics = self._step(data, gt, self.rng)
        if self._viz is not None:
            self._viz.update({"data": data, "real": real})
        return metrics

    def _step(self, data: torch.Tensor, gt: torch.Tensor,
              drop_gen: torch.Generator | None = None) -> dict:
        """One step on augmented channel-last ``data (B, T, H, W, C)`` and
        ``gt (B, T, H, W, 1)``: the model updated in place; returns the
        step's loss (a 0-dim tensor, on the device).  In eval mode once
        the ``--ref_mode_quirks`` latch holds.

        ``--accum k`` (JAX ``supervised_engine.py:138-165``): the loss's
        gradients over ``k`` consecutive microbatches, the parameters fixed
        and the BatchNorm running statistics chained through them, summed
        and divided by ``k``, then one Adam step; the loss is the sum of
        the microbatches' over ``k``, the prediction concatenated."""
        model = self.model
        model.train(not self.stuck_in_eval)
        k = self.cfg.accum
        self.net.optimizer.zero_grad(set_to_none=True)
        losses, preds = [], []
        moe = getattr(model, "moe", None)
        forward = model if self.pipe is None else self.pipe.forward
        for data_i, gt_i in zip(data.chunk(k), gt.chunk(k)):
            pred = to_channel_last(forward(to_channel_first(data_i),
                                           drop_gen))
            loss = bce(pred, gt_i)
            if moe is not None and model.training:
                # the Switch load-balancing term, per microbatch (JAX
                # supervised_engine.py:129-133); dropped_frac stays out
                loss = loss + self.cfg.moe_aux_w * \
                    moe.aux["load_balance_loss"]
            loss.backward()
            if self.pipe is not None:
                self.pipe.backward()
            losses.append(loss.detach())
            preds.append(pred.detach())
        if k > 1:
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(k)
            loss = sum(losses[1:], losses[0]) / k
            pred = torch.cat(preds)
        self._step_done(self.net)
        self._viz = {"gt": gt, "pred": pred.detach()} \
            if self.panel_step else None
        return {"loss/err/train": loss.detach()}

    def _update_train_videos(self) -> None:
        viz = self._viz
        if viz is None or "data" not in viz or not self.summary.videos:
            return
        t_pre, m_pre = self.viz_morphology(viz["pred"])
        d = {k: v.detach().cpu().numpy()
             for k, v in {**viz, "t_pre": t_pre, "m_pre": m_pre}.items()}
        self._viz = None
        self.color_videos["train/input-real"] = np.concatenate(
            [d["data"], d["real"]], axis=2)
        self.gray_videos["train/gt-pre-th-mor"] = np.concatenate(
            [d["gt"], d["pred"], d["t_pre"], d["m_pre"]], axis=2)

    @torch.no_grad()
    def _eval_step_impl(self, batch: dict):
        """Test step with the model in eval mode: ``(bce, gt, pred, t_pre,
        m_pre, data, real)``."""
        batch = to_device(batch, self.device)
        data, real, gt = normalize_clips(batch["data"], batch["real"],
                                         batch["mask"])
        data, real, gt = (x.to(self.input_dtype) for x in (data, real, gt))
        self.model.eval()
        # under --sp the rank's frames, the row's masks gathered before
        # the threshold and the opening
        pred = to_channel_last(self.sharded_forward(
            self.model, to_channel_first(data)))
        t_pre = threshold(pred)
        m_pre = video_open(t_pre, self.cfg.morph_plane)
        return bce(pred, gt), gt, pred, t_pre, m_pre, data, real

    def _whole_state(self):
        if self.pipe is not None:
            return self.pipe.whole(self.net.optimizer)
        return super()._whole_state()

    def test(self) -> tuple[float, float, float]:
        # the sweep and a best checkpoint see every stage's blocks; under
        # --moe_shards the sweep runs with the experts sharded, and a best
        # checkpoint gathers them (_save_weights)
        if self.pipe is None:
            return self._test()
        with self._whole_state():
            return self._test()

    def _test(self) -> tuple[float, float, float]:
        sweep = SweepAccumulator(device=self.cfg.device_scoring)
        for batch in self._batches(self.test_iter):
            err, gt, pred, t_pre, m_pre, data, real = \
                self._eval_step_impl(batch)
            # the scored prediction is the opened binary mask
            sweep.add(gt, m_pre, {"loss/err/test": err})
            if self.summary.videos:
                # TensorBoard-only panels (the last batch's stay)
                d = [v.cpu().numpy()
                     for v in (data, real, gt, pred, t_pre, m_pre)]
                self.color_videos["test/input-real"] = np.concatenate(
                    d[:2], axis=2)
                self.gray_videos["test/mask-pre-th-mor"] = np.concatenate(
                    d[2:], axis=2)
        roc, pr, f1 = self.score_and_checkpoint(sweep.gts, sweep.preds,
                                                self._save_weights)
        self.errors.update(sweep.mean_metrics())
        print(f" >> test sweep at step {self.global_step}: {sweep.n} "
              f"batches, roc {roc:.6g} pr {pr:.6g} f1 {f1:.6g}", flush=True)
        return roc, pr, f1

    def _save_weights(self, head: str) -> None:
        # every rank of an ep or tp group gathers the experts and the
        # channel slices (each takes the same decision from the same
        # scores); the writing rank writes (under --pp test() holds every
        # stage's blocks already)
        with self._whole_state() if self.pipe is None \
                else contextlib.nullcontext():
            if not self._writes:
                return
            best = self.best_roc if head == "roc" else self.best_pr
            name = f"{head}-{best:.4f}_step{self.global_step:04d}"
            save_pth(self.weight_path(name + ".pth"), self.model,
                     self.epoch)
