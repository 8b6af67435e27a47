"""The training loop, its checkpoints and the best-checkpoint rule (port of
``vfd_gan_tpu.train.engine_base``).

* Run dir, ``args.txt`` and the TensorBoard logger: ``obs/summary.py``.
* ``refuse_unported``: the options the port does not run yet exit with
  the ``ROADMAP.md`` item that holds them.
* The epoch/step loop starts at ``(epoch, batch_in_epoch)``, takes its
  batches through ``parallel/prefetch.device_prefetch``, and every ``freq``
  steps fetches the step's scalars, runs the periodic test sweep and
  flushes the scalars, scores and panels to TensorBoard and to
  ``metrics.jsonl`` in the run dir.
* ``--autosave_every N`` writes the full train state to
  ``weights/latest.pt`` every N steps (``--autosave_async``: the file is
  written on a thread); SIGTERM or SIGINT parks the same file after the
  step in flight and ``train()`` returns; ``--resume latest.pt`` restores
  parameters, BatchNorm buffers, Adam state, the engine's generator, the
  loop cursor and the best scores, and the run continues as if never
  stopped: bit for bit on the CPU, and on a card as far as cuDNN's kernels
  repeat themselves.
* ``score_and_checkpoint``: gt cast to int32 (truncation binarises
  fractional mask edges, models/mygannet.py:444), NaN scores for a
  single-class or empty sweep, and the reference's rule: save on a ROC
  improvement, else on a PR improvement (models/mygannet.py:449-454).
  Under ``--device_scoring`` the sweep's arrays stay on the device and
  ``eval/device_metrics.score_sweep`` scores them there (the EER as well);
  four scalars reach the host and no curve CSV is written.
* ``--dp N`` (``cli/trainer.py`` starts the ranks): the engine finds its
  place in the process group (``parallel/mesh.DataParallel``), binds it to
  its nets' BatchNorms and dropout, gives the train iterator this rank's
  rows of each global batch and draws the global batch's random numbers
  (``_global``, ``_mine``).  Every rank runs the whole test sweep alone
  (``DataParallel.local``), so the scores and the best-checkpoint choice
  are dp 1's on every rank; rank 0 alone writes the run dir, summaries,
  ``.pth`` files, curve CSVs and ``latest.pt``.  The logged metrics are
  means over the ranks; a stop signal on any rank parks every rank at the
  same step (an all-reduced MAX of the flag); ``--resume`` loads on every
  rank.
* ``--pp N`` (Xception; ``parallel/pp_xception.py``): the ranks form a
  ``dp x pp`` grid (``parallel/pipeline.stage_grid``); the engine's
  ``dp`` is its stage's dp subgroup, rank 0 of the whole group writes,
  and ``_whole_state`` gives every rank every stage's blocks while a
  checkpoint is written.  Each rank's rows are its slice of each GPipe
  microbatch (``micro``), as under ``--accum`` of each accumulation
  microbatch.
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import time

import numpy as np
import torch

from vfd_gan_tpu_torch.eval.device_metrics import score_sweep
from vfd_gan_tpu_torch.eval.metrics import evaluate
from vfd_gan_tpu_torch.obs.summary import (  # noqa: F401  (re-exported)
    RunDirs,
    SummaryLogger,
    dump_config,
    make_run_dirs,
    run_comment,
)
from vfd_gan_tpu_torch.ops.image import threshold
from vfd_gan_tpu_torch.ops.morphology import video_open
from vfd_gan_tpu_torch.parallel.mesh import DataParallel
from vfd_gan_tpu_torch.parallel.pipeline import stage_grid
from vfd_gan_tpu_torch.parallel.prefetch import device_prefetch
from vfd_gan_tpu_torch.train.checkpoints import (
    AsyncSaver,
    best_ckpt_name,
    restore_checkpoint,
    save_checkpoint,
    save_pth,
)


# JAX-engine options the port does not run yet, all of them several-card
# ones: (is it set?, ROADMAP item).
UNPORTED = {
    "sp/tp": (lambda c: c.sp > 1 or c.tp > 1,
              "queue 1 item 13 (parallelism)"),
    "moe_shards": (lambda c: c.moe_shards > 1,
                   "queue 1 item 13 (parallelism)"),
}


def refuse_unported(cfg) -> None:
    """Exit with the ROADMAP item of the first option set that the port
    does not run."""
    for flag, (is_set, item) in UNPORTED.items():
        if is_set(cfg):
            raise SystemExit(f"--{flag}: not ported to vfd_gan_tpu_torch "
                             f"yet (ROADMAP.md {item}); use the JAX "
                             "trainer (python trainer.py)")


def host_arrays(tensors: dict) -> dict:
    """The panels' tensors as host numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in tensors.items()}


class SweepAccumulator:
    """One periodic test sweep: the gt/prediction arrays to score and
    running sums of the per-batch metrics.  The arrays are copied to the
    host, or with ``device=True`` (``--device_scoring``) kept where they
    lie, for ``eval/device_metrics.score_sweep`` to score them there."""

    def __init__(self, device: bool = False):
        self.device = device
        self.gts: list = []
        self.preds: list = []
        self._sums: dict[str, float] = {}
        self.n = 0

    def add(self, gt, pred, metrics=None) -> None:
        if self.device:
            self.gts.append(gt.detach())
            self.preds.append(pred.detach())
        else:
            self.gts.append(gt.detach().cpu().numpy())
            self.preds.append(pred.detach().cpu().numpy())
        for k, v in (metrics or {}).items():
            self._sums[k] = self._sums.get(k, 0.0) + float(v)
        self.n += 1

    def mean_metrics(self) -> dict[str, float]:
        return {k: v / self.n for k, v in self._sums.items()} if self.n \
            else {}


class EngineBase:
    """Common state of the training engines.  An engine implements
    ``_train_step_impl(batch) -> metrics``, ``_update_train_videos()``,
    ``test()`` and ``_nets() -> {name: NetState}``; the supervised engine
    also its own ``_save_weights(head)``."""

    def __init__(self, cfg, train_iter, test_iter, *, device: torch.device,
                 gan: bool):
        refuse_unported(cfg)
        self.cfg = cfg
        self.train_iter = train_iter
        self.test_iter = test_iter
        self.device = device
        # this process's place in a --dp group (world 1 without one);
        # under --pp its stage's dp subgroup of the dp x pp grid
        self.dp = DataParallel.current(device)
        self.grid = None
        if cfg.pp > 1 and self.dp.grouped:
            self.grid = stage_grid(cfg.pp)
            self.dp = DataParallel(self.grid.dp_index, self.grid.dp_size,
                                   True, device, group=self.grid.dp_group,
                                   writes=self.grid.rank == 0)
        # the microbatches whose rows split over the dp ranks: --accum's,
        # or --pp's GPipe microbatches
        self.micro = cfg.n_pp_micro if cfg.pp > 1 else cfg.accum
        if cfg.pp > 1:
            self.dp.forward_micro = self.micro
        if hasattr(train_iter, "rows"):
            train_iter.rows = self.dp.rows(cfg.batchsize, self.micro)
        # what the train step casts its batch to: the nets' dtype
        # (float64 under to_float64)
        self.input_dtype = torch.float32
        writes = self.dp.writes
        self.dirs = make_run_dirs(cfg.result_root, cfg.model,
                                  run_comment(cfg, gan), create=writes)
        self.summary = SummaryLogger(self.dirs.runs,
                                     enabled=cfg.tensorboard and writes)
        if writes:
            dump_config(self.dirs.root, cfg)
        self.global_step = 0
        self.epoch = 0
        self.batch_in_epoch = 0
        self.best_roc = 0.0
        self.best_pr = 0.0
        # wall seconds of each train step, the device synchronised at its
        # end: the step time a user waits for; and of each wait for the
        # step's batch before it
        self.step_seconds: list[float] = []
        self.data_seconds: list[float] = []
        # set to a list to collect the prefetcher's (start, end) CUDA event
        # pairs around each batch's host-to-device copies
        self.h2d_events: list | None = None
        # periodic-summary buffers, flushed every cfg.freq steps
        self.color_videos: dict[str, np.ndarray] = {}
        self.gray_videos: dict[str, np.ndarray] = {}
        self.errors: dict[str, float] = {}
        self.scores: dict[str, float] = {}
        self.hists: dict[str, np.ndarray] = {}
        self._autosaver: AsyncSaver | None = None
        if writes:
            print(f"\n SAVE PATH == {self.dirs.root} \n")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _bind_dp(self) -> None:
        """Point the nets' BatchNorms and dropout at the engine's group."""
        for net in self._nets().values():
            self.dp.bind(net.module)

    def _global(self, b: int) -> int:
        """The global batch's rows when this rank holds ``b`` of them."""
        return b * self.dp.world if self.dp.active else b

    def _mine(self, draws):
        """This rank's rows of draws made for the global batch (the
        augment parameters, AnoGAN's z): every rank draws them all from
        the engine's generator, which so stays the same on every rank."""
        return self.dp.take(draws, self.micro)

    def _step_done(self, *nets) -> None:
        """Average the nets' gradients over the ranks, then step each
        net's optimizer."""
        for net in nets:
            self.dp.mean_grads(net.module)
            net.optimizer.step()

    @contextlib.contextmanager
    def _whole_state(self):
        """This rank's train state whole for the block (every rank enters
        it at the same step; under ``--pp`` the stages' blocks are
        gathered, and released after it)."""
        yield

    def to_float64(self) -> None:
        """Every net, its optimizer state and the train step's batch in
        float64: the precision of the dp equivalence checks
        (``tools/dp_equivalence.py``)."""
        for net in self._nets().values():
            net.module.to(torch.float64)
        self.input_dtype = torch.float64

    def _batches(self, iterator):
        """``iterator``'s batches on the engine's device, copied ahead."""
        return device_prefetch(iterator, self.device,
                               depth=max(1, self.cfg.prefetch),
                               h2d_events=self.h2d_events)

    # -- the training loop -------------------------------------------------
    def train(self) -> None:
        with self._graceful_shutdown() as stop_signal:
            # said once the handlers are in place: a launcher that signals
            # on this line finds them there
            print(f" >> Training model {self.cfg.model}.", flush=True)
            self._train_loop(stop_signal)

    def _train_loop(self, stop_signal) -> None:
        cfg = self.cfg
        latest = self.weight_path("latest.pt")
        for self.epoch in range(self.epoch, cfg.ep):
            if hasattr(self.train_iter, "epoch"):
                # the pass's order follows the epoch; a resumed run
                # fast-forwards within it
                self.train_iter.epoch = self.epoch
                self.train_iter.skip_batches = self.batch_in_epoch
            waited = time.perf_counter()
            for batch in self._batches(self.train_iter):
                t0 = time.perf_counter()
                self.data_seconds.append(t0 - waited)
                self.global_step += 1
                self.batch_in_epoch += 1
                metrics = self._train_step_impl(batch)
                self._sync()
                self.step_seconds.append(time.perf_counter() - t0)

                if self.global_step % cfg.freq == 0:
                    metrics = self.dp.mean_metrics(metrics)
                    self.errors.update(
                        {k: float(v) for k, v in metrics.items()})
                    window = self.step_seconds[-cfg.freq:]
                    self.errors["perf/steps_per_sec"] = (
                        len(window) / sum(window))
                    if self.summary.enabled:
                        # panels exist only for TensorBoard: without a
                        # writer nothing is fetched from the device
                        self._update_train_videos()
                    with self.dp.local():
                        self.test()
                    self.flush_summary()

                if cfg.autosave_every and \
                        self.global_step % cfg.autosave_every == 0:
                    with self._whole_state():
                        if self.dp.writes and cfg.autosave_async:
                            self._async_saver().save(latest,
                                                     self._ckpt_tree())
                        elif self.dp.writes:
                            save_checkpoint(latest, self._ckpt_tree())

                if cfg.max_steps and self.global_step >= cfg.max_steps:
                    self._wait_autosave()
                    print(f" >> Training model {cfg.model}."
                          f"[Stopped at max_steps={cfg.max_steps}]")
                    return

                if self.dp.any(stop_signal() is not None):
                    # SIGTERM/SIGINT (on any rank): park a checkpoint that
                    # resumes exactly, and return instead of dying
                    self._wait_autosave()
                    with self._whole_state():
                        if self.dp.writes:
                            save_checkpoint(latest, self._ckpt_tree())
                    print(f" >> Training model {cfg.model}."
                          f"[Interrupted by signal {stop_signal()}; "
                          f"saved '{latest}'; resume with --resume]")
                    return
                waited = time.perf_counter()
            self.batch_in_epoch = 0
        self._wait_autosave()
        print(f" >> Training model {cfg.model}.[Done]")

    @contextlib.contextmanager
    def _graceful_shutdown(self):
        """SIGTERM and SIGINT latches for the training loop: yields a
        callable that returns the caught signal number (or None); the old
        handlers come back on exit.  Off the main thread ``signal.signal``
        raises ``ValueError`` and nothing is installed."""
        caught: dict = {"sig": None}
        saved = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                saved[sig] = signal.signal(
                    sig, lambda s, _f: caught.__setitem__("sig", s))
            except ValueError:
                pass
        try:
            yield lambda: caught["sig"]
        finally:
            for sig, handler in saved.items():
                signal.signal(sig, handler)

    # -- full train state ----------------------------------------------------
    def _loop_state(self) -> dict:
        """What exact resume needs beyond the nets and their optimizers:
        the state of the engine's generator (augment draws and dropout
        masks come from it) with the device type its layout belongs to,
        the epoch and batch cursor, the iterators' pass counters, and the
        best scores that gate the if-roc-elif-pr rule."""
        return {
            "epoch": self.epoch,
            "batch_in_epoch": self.batch_in_epoch,
            "rng_state": self.rng.get_state(),
            "device": self.device.type,
            "train_iter_epoch": getattr(self.train_iter, "epoch", 0),
            "test_iter_epoch": getattr(self.test_iter, "epoch", 0),
            "best_roc": self.best_roc,
            "best_pr": self.best_pr,
        }

    def _apply_loop_state(self, loop: dict) -> None:
        if loop["device"] != self.device.type:
            raise SystemExit(
                f"--resume: this train state was saved on device "
                f"'{loop['device']}' and cannot continue on "
                f"'{self.device.type}': the random generator's state does "
                "not carry from one device type to another, so the augment "
                "and dropout draws would not be the saved run's (pass "
                f"--device {loop['device']}; the weights alone carry over "
                "as the best .pth files)")
        self.epoch = int(loop["epoch"])
        self.batch_in_epoch = int(loop["batch_in_epoch"])
        self.rng.set_state(loop["rng_state"])
        if hasattr(self.train_iter, "epoch"):
            self.train_iter.epoch = int(loop["train_iter_epoch"])
        if hasattr(self.test_iter, "epoch"):
            self.test_iter.epoch = int(loop["test_iter_epoch"])
        self.best_roc = float(loop["best_roc"])
        self.best_pr = float(loop["best_pr"])

    def _ckpt_tree(self) -> dict:
        """The full train state as a tree of tensors, numbers, strings,
        lists and dicts."""
        tree = {name: {"module": net.module.state_dict(),
                       "optimizer": net.optimizer.state_dict()}
                for name, net in self._nets().items()}
        tree["step"] = self.global_step
        tree["loop"] = self._loop_state()
        return tree

    def restore_into(self, path: str, nets: dict) -> None:
        """Load the train state saved at ``path`` into ``nets`` (name ->
        NetState: modules and optimizers, in place) and into the engine's
        step, generator and loop cursor."""
        if os.path.isdir(path):
            raise SystemExit(
                f"--resume {path}: a directory, as the JAX trainer's Orbax "
                "checkpoints are.  Train state does not cross the two "
                "frameworks; python -m vfd_gan_tpu.cli.export_torch "
                "--ckpt <dir> converts its weights (only) to .pth files")
        if not os.path.isfile(path):
            raise SystemExit(f"--resume {path}: no such file (expected the "
                             "weights/latest.pt of an earlier run)")
        self._wait_autosave()
        tree = restore_checkpoint(path)
        missing = [k for k in (*nets, "step", "loop") if k not in tree]
        if missing:
            raise SystemExit(f"--resume {path}: not this model's train "
                             f"state (no {missing} in it)")
        for name, net in nets.items():
            net.module.load_state_dict(tree[name]["module"], strict=True)
            net.optimizer.load_state_dict(tree[name]["optimizer"])
        self.global_step = int(tree["step"])
        self._apply_loop_state(tree["loop"])

    def _async_saver(self) -> AsyncSaver:
        if self._autosaver is None:
            self._autosaver = AsyncSaver()
        return self._autosaver

    def _wait_autosave(self) -> None:
        """Join an ``--autosave_async`` write in flight (before a final
        save, a restore of the same path, or the process's exit)."""
        if self._autosaver is not None:
            self._autosaver.wait()

    def close(self) -> None:
        self._wait_autosave()
        self.summary.close()

    # -- summaries -----------------------------------------------------------
    def viz_morphology(self, pred: torch.Tensor):
        """Thresholded and opened masks for the summary videos, computed
        when a summary is flushed and not in every train step (the test
        step computes its own: there the opened mask is what is scored)."""
        with torch.no_grad():
            t_pre = threshold(pred)
            return t_pre, video_open(t_pre, self.cfg.morph_plane)

    @property
    def panel_step(self) -> bool:
        """Is this a step whose panels go to TensorBoard?  Only then does
        a train step keep the tensors the panels are made of."""
        return self.summary.enabled \
            and self.global_step % self.cfg.freq == 0

    @property
    def stuck_in_eval(self) -> bool:
        """Under ``--ref_mode_quirks``: has the reference's ``.eval()``
        latch engaged?  The reference's supervised ``test()`` switches the
        model to eval mode and never back (lib/train_stcnn.py:143), so
        every train step after the first periodic test runs without
        dropout and with frozen BN statistics.  The loop tests at step
        ``freq``, after that step's update, so the latch holds from step
        ``freq + 1``; it follows from ``global_step`` and so survives a
        resume."""
        return self.cfg.ref_mode_quirks and self.global_step > self.cfg.freq

    def score_and_checkpoint(self, gts, predicts,
                             save_fn) -> tuple[float, float, float]:
        """Flatten, score ROC/PR/F1 and apply the if-roc-elif-pr rule;
        ``save_fn(head)`` writes the weights."""
        nan = float("nan")
        if len(gts) == 0:
            print(" >> test sweep produced no batches "
                  "(empty/short test split); scores are NaN")
            self.scores.update({"score/roc": nan, "score/pr": nan,
                                "score/f1": nan})
            return nan, nan, nan
        if getattr(getattr(self, "cfg", None), "device_scoring", False):
            return self._score_on_device(gts, predicts, save_fn)
        curves = self._curves_dir
        labels = np.asarray(gts, dtype=np.int32).ravel()
        preds = np.asarray(predicts).ravel()
        if (labels == labels.flat[0]).all():
            print(" >> test labels are single-class; ROC/PR are undefined "
                  "(scores NaN, no checkpoint)")
            self.scores.update({"score/roc": nan, "score/pr": nan,
                                "score/f1": nan})
            return nan, nan, nan
        roc = evaluate(labels, preds, self.best_roc, self.epoch, curves,
                       metric="roc")
        pr = evaluate(labels, preds, self.best_pr, self.epoch, curves,
                      metric="pr")
        f1 = evaluate(labels, preds, metric="f1_score")
        if roc > self.best_roc:
            self.best_roc = roc
            save_fn("roc")
        elif pr > self.best_pr:
            self.best_pr = pr
            save_fn("pr")
        self.scores.update({"score/roc": roc, "score/pr": pr, "score/f1": f1})
        return roc, pr, f1

    def _score_on_device(self, gts, predicts,
                         save_fn) -> tuple[float, float, float]:
        """``--device_scoring``: the sweep's tensors stacked and scored on
        their device; the same if-roc-elif-pr rule, and a single-class
        sweep scores NaN and saves nothing, as on the host path."""
        # stacking needs one batch shape (drop_last iterators)
        shapes = {tuple(g.shape) for g in gts} | {
            tuple(p.shape) for p in predicts}
        if len(shapes) > 1:
            raise ValueError(
                f"--device_scoring needs uniform per-batch shapes "
                f"(drop_last iterator); got {sorted(shapes)}")
        roc_v, eer_v, pr_v, f1_v = score_sweep(torch.stack(gts),
                                               torch.stack(predicts))
        roc, pr, f1 = float(roc_v), float(pr_v), float(f1_v)
        if not np.isfinite(roc):
            print(" >> test labels are single-class; ROC/PR are undefined "
                  "(scores NaN, no checkpoint)")
            pr = f1 = float("nan")
        elif roc > self.best_roc:
            self.best_roc = roc
            save_fn("roc")
        elif pr > self.best_pr:
            self.best_pr = pr
            save_fn("pr")
        self.scores.update({"score/roc": roc, "score/pr": pr,
                            "score/f1": f1, "score/eer": float(eer_v)})
        return roc, pr, f1

    @property
    def _writes(self) -> bool:
        """Does this process write the run's files (rank 0 of a --dp
        group, or no group)?"""
        dp = getattr(self, "dp", None)
        return dp is None or dp.writes

    @property
    def _curves_dir(self) -> str | None:
        """Where the sweep's curve CSVs go: the run dir on the writing
        rank, nowhere on the others."""
        return self.dirs.root if self._writes else None

    def flush_summary(self) -> None:
        """Send the window's panels, scalars and scores to TensorBoard,
        print the scalars and scores and append them to ``metrics.jsonl``
        (the writing rank)."""
        if not self._writes:
            return
        self.summary.update(self.global_step,
                            color_videos=self.color_videos,
                            gray_videos=self.gray_videos,
                            errors=self.errors, scores=self.scores,
                            hists=self.hists)
        rec = {"step": self.global_step, "epoch": self.epoch,
               **{k: float(v) for k, v in self.errors.items()},
               **{k: float(v) for k, v in self.scores.items()}}
        print(" >> " + " ".join(
            f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in rec.items()), flush=True)
        with open(os.path.join(self.dirs.root, "metrics.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")

    def _save_weights(self, head: str) -> None:
        """A best model as the reference's GAN engines save it: one
        ``{head}_ep{NNNN}_{net}.pth`` per net (``netG``, ``netD``); the
        writing rank alone."""
        if not self._writes:
            return
        for net, state in self._nets().items():
            save_pth(self.weight_path(
                best_ckpt_name(head, self.epoch, net) + ".pth"),
                state.module, self.epoch)

    def weight_path(self, name: str) -> str:
        return os.path.join(self.dirs.weights, name)
