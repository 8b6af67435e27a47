"""Run directories, the training loop and the best-checkpoint rule (port of
``vfd_gan_tpu.train.engine_base``).

* Run dir ``result_root/model/{comment}/{timestamp}`` with ``weights/``
  and ``runs/`` and an ``args.txt`` JSON dump of the config; the comment
  is ``b{B}xd{nfr}xwh{isize}_lr-{lr}_w-a{w_adv}c{w_con}`` for a GAN run
  (lib/train_gan.py:33-50), ``b{B}xd{nfr}xwh{isize}_lr{lr}`` for a
  supervised one (lib/train_stcnn.py:37; ``obs/summary.run_comment``).
* ``refuse_unported``: the options the port does not run yet exit with
  the ``ROADMAP.md`` item that holds them.
* The epoch/step loop: every ``freq`` steps the step's scalars are
  fetched, the periodic test sweep runs, and the scalars and scores are
  printed and appended to ``metrics.jsonl`` in the run dir.
* ``score_and_checkpoint``: gt cast to int32 (truncation binarises
  fractional mask edges, models/mygannet.py:444), NaN scores for a
  single-class or empty sweep, and the reference's rule: save on a ROC
  improvement, else on a PR improvement (models/mygannet.py:449-454).

Not ported yet (ROADMAP.md queue 1 item 7): TensorBoard panels, autosave,
SIGTERM parking and exact resume.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from datetime import datetime

import numpy as np
import torch

from vfd_gan_tpu_torch.eval.metrics import evaluate


@dataclasses.dataclass
class RunDirs:
    root: str
    weights: str
    runs: str


def make_run_dirs(result_root: str, model: str, comment: str) -> RunDirs:
    stamp = datetime.now().strftime("%b%d_%H-%M-%S")
    root = os.path.join(result_root, model, comment, stamp)
    dirs = RunDirs(root=root, weights=os.path.join(root, "weights"),
                   runs=os.path.join(root, "runs"))
    for d in (dirs.root, dirs.weights, dirs.runs):
        os.makedirs(d, exist_ok=True)
    return dirs


def run_comment(cfg, gan: bool) -> str:
    """The reference's run-dir comment (lib/train_gan.py:35-36 for a GAN
    run, lib/train_stcnn.py:37 for a supervised one)."""
    base = f"b{cfg.batchsize}xd{cfg.nfr}xwh{cfg.isize}"
    if gan:
        return f"{base}_lr-{cfg.lr}_w-a{cfg.w_adv}c{cfg.w_con}"
    return f"{base}_lr{cfg.lr}"


# JAX-engine options the port does not run yet: (is it set?, ROADMAP
# item); ``GAN_ONLY`` are MyGAN's, which the supervised engine ignores as
# the JAX one does
UNPORTED = {
    "accum": (lambda c: c.accum > 1, "queue 1 item 13 (--accum)"),
    "remat": (lambda c: c.remat, "queue 1 item 13 (--remat)"),
    "ae": (lambda c: c.ae, "queue 1 item 9 (the AutoEncoder as G)"),
    "int8_disc": (lambda c: c.int8_disc, "queue 1 item 15 (quant)"),
    "host_flow": (lambda c: c.host_flow,
                  "queue 1 item 12 (train/host_flow.py)"),
    "cache_gt_flow": (lambda c: c.cache_gt_flow,
                      "queue 1 item 7 (gt-flow cache)"),
    "ref_mode_quirks": (lambda c: c.ref_mode_quirks,
                        "queue 1 item 7 (train-mode test sweep)"),
    "device_scoring": (lambda c: c.device_scoring,
                       "queue 1 item 12 (eval/device_metrics.py)"),
    "resume": (lambda c: bool(c.resume),
               "queue 1 item 7 (exact resume)"),
    "autosave_every": (lambda c: c.autosave_every > 0,
                       "queue 1 item 7 (autosave)"),
    "dp/sp/tp/pp": (lambda c: c.dp > 1 or c.sp > 1 or c.tp > 1 or c.pp > 1,
                    "queue 1 item 13 (parallelism)"),
    "moe_experts": (lambda c: c.moe_experts > 0,
                    "queue 1 item 13 (the MoE block)"),
}
GAN_ONLY = ("ae", "int8_disc", "host_flow", "cache_gt_flow")


def refuse_unported(cfg, gan: bool) -> None:
    """Exit with the ROADMAP item of the first option set that the port
    does not run."""
    for flag, (is_set, item) in UNPORTED.items():
        if (gan or flag not in GAN_ONLY) and is_set(cfg):
            raise SystemExit(f"--{flag}: not ported to vfd_gan_tpu_torch "
                             f"yet (ROADMAP.md {item}); use the JAX "
                             "trainer (python trainer.py)")


class SweepAccumulator:
    """One periodic test sweep: host gt/prediction arrays for scoring and
    running sums of the per-batch metrics."""

    def __init__(self):
        self.gts: list[np.ndarray] = []
        self.preds: list[np.ndarray] = []
        self._sums: dict[str, float] = {}
        self.n = 0

    def add(self, gt, pred, metrics=None) -> None:
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
    ``_train_step_impl(batch) -> metrics``, ``test()`` and
    ``_save_weights(head)``."""

    def __init__(self, cfg, train_iter, test_iter, *, device: torch.device,
                 gan: bool):
        refuse_unported(cfg, gan)
        self.cfg = cfg
        self.train_iter = train_iter
        self.test_iter = test_iter
        self.device = device
        self.dirs = make_run_dirs(cfg.result_root, cfg.model,
                                  run_comment(cfg, gan))
        with open(os.path.join(self.dirs.root, "args.txt"), "w") as f:
            json.dump(dataclasses.asdict(cfg), f, indent=4)
        self.global_step = 0
        self.epoch = 0
        self.best_roc = 0.0
        self.best_pr = 0.0
        # wall seconds of each train step, the device synchronised at its
        # end: the step time a user waits for
        self.step_seconds: list[float] = []
        self.errors: dict[str, float] = {}
        self.scores: dict[str, float] = {}
        print(f"\n SAVE PATH == {self.dirs.root} \n")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train(self) -> None:
        cfg = self.cfg
        print(f" >> Training model {cfg.model}.")
        for self.epoch in range(cfg.ep):
            for batch in self.train_iter:
                self.global_step += 1
                t0 = time.perf_counter()
                metrics = self._train_step_impl(batch)
                self._sync()
                self.step_seconds.append(time.perf_counter() - t0)
                if self.global_step % cfg.freq == 0:
                    self.errors.update(
                        {k: float(v) for k, v in metrics.items()})
                    window = self.step_seconds[-cfg.freq:]
                    self.errors["perf/steps_per_sec"] = (
                        len(window) / sum(window))
                    self.test()
                    self.flush_summary()
                if cfg.max_steps and self.global_step >= cfg.max_steps:
                    print(f" >> Training model {cfg.model}."
                          f"[Stopped at max_steps={cfg.max_steps}]")
                    return
        print(f" >> Training model {cfg.model}.[Done]")

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
        labels = np.asarray(gts, dtype=np.int32).ravel()
        preds = np.asarray(predicts).ravel()
        if (labels == labels.flat[0]).all():
            print(" >> test labels are single-class; ROC/PR are undefined "
                  "(scores NaN, no checkpoint)")
            self.scores.update({"score/roc": nan, "score/pr": nan,
                                "score/f1": nan})
            return nan, nan, nan
        roc = evaluate(labels, preds, self.best_roc, self.epoch,
                       self.dirs.root, metric="roc")
        pr = evaluate(labels, preds, self.best_pr, self.epoch,
                      self.dirs.root, metric="pr")
        f1 = evaluate(labels, preds, metric="f1_score")
        if roc > self.best_roc:
            self.best_roc = roc
            save_fn("roc")
        elif pr > self.best_pr:
            self.best_pr = pr
            save_fn("pr")
        self.scores.update({"score/roc": roc, "score/pr": pr, "score/f1": f1})
        return roc, pr, f1

    def flush_summary(self) -> None:
        """Print the window's scalars and scores and append them to
        ``metrics.jsonl``."""
        rec = {"step": self.global_step, "epoch": self.epoch,
               **{k: float(v) for k, v in self.errors.items()},
               **{k: float(v) for k, v in self.scores.items()}}
        print(" >> " + " ".join(
            f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in rec.items()), flush=True)
        with open(os.path.join(self.dirs.root, "metrics.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")

    def weight_path(self, name: str) -> str:
        return os.path.join(self.dirs.weights, name)
