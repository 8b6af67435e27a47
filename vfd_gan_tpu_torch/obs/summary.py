"""Run directories and TensorBoard summaries (port of
``vfd_gan_tpu.obs.summary``).

The reference's layout (lib/train_gan.py:33-50): a run dir
``result_root/model/{comment}/{timestamp}`` with ``weights/`` and ``runs/``
and an ``args.txt`` JSON dump of the config; the comment is
``b{B}xd{nfr}xwh{isize}_lr-{lr}_w-a{w_adv}c{w_con}`` for a GAN run
(lib/train_gan.py:35-36), ``b{B}xd{nfr}xwh{isize}_lr{lr}`` for a
supervised one (lib/train_stcnn.py:37).  Every ``freq`` steps the engines
flush tiled video grids, nested scalars (``add_scalars`` on the tag's head
with its tail as the series, lib/utils.py:36-39), plain scores and
histograms.

Videos arrive channel-last ``(B, T, H, W, C)``; a grid tiles the batch
along the width of each frame.  Colour entries are min-max normalised per
tensor (the reference's ``make_grid(normalize=True)``), gray entries
clipped to [0, 1].

The writer is ``torch.utils.tensorboard``'s, imported when a logger is
built: where the ``tensorboard`` package is missing the logger is disabled
and says so once, and the run goes on with ``metrics.jsonl``.  Its
``add_video`` encodes through ``moviepy``; where that is missing the
video panels are left out (said once) and scalars, scores and histograms
are still written.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from datetime import datetime

import numpy as np

_said: set[str] = set()


def _say_once(msg: str) -> None:
    if msg not in _said:
        _said.add(msg)
        print(msg, flush=True)


@dataclasses.dataclass
class RunDirs:
    root: str
    weights: str
    runs: str


def make_run_dirs(result_root: str, model: str, comment: str,
                  create: bool = True) -> RunDirs:
    """The run's directories, made unless ``create`` is false (a ``--dp``
    rank that writes nothing)."""
    stamp = datetime.now().strftime("%b%d_%H-%M-%S")
    root = os.path.join(result_root, model, comment, stamp)
    dirs = RunDirs(root=root, weights=os.path.join(root, "weights"),
                   runs=os.path.join(root, "runs"))
    for d in (dirs.root, dirs.weights, dirs.runs) if create else ():
        os.makedirs(d, exist_ok=True)
    return dirs


def run_comment(cfg, gan: bool) -> str:
    """The reference's run-dir comment (lib/train_gan.py:35-36 for a GAN
    run, lib/train_stcnn.py:37 for a supervised one)."""
    base = f"b{cfg.batchsize}xd{cfg.nfr}xwh{cfg.isize}"
    if gan:
        return f"{base}_lr-{cfg.lr}_w-a{cfg.w_adv}c{cfg.w_con}"
    return f"{base}_lr{cfg.lr}"


def dump_config(run_root: str, cfg) -> None:
    with open(os.path.join(run_root, "args.txt"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=4)


def _to_grid(video: np.ndarray, normalize: bool) -> np.ndarray:
    """(B, T, H, W, C) float -> (T, C, H, B*W) float grid in [0, 1]."""
    v = np.asarray(video, np.float32)
    if normalize:
        lo, hi = v.min(), v.max()
        v = (v - lo) / (hi - lo + 1e-5)
    else:
        v = np.clip(v, 0.0, 1.0)
    if v.shape[-1] == 1:
        v = np.repeat(v, 3, axis=-1)
    b, t, h, w, c = v.shape
    grid = v.transpose(1, 2, 0, 3, 4).reshape(t, h, b * w, c)
    return grid.transpose(0, 3, 1, 2)  # (T, C, H, B*W)


class SummaryLogger:
    """TensorBoard writer; inert when disabled or when no writer can be
    built."""

    def __init__(self, logdir: str, enabled: bool = True):
        self._writer = None
        self.videos = False
        if not enabled:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            _say_once(" >> the tensorboard package is not installed: no "
                      "TensorBoard summaries, metrics.jsonl only")
            return
        self._writer = SummaryWriter(log_dir=logdir)
        self.videos = importlib.util.find_spec("moviepy") is not None
        if not self.videos:
            _say_once(" >> the moviepy package is not installed: "
                      "TensorBoard gets scalars, scores and histograms, no "
                      "video panels")

    @property
    def enabled(self) -> bool:
        """True when updates reach a writer; the engines fetch
        TensorBoard-only arrays from the device only then (and the video
        panels only when ``videos``)."""
        return self._writer is not None

    def update(self, step: int, *, color_videos=None, gray_videos=None,
               errors=None, scores=None, hists=None) -> None:
        w = self._writer
        if w is None:
            return
        if self.videos:
            for tag, v in (color_videos or {}).items():
                w.add_video(tag, _to_grid(v, True)[None], step, fps=4)
            for tag, v in (gray_videos or {}).items():
                w.add_video(tag, _to_grid(v, False)[None], step, fps=4)
        for tag, e in (errors or {}).items():
            head, tail = tag.rsplit("/", 1)
            w.add_scalars(head, {tail: float(e)}, step)
        for tag, s in (scores or {}).items():
            w.add_scalar(tag, float(s), step)
        for tag, h in (hists or {}).items():
            w.add_histogram(tag, np.asarray(h), step)
        w.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None
