"""Clip dataset over ``[Fake]``/``[Original]``/``[Mask]`` video triples
(port of ``vfd_gan_tpu.data.dataset``).

File names (reference lib/data.py:35-44): each listed video lies in a
directory named after the clip; its siblings are ``[Mask]<dirname>.mp4``
and ``[Original]<dirname>.mp4`` beside it.  The dataset's indices are
consecutive non-overlapping ``nfr``-frame windows, counted from the *mask*
videos through a cumulative table with the reference's off-by-one window
arithmetic (``data/native.window_table``).

The host decodes and resizes to a fixed staging size; all augmentation
geometry runs on the device (``ops/augment.py``).  Batches are numpy uint8
``(B, nfr, S, S, C)``, equal to the JAX package's on the same files
(``tests/test_torch_port_data.py``).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass

import numpy as np

from vfd_gan_tpu_torch.data import native
from vfd_gan_tpu_torch.data.video_io import count_frames, read_clip


def derive_triple(data_path: str) -> tuple[str, str, str]:
    """(data, real, mask) paths from one listed video path (reference
    lib/data.py:39-44)."""
    root = os.path.dirname(data_path)
    name = os.path.basename(root)
    return (data_path,
            os.path.join(root, f"[Original]{name}.mp4"),
            os.path.join(root, f"[Mask]{name}.mp4"))


@dataclass
class ClipRecord:
    video_idx: int
    first_frame: int


class MdfVideoDataset:
    """Window-indexed dataset of (data, real, mask, label) clips.

    ``staging`` is the host resize target (H == W); ``None`` keeps the
    files' resolution.  ``__getitem__`` returns uint8 arrays: data and
    real ``(nfr, S, S, 3)``, mask ``(nfr, S, S, 1)``, and the per-frame
    label vector (ones for Fake clips, zeros for Original ones,
    lib/data.py:68,76; no loss reads it).
    """

    def __init__(self, path_list_file: str, nfr: int,
                 staging: int | None = None):
        self.nfr = nfr
        self.staging = staging
        with open(path_list_file) as f:
            data_paths = [ln.rstrip() for ln in f if ln.strip()]
        triples = [derive_triple(p) for p in data_paths]
        self.data_paths = [t[0] for t in triples]
        self.real_paths = [t[1] for t in triples]
        self.mask_paths = [t[2] for t in triples]

        frames_per_video = [count_frames(p) for p in self.mask_paths]
        video_idx, first_frame = native.window_table(frames_per_video, nfr)
        self._records = [ClipRecord(int(v), int(f))
                         for v, f in zip(video_idx, first_frame)]

    def __len__(self) -> int:
        return len(self._records)

    def is_fake(self, index: int) -> bool:
        return "Fake" in self.data_paths[self._records[index].video_idx]

    def __getitem__(self, index: int):
        rec = self._records[index]
        size = (self.staging, self.staging) if self.staging else None
        data = read_clip(self.data_paths[rec.video_idx], rec.first_frame,
                         self.nfr, resize_to=size)
        if self.is_fake(index):
            real = read_clip(self.real_paths[rec.video_idx], rec.first_frame,
                             self.nfr, resize_to=size)
            mask = read_clip(self.mask_paths[rec.video_idx], rec.first_frame,
                             self.nfr, resize_to=size, mask=True)
            label = np.ones(self.nfr, np.float32)
        else:
            # Original clips: an all-zero mask, real == data
            # (lib/data.py:71-76)
            real = data
            mask = np.zeros(data.shape[:3] + (1,), np.uint8)
            label = np.zeros(self.nfr, np.float32)
        return data, real, mask, label


class ClipBatchIterator:
    """Shuffled, drop-last batch iterator over any dataset with ``__len__``
    and ``__getitem__``, decoding on a producer thread.

    As ``torch.utils.data.DataLoader(batch_size, drop_last=True,
    shuffle=True)`` for both splits (lib/data.py:153-160; the reference
    shuffles its test split during training too).  cv2 releases the GIL
    while it decodes, so the producer thread (and its ``workers`` pool)
    overlaps host IO with the device's step.

    Exact resume: the shuffle order is a function of ``(seed, epoch)`` alone
    (numpy's ``default_rng``, as in the JAX package: both yield the same
    batches), so the iterator's state is two ints, ``epoch`` (which pass is
    next) and ``skip_batches`` (how far into that pass to fast-forward).

    ``rows`` (set by a ``--dp`` engine): the indices of this rank's rows
    within each batch; the order is the same on every rank and each
    decodes only its rows.  ``frames`` (set by an ``--sp`` engine): the
    slice of this rank's frames, kept of each decoded clip (``label``'s
    too).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, prefetch: int = 2, workers: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.prefetch = max(1, prefetch)
        self.workers = max(1, workers)
        self.seed = seed
        self.epoch = 0          # index of the next pass (shuffle-order key)
        self.skip_batches = 0   # fast-forward within the next pass (resume)
        # a --dp rank's rows of each batch (None: all of them), an --sp
        # rank's frames of each clip
        self.rows = None
        self.frames = None
        self._pool = None

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def _assemble(self, indices) -> dict[str, np.ndarray]:
        if self.workers > 1:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor
                self._pool = ThreadPoolExecutor(self.workers)
            items = list(self._pool.map(self.dataset.__getitem__, indices))
        else:
            items = [self.dataset[i] for i in indices]
        batch = {
            "data": native.pack_clips([it[0] for it in items]),
            "real": native.pack_clips([it[1] for it in items]),
            "mask": native.pack_clips([it[2] for it in items]),
            "label": np.stack([it[3] for it in items]),
        }
        if self.frames is not None:
            batch = {k: np.ascontiguousarray(v[:, self.frames])
                     for k, v in batch.items()}
        # global clip ids: the key of per-clip caches across the shuffled
        # sweeps (--cache_gt_flow); not a reference field
        batch["index"] = np.asarray(indices, np.int32)
        return batch

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(order)
        n_batches = len(self)
        start = min(self.skip_batches, n_batches)
        self.skip_batches = 0
        if n_batches == 0:
            self.epoch += 1
            return
        q = native.make_queue(self.prefetch + 1)
        stop = threading.Event()

        def producer():
            for b in range(start, n_batches):
                if stop.is_set():
                    return
                idx = order[b * self.batch_size:(b + 1) * self.batch_size]
                if self.rows is not None:
                    # the same order on every rank; each decodes its rows
                    idx = idx[np.asarray(self.rows)]
                try:
                    if not q.put(self._assemble(idx), stop_event=stop):
                        return
                except Exception as e:  # a decode error goes to the consumer
                    q.put(e, stop_event=stop)
                    return
            q.put(None, stop_event=stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    self.epoch += 1  # a completed pass: the next order
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
