"""The host runtime's three entry points in pure Python (port of the
fallbacks of ``vfd_gan_tpu.data.native``).

The JAX package binds ``native/vfd_host.cpp`` through ctypes and falls back
to Python where the library is missing; the port has the Python forms only
(binding the library is ``ROADMAP.md`` queue 1 item 14).  They give the
same tables, batches and queue behaviour as the native ones.
"""

from __future__ import annotations

import queue

import numpy as np


def window_table(frames_per_video, nfr: int):
    """``(video_idx, first_frame)`` arrays for every dataset index, with the
    reference's boundary arithmetic (lib/data.py:84-89): the start frame of
    index ``i`` is ``(i - cum[prev] - 1) * nfr``, one window too early, so
    index 0 underflows (clamped to frame 0), the first two indices of the
    first video share window 0, and a video's last window is reached only
    from the boundary index."""
    frames = np.ascontiguousarray(frames_per_video, dtype=np.int64)
    cum = np.cumsum(frames // nfr)
    total = int(cum[-1]) if len(cum) else 0
    video = np.empty(total, np.int64)
    first = np.empty(total, np.int64)
    for index in range(total):
        v = int(np.argmax(cum >= index))
        prev = int(cum[v - 1]) if v > 0 else 0
        video[index] = v
        first[index] = max(0, (index - prev - 1) * nfr)
    return video, first


def pack_clips(clips: list[np.ndarray]) -> np.ndarray:
    """K equally shaped uint8 clips as one ``(K, ...)`` batch."""
    return np.stack(clips)


class _PyQueue:
    """A bounded queue whose ``put`` gives up when ``stop_event`` is set."""

    def __init__(self, n_slots: int):
        self._q = queue.Queue(maxsize=n_slots)

    def put(self, item, stop_event=None) -> bool:
        """Blocking put; False if ``stop_event`` fires first."""
        while True:
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                if stop_event is not None and stop_event.is_set():
                    return False

    def get(self):
        return self._q.get()


def make_queue(n_slots: int) -> _PyQueue:
    """The hand-over queue between a producer thread and the train loop."""
    return _PyQueue(n_slots)
