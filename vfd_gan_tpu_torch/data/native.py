"""The host runtime ``native/vfd_host.cpp`` bound through ctypes (port of
``vfd_gan_tpu.data.native``), with its plain Python forms.

Three entries: the dataset's window table (``window_table``), the batch
packing of decoded clips (``pack_clips``) and the single-producer,
single-consumer ring that hands batches from the decode thread to the
train loop (``RingQueue``, ``make_queue``).  ``data/dataset.py`` uses the
library; the ``*_plain`` forms compute the same tables, batches and queue
behaviour in Python and are what the tests hold the library to.

The library is built at first use, never on import: ``g++ -O3 -std=c++17
-fPIC -shared -lpthread`` (``$CXX`` if set) compiles the source where it
lies into ``build/vfd_gan_tpu_torch/`` at the root of the checkout, named
by a hash of the source and the flags, as the CUDA kernels are
(``ops/cuda/__init__.py``).  A failed build or load raises with the
compiler's message: nothing falls back to the Python forms on its own.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import queue
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "vfd_host.cpp"
BUILD_DIR = ROOT / "build" / "vfd_gan_tpu_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
LIBS = ("-lpthread",)

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
_PI64 = ctypes.POINTER(ctypes.c_int64)
# every C entry: (argument types, result type)
ENTRIES = {
    "vfd_window_table": ([_PI64, _I64, _I64, _PI64, _PI64], _I64),
    "vfd_pack_clips": ([ctypes.POINTER(_P), _I64, _I64, _P, _I32, _I32],
                       None),
    "vfd_ring_create": ([_I64], _P),
    "vfd_ring_destroy": ([_P], None),
    "vfd_ring_acquire_produce": ([_P], _I64),
    "vfd_ring_publish": ([_P, _I64], None),
    "vfd_ring_acquire_consume": ([_P], _I64),
    "vfd_ring_release": ([_P, _I64], None),
}

_lock = threading.Lock()
_library: ctypes.CDLL | None = None


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("the host runtime needs a C++ compiler: g++ not "
                           "found on PATH (or set CXX)")
    return cxx


def library_path(source: Path = SOURCE) -> Path:
    """Where the library for ``source`` and the flags lives (built or
    not)."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    digest.update(source.read_bytes())
    return BUILD_DIR / f"libvfd_host_{digest.hexdigest()[:16]}.so"


def build(source: Path = SOURCE) -> Path:
    """Compile ``source`` unless a library for it already exists; raises
    ``RuntimeError`` with the compiler's output if it fails."""
    target = library_path(source)
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build to a private name, then rename: a concurrent build or load
    # never sees a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = os.path.join(tmp, "lib.so")
        cmd = [_compiler(), *CXX_FLAGS, "-o", lib, str(source), *LIBS]
        try:
            done = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"building the host runtime failed: "
                               f"{cmd[0]} did not run ({e})") from e
        if done.returncode:
            raise RuntimeError(
                f"building the host runtime failed ({' '.join(cmd)}):\n"
                f"{done.stdout}{done.stderr}")
        os.replace(lib, target)
    return target


def load() -> ctypes.CDLL:
    """The library, built if needed, with every entry's types declared."""
    global _library
    with _lock:
        if _library is None:
            lib = ctypes.CDLL(str(build()))
            for name, (args, res) in ENTRIES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = res
            _library = lib
    return _library


# -- the window table ---------------------------------------------------------

def window_table(frames_per_video, nfr: int):
    """``(video_idx, first_frame)`` arrays for every dataset index, with the
    reference's boundary arithmetic (lib/data.py:84-89; ``window_table_
    plain``), computed by the library."""
    frames = np.ascontiguousarray(frames_per_video, dtype=np.int64)
    total = int((frames // nfr).sum()) if len(frames) else 0
    video = np.empty(total, np.int64)
    first = np.empty(total, np.int64)
    n = load().vfd_window_table(
        frames.ctypes.data_as(_PI64), len(frames), nfr,
        video.ctypes.data_as(_PI64), first.ctypes.data_as(_PI64))
    if n != total:
        raise RuntimeError(f"vfd_window_table returned {n} windows, "
                           f"expected {total}")
    return video, first


def window_table_plain(frames_per_video, nfr: int):
    """``window_table`` in Python: the start frame of index ``i`` is ``(i -
    cum[prev] - 1) * nfr``, one window too early, so index 0 underflows
    (clamped to frame 0), the first two indices of the first video share
    window 0, and a video's last window is reached only from the boundary
    index."""
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


# -- batch packing ------------------------------------------------------------

def pack_clips(clips: list[np.ndarray], invert: bool = False,
               n_threads: int | None = None) -> np.ndarray:
    """K equally shaped uint8 clips as one ``(K, ...)`` batch (bitwise-not
    with ``invert``), copied by the library on ``n_threads`` threads
    (default: min(K, cores, 4))."""
    if not clips:
        raise ValueError("pack_clips needs at least one clip")
    clips = [np.ascontiguousarray(c, dtype=np.uint8) for c in clips]
    shape = clips[0].shape
    if any(c.shape != shape for c in clips):
        raise ValueError(f"pack_clips needs equal shapes, got "
                         f"{sorted({c.shape for c in clips})}")
    if n_threads is None:
        n_threads = max(1, min(len(clips), os.cpu_count() or 1, 4))
    out = np.empty((len(clips), *shape), np.uint8)
    ptrs = (_P * len(clips))(*(c.ctypes.data for c in clips))
    load().vfd_pack_clips(ptrs, len(clips), clips[0].nbytes,
                          out.ctypes.data, int(invert), n_threads)
    return out


def pack_clips_plain(clips: list[np.ndarray],
                     invert: bool = False) -> np.ndarray:
    """``pack_clips`` in numpy."""
    batch = np.stack(clips)
    return ~batch if invert else batch


# -- the hand-over queue ------------------------------------------------------

class RingQueue:
    """The library's SPSC ring between one producer thread and one
    consumer: the ring sequences the slots (lock-free atomics), the Python
    objects ride in a slot table.  A waiting side polls every
    ``spin_sleep`` seconds."""

    def __init__(self, n_slots: int, spin_sleep: float = 0.001):
        self._lib = load()
        self._ring = self._lib.vfd_ring_create(n_slots)
        self._slots: list = [None] * n_slots
        self._sleep = spin_sleep

    def put(self, item, stop_event=None) -> bool:
        """Blocking put; False if ``stop_event`` fires first."""
        while True:
            slot = self._lib.vfd_ring_acquire_produce(self._ring)
            if slot >= 0:
                break
            if stop_event is not None and stop_event.is_set():
                return False
            time.sleep(self._sleep)
        self._slots[slot] = item
        self._lib.vfd_ring_publish(self._ring, slot)
        return True

    def get(self):
        while True:
            slot = self._lib.vfd_ring_acquire_consume(self._ring)
            if slot >= 0:
                break
            time.sleep(self._sleep)
        item, self._slots[slot] = self._slots[slot], None
        self._lib.vfd_ring_release(self._ring, slot)
        return item

    def __del__(self):
        if getattr(self, "_ring", None):
            self._lib.vfd_ring_destroy(self._ring)
            self._ring = None


class PlainQueue:
    """``RingQueue``'s behaviour on ``queue.Queue``."""

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


def make_queue(n_slots: int) -> RingQueue:
    """The hand-over queue between a producer thread and the train loop:
    the library's ring."""
    return RingQueue(n_slots)


def make_queue_plain(n_slots: int) -> PlainQueue:
    return PlainQueue(n_slots)
