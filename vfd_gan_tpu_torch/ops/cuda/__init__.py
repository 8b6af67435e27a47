"""Build and load the port's hand-written CUDA kernels.

Every ``*.cu`` file in this directory is compiled by ``nvcc`` into one
shared library with a plain C interface, loaded with :mod:`ctypes`.  The
library lives in ``build/vfd_gan_tpu_torch/`` at the root of the checkout,
named by a hash of the sources and flags, so an edited source rebuilds.  The
build happens at first use, never on import: a machine without ``nvcc`` or a
card still imports every module.

``nvcc`` is taken from ``$CUDA_HOME/bin``, then ``PATH``, then the toolkit
that PyTorch itself found.  A missing ``nvcc`` or a failed compile raises
with the compiler's own output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

SOURCE_DIR = Path(__file__).resolve().parent
BUILD_DIR = SOURCE_DIR.parents[2] / "build" / "vfd_gan_tpu_torch"
# sm_90a: Hopper with its architecture-specific instructions.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_library: ctypes.CDLL | None = None


def sources() -> list[Path]:
    return sorted(SOURCE_DIR.glob("*.cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.isfile(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libvfd_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for them already exists."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent build or load
    # never sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources())]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
                f"{res.stdout}{res.stderr}")
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _library
    with _lock:
        if _library is None:
            lib = ctypes.CDLL(str(build()))
            # Every pointer and the stream as c_void_p: without argtypes
            # ctypes passes Python ints as 32-bit C ints and cuts pointers.
            fn = lib.vfd_morphology_open_f32
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _library = lib
        return _library
