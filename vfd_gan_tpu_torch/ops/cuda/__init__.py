"""Build and load the port's hand-written CUDA kernels.

Every ``*.cu`` file in this directory is compiled by ``nvcc`` (one process
per source, all started together) and linked into one shared library with
a plain C interface, loaded with :mod:`ctypes`.  The library lives in
``build/vfd_gan_tpu_torch/`` at the root of the checkout, named by a hash
of the sources, the ``*.cuh`` headers they include and the flags, so an
edited source or header rebuilds.  The build happens at first use, never
on import: a machine without ``nvcc`` or a card still imports every module.

``nvcc`` is taken from ``$CUDA_HOME/bin``, then ``PATH``, then the toolkit
that PyTorch itself found.  A missing ``nvcc`` or a failed compile raises
with the compiler's own output.

``--fmad=false``: no multiply-add contraction, so a kernel rounds each
product and sum on its own, as PyTorch's elementwise kernels do, and the
plain versions compute the same float32 function.
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
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_library: ctypes.CDLL | None = None


# The C entry points: argument types in order, the stream last.  Every
# pointer and the stream are c_void_p: without argtypes ctypes passes
# Python ints as 32-bit C ints and cuts pointers.
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
ENTRIES = {
    "vfd_morphology_open_f32": ([_P, _P, _L, _I, _I, _I] + [_L] * 8
                                + [_I] * 4 + [_P], ctypes.c_int),
    "vfd_flow_warp_f32": ([_P, _P, _P, _L, _I, _I, _I, _P], ctypes.c_int),
    "vfd_flow_refine_f32": ([_P] * 7 + [_L, _I, _I, _I, _P], ctypes.c_int),
    "vfd_flow_fused_f32": ([_P] * 7 + [_L, _I, _I, _I, _I, _P],
                           ctypes.c_int),
    "vfd_flow_workspace_bytes": ([_I, _I, _I], ctypes.c_longlong),
    "vfd_augment_gather_u8": ([_P] * 10 + [_L] + [_I] * 6 + [_P],
                              ctypes.c_int),
    "vfd_conv3x3_f32": ([_P, _P, _P, _L, _I, _I, _I, _I, _I, _P],
                        ctypes.c_int),
}


def sources() -> list[Path]:
    return sorted(SOURCE_DIR.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(SOURCE_DIR.glob("*.cuh"))


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
    for src in sources() + headers():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libvfd_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for them already exists."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # compile into a private directory, link to a private name, then
    # rename: a concurrent build or load never sees a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in sources():
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        for cmd, _, proc in jobs:
            _finish(cmd, proc)
        lib = os.path.join(tmp, "lib.so")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", lib,
               *(obj for _, obj, _ in jobs)]
        _finish(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
        os.replace(lib, target)
    return target


def _finish(cmd: list[str], proc: subprocess.Popen) -> None:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{out}")


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _library
    with _lock:
        if _library is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in ENTRIES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _library = lib
        return _library


def launch(entry: str, like, *args) -> None:
    """Call the C entry ``entry`` with ``args`` and the current stream of
    ``like``'s device; raise if it returns a CUDA error."""
    import torch

    with torch.cuda.device(like.device):
        stream = torch.cuda.current_stream(like.device).cuda_stream
        err = getattr(library(), entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed on {tuple(like.shape)}: "
                           f"cudaError {err}")
