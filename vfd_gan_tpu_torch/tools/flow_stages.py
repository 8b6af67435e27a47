"""Where the Farneback solver kernels' time goes on the card, by stage.

    python -m vfd_gan_tpu_torch.tools.flow_stages [--sizes 64,32,16,128]
        [--baseline DIR]

builds ``flow_fused.cu`` and ``flow_refine.cu`` a second time with
``-DVFD_STAGE_CLOCKS`` (``ops/cuda/flow_common.cuh``: thread 0 of every
block notes the SM's cycle counter at each stage boundary and the device's
nanosecond timer at entry and exit), launches the fused kernel (3 rounds)
and the refine kernel on the train step's 240 fields per size behind ~3 ms
of other work, and prints per kernel and size

* when the blocks started and ended (one wave or several),
* the time of each stage (set-up, stage A of round 0, then per round the W
  pass and the H pass with the solve and the next round's stage A), median
  and maximum over the blocks,
* the launch's time from a CUDA event pair, clocks compiled out, and with
  stage A's bilinear gathers replaced by plain reads (a wrong result: it
  prices the gathers).

``--baseline DIR`` names a directory with the solver sources as they were
before the register-tiled design (``flow_common.cuh``, ``flow_fused.cu``,
``flow_refine.cu``, ``launch_common.cuh``: one block per field, one output
per thread and tap loop, 64-bit indices).  The tool then also builds that
version as it is and with one change each (32-bit indices; the interior
weight a constant; stage A, B or C left out, which gives a wrong result and
prices the stage), and times all of them beside the current kernels in two
rounds within this one process.  A substitution that does not find its
text stops the tool: the baseline is not the version it was written for.

It needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import statistics
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from vfd_gan_tpu_torch.ops import cuda, warp
from vfd_gan_tpu_torch.ops.corr import band_table, box_taps
from vfd_gan_tpu_torch.ops.flow import _poly_planes
from vfd_gan_tpu_torch.ops.flow_fused import flow_refine_fused_plain
from vfd_gan_tpu_torch.ops.flow_refine import WINSIZE

SOLVER_SOURCES = ("flow_fused.cu", "flow_refine.cu")
CLOCKED_BLOCKS, CLOCK_SLOTS = 1024, 16       # flow_common.cuh
FIELDS = 240       # the train step's: 2 streams x b8 x 15 frame pairs
STAGES = ("setup", "A0", "W0", "C0", "W1", "C1", "W2", "C2")

# -- one change each to the earlier version's flow_common.cuh ------------------
# name -> ((pattern, replacement, occurrences), ...), plain text
_LL = "static_cast<long long>"
INT32 = ((f"const long long hw = {_LL}(h) * w;", "const int hw = h * w;", 1),
         ("for (long long pix = ", "for (int pix = ", 2),
         (f"{_LL}(y) * w", "y * w", 2),
         ("for (long long e = ", "for (int e = ", 1),
         ("const long long row0 = ", "const int row0 = ", 1),
         (f"{_LL}(i) * w", "i * w", 1))
CONSTW = (
    ("      for (int d = 0; d < k; ++d) {\n        const int j = x + d - r;",
     "      if (x >= r && x + r < w) {\n"
     "        const float cw = wt[r];\n"
     "        for (int d = 0; d < k; ++d)\n"
     "          acc += cw * __bfloat162float(q[row0 + x + d - r]);\n"
     "      } else\n"
     "      for (int d = 0; d < k; ++d) {\n        const int j = x + d - r;",
     1),
    ("        for (int d = 0; d < k; ++d) {\n          const int i = y + d - r;",
     "        if (y >= r && y + r < h) {\n"
     "          const float cw = ht[r];\n"
     "          for (int d = 0; d < k; ++d)\n"
     "            acc += cw * __bfloat162float(col[(y + d - r) * w]);\n"
     "        } else\n"
     "        for (int d = 0; d < k; ++d) {\n          const int i = y + d - r;",
     1))
_PIX = "for (long long pix = threadIdx.x; pix < hw;"
BASELINE_VARIANTS = {      # label -> (substitutions, result still exact)
    "earlier": ((), True),
    "earlier, 32-bit indices": (INT32, True),
    "earlier, interior weight constant": (CONSTW, True),
    "earlier, both": (INT32 + CONSTW, True),
    # the n-th occurrence only: see _substitute
    "earlier, no stage A": (((_PIX, _PIX.replace("< hw", "< 0"), (2, 0)),),
                            False),
    "earlier, no stage B": ((("e < kPolyPlanes * hw;", "e < 0;", 1),), False),
    "earlier, no stage C": (((_PIX, _PIX.replace("< hw", "< 0"), (2, 1)),),
                            False),
}
NO_GATHER = (("  if (kWarp) {\n    const BilinearTaps taps",
              "  if (false) {\n    const BilinearTaps taps", 1),)


def _substitute(text: str, subs) -> str:
    """Apply ``(old, new, count)`` in turn; ``count`` is how often ``old``
    must occur (all are replaced), or ``(count, n)`` to replace only the
    ``n``-th of ``count`` occurrences."""
    for old, new, count in subs:
        count, nth = count if isinstance(count, tuple) else (count, None)
        found = text.count(old)
        if found != count:
            raise SystemExit(f"flow_stages: expected {count} x {old!r} in "
                             f"flow_common.cuh, found {found}")
        if nth is None:
            text = text.replace(old, new)
        else:
            at = [m.start() for m in re.finditer(re.escape(old), text)][nth]
            text = text[:at] + new + text[at + len(old):]
    return text


def start_build(src_dir: Path, out_dir: Path, subs=(), flags=()):
    """Start one nvcc that compiles the solver sources of ``src_dir``, their
    ``flow_common.cuh`` edited by ``subs``, into ``out_dir/lib.so``."""
    out_dir.mkdir(parents=True)
    for path in list(src_dir.glob("*.cuh")) + [src_dir / s
                                               for s in SOLVER_SOURCES]:
        shutil.copy(path, out_dir / path.name)
    common = out_dir / "flow_common.cuh"
    common.write_text(_substitute(common.read_text(), subs))
    # -fno-gnu-unique: several of these libraries are loaded side by side,
    # and each needs its own function-local statics (the shared-memory
    # opt-in is noted per kernel variant in one)
    cmd = [cuda._nvcc(), *cuda.NVCC_FLAGS, *flags, "-Xcompiler",
           "-fno-gnu-unique", "-Xptxas", "-v", "-shared",
           "-o", str(out_dir / "lib.so"),
           *(str(out_dir / s) for s in SOLVER_SOURCES)]
    return out_dir / "lib.so", subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish_build(label: str, lib_path: Path, proc) -> ctypes.CDLL:
    text, _ = proc.communicate()
    if proc.returncode:
        raise SystemExit(f"flow_stages: nvcc failed for {label}:\n"
                         f"{text[-4000:]}")
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", text)]
    print(f"built [{label}]: registers {min(regs)}-{max(regs)} over "
          f"{len(regs)} kernels, spill stores {sum(spills)} bytes",
          flush=True)
    lib = ctypes.CDLL(str(lib_path))
    for name in ("vfd_flow_fused_f32", "vfd_flow_refine_f32",
                 "vfd_flow_workspace_bytes"):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = cuda.ENTRIES[name]
    return lib


def flow_case(device, n: int, size: int):
    """Polynomial planes (N, 5, S, S) of smooth frames and of copies moved
    by (1, 2) px, and a random flow of ~1 px."""
    g = torch.Generator(device=device).manual_seed(size)
    yy = torch.arange(size, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(size, device=device, dtype=torch.float32)[None, :]
    phase = torch.rand(n, 1, 1, generator=g, device=device) * 6.28

    def frame(dx, dy):
        return 128 + 60 * torch.sin(0.15 * (xx - dx) + phase) * torch.cos(
            0.12 * (yy - dy)) + 30 * torch.sin(0.11 * (xx + yy - dx - dy))

    planes = _poly_planes(torch.cat([frame(0, 0), frame(1, 2)]))
    flow = torch.randn(n, 2, size, size, generator=g, device=device)
    return planes[:n].contiguous(), planes[n:].contiguous(), flow


def call(lib, entry: str, p1, p2, flow, *extra) -> torch.Tensor:
    n, _, h, w = p1.shape
    taps = box_taps(WINSIZE)
    per_field = lib.vfd_flow_workspace_bytes(h, w, WINSIZE)
    if per_field < 0:
        raise SystemExit(f"flow_stages: no plan for {h} x {w}: cudaError "
                         f"{-per_field}")
    workspace = torch.empty(n * per_field, dtype=torch.uint8,
                            device=p1.device)
    out = torch.empty_like(flow)
    err = getattr(lib, entry)(
        p1.data_ptr(), p2.data_ptr(), flow.data_ptr(),
        band_table(h, taps, p1.device).data_ptr(),
        band_table(w, taps, p1.device).data_ptr(), out.data_ptr(),
        workspace.data_ptr() if per_field else None, n, h, w, WINSIZE,
        *extra, torch.cuda.current_stream().cuda_stream)
    if err:
        raise SystemExit(f"flow_stages: {entry} returned cudaError {err}")
    return out


def event_ms(fn, lead, reps: int = 20, calls: int = 10) -> float:
    """Median ms per call over ``reps`` event pairs round ``calls`` calls,
    each pair behind a matmul of ``lead`` so that it spans device time."""
    for _ in range(5):
        fn()
    pairs = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.mm(lead, lead)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) / calls for s, e in pairs)


def stage_report(lib, kernel: str, launch, lead) -> None:
    """One clocked launch of ``kernel`` ("fused" or "refine") and its
    stages; rounds that did not run show as 0."""
    for _ in range(30):
        launch()
    torch.mm(lead, lead)
    launch()
    torch.cuda.synchronize()
    buf = np.zeros(CLOCKED_BLOCKS * CLOCK_SLOTS, np.uint64)
    reader = getattr(lib, f"vfd_flow_{kernel}_stage_clocks")
    reader.argtypes = [ctypes.c_void_p]
    if reader(buf.ctypes.data):
        raise SystemExit("flow_stages: reading the stage clocks failed")
    c = buf.reshape(CLOCKED_BLOCKS, CLOCK_SLOTS)[:FIELDS].astype(np.int64)
    t0 = c[:, 0].min()
    start, end = (c[:, 0] - t0) / 1e3, (c[:, 15] - t0) / 1e3
    ghz = np.median((c[:, 14] - c[:, 1]) / (c[:, 15] - c[:, 0]))
    rounds = 3 if kernel == "fused" else 1
    us = np.diff(c[:, 1:4 + 2 * rounds], axis=1) / ghz / 1e3
    print(f"  {kernel}: {len(c)} blocks at {ghz:.3f} GHz; start us "
          f"min/median/max {start.min():.2f}/{np.median(start):.2f}/"
          f"{start.max():.2f}; end median/max {np.median(end):.2f}/"
          f"{end.max():.2f}")
    print("    stage us, median over blocks (max): " + ", ".join(
        f"{name} {np.median(us[:, i]):.2f} ({us[:, i].max():.2f})"
        for i, name in enumerate(STAGES[:us.shape[1]])))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--sizes", default="64,32,16,128")
    parser.add_argument("--baseline", type=Path, default=None)
    ns = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flow_stages: torch.cuda.is_available() is False: "
                         "this needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    lead = torch.ones((4096, 4096), device=device)
    cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cuda.BUILD_DIR) as tmp:
        tmp = Path(tmp)
        specs = [("clocked", cuda.SOURCE_DIR, (), ("-DVFD_STAGE_CLOCKS",),
                  True),
                 ("current", cuda.SOURCE_DIR, (), (), True),
                 ("current, stage A without gathers", cuda.SOURCE_DIR,
                  NO_GATHER, (), False)]
        if ns.baseline is not None:
            specs += [(label, ns.baseline, subs, (), exact) for label,
                      (subs, exact) in BASELINE_VARIANTS.items()]
        jobs = [start_build(src, tmp / f"v{i}", subs, flags)
                for i, (_, src, subs, flags, _) in enumerate(specs)]
        libs = [finish_build(spec[0], *job) for spec, job in zip(specs, jobs)]
        clocked, timed = libs[0], list(zip(specs[1:], libs[1:]))
        for size in (int(s) for s in ns.sizes.split(",")):
            p1, p2, flow = flow_case(device, FIELDS, size)
            zero = torch.zeros_like(flow)
            w2 = warp.bilinear_warp_plain(p2, flow)
            want = flow_refine_fused_plain(p1, p2, zero, WINSIZE, 3)
            print(f"{FIELDS} fields of {size} x {size}:", flush=True)
            stage_report(clocked, "fused", lambda: call(
                clocked, "vfd_flow_fused_f32", p1, p2, zero, 3), lead)
            stage_report(clocked, "refine", lambda: call(
                clocked, "vfd_flow_refine_f32", p1, w2, flow), lead)
            for rnd in range(2):
                for (label, _, _, _, exact), lib in timed:
                    note = ""
                    if exact and rnd == 0:
                        got = call(lib, "vfd_flow_fused_f32", p1, p2, zero, 3)
                        note = (f"; max-abs against the plain version "
                                f"{(got - want).abs().max().item():.3g}")
                    ms = [event_ms(fn, lead) for fn in (
                        lambda: call(lib, "vfd_flow_fused_f32", p1, p2, zero,
                                     3),
                        lambda: call(lib, "vfd_flow_fused_f32", p1, p2, zero,
                                     1),
                        lambda: call(lib, "vfd_flow_refine_f32", p1, w2,
                                     flow))]
                    print(f"  [{label}] fused 3 rounds {ms[0]:.4f} ms, 1 "
                          f"round {ms[1]:.4f}, refine {ms[2]:.4f}{note}",
                          flush=True)


if __name__ == "__main__":
    main()
