"""Where a train step's time goes on the card, by kernel.

    python -m vfd_gan_tpu_torch.tools.profile_step --model clstm \
        [--compute_dtype float32]

builds the trainer's engine for the given flags (those of
``vfd_gan_tpu_torch.cli.trainer``; synthetic data, b8, T16, 128^2 and the
trainer's own ``--compute_dtype``, bfloat16, unless given), warms it up,
then reports

* the step time as a user waits for it: host clock around steps that end
  in a synchronise, median over ``--steps``;
* under ``torch.profiler`` over ``--steps`` more steps: the card's time per
  step summed over all kernels, its share of the profiled wall time, and
  the kernels by name, grouped into families, in ms per step.

The profiler itself slows a step of many small launches, so the busy share
to quote is device time per step over the unprofiled step time, which the
last line gives.  It needs a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time

import torch

from vfd_gan_tpu_torch.cli.trainer import build_engine

# family -> substrings of kernel names (first match wins, in this order)
FAMILIES = (
    ("conv3x3 kernel", ("conv3x3_kernel",)),
    ("other port kernels", ("augment_kernel", "open_kernel", "fused_kernel",
                            "refine_kernel", "warp_kernel")),
    ("cuDNN wgrad", ("wgrad",)),
    ("cuDNN other", ("cudnn", "fprop", "dgrad", "implicit", "convolve",
                     "nchwToNhwc", "nhwcToNchw")),
    ("matmul (cuBLAS)", ("gemm", "cutlass", "splitK", "gemv")),
    ("copies and fills", ("Memcpy", "Memset", "copy", "fill")),
    ("elementwise and reductions", ("elementwise", "reduce", "Tensor",
                                    "kernel")),
)


def family_of(name: str) -> str:
    for family, keys in FAMILIES:
        if any(k in name for k in keys):
            return family
    return "other"


def main(argv=None) -> dict:
    own = argparse.ArgumentParser(description=__doc__.split("\n")[0],
                                  add_help=False)
    own.add_argument("--steps", type=int, default=4)
    own.add_argument("--warmup", type=int, default=3)
    own.add_argument("--top", type=int, default=12)
    ns, rest = own.parse_known_args(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: torch.cuda.is_available() is False: "
                         "this needs an NVIDIA card")
    defaults = ["--batchsize", "8", "--nfr", "16", "--isize", "128",
                "--ep", "1", "--device", "cuda",
                "--synthetic_data", str(ns.warmup + 2 * ns.steps)]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        engine = build_engine([*defaults, *rest, "--result_root", tmp])
        batches = iter(engine.train_iter)

        def step() -> float:
            t0 = time.perf_counter()
            engine._train_step_impl(next(batches))
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0)

        for _ in range(ns.warmup):
            step()
        plain = [step() for _ in range(ns.steps)]
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            profiled = [step() for _ in range(ns.steps)]
    by_name: dict[str, list[float]] = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.key] = [us / 1e3 / ns.steps, ev.count / ns.steps]
    device_ms = sum(v[0] for v in by_name.values())
    if device_ms == 0:
        raise SystemExit("profile_step: the profiler recorded no device "
                         "time")
    families: dict[str, list[float]] = {}
    for name, (ms, count) in by_name.items():
        fam = families.setdefault(family_of(name), [0.0, 0.0])
        fam[0] += ms
        fam[1] += count
    step_ms = statistics.median(plain)
    print(f"model {engine.cfg.model} {engine.cfg.compute_dtype}: step "
          f"{step_ms:.1f} ms (median of "
          f"{ns.steps}, min {min(plain):.1f}, max {max(plain):.1f}); under "
          f"the profiler {statistics.median(profiled):.1f} ms")
    print(f"device time per step {device_ms:.1f} ms in "
          f"{sum(v[1] for v in by_name.values()):.0f} kernels: "
          f"{100 * device_ms / step_ms:.1f}% of the unprofiled step, "
          f"{100 * device_ms / statistics.median(profiled):.1f}% of the "
          "profiled one")
    for fam, (ms, count) in sorted(families.items(), key=lambda kv: -kv[1][0]):
        print(f"  {fam:28s} {ms:8.2f} ms  {count:7.0f} launches  "
              f"{100 * ms / device_ms:5.1f}%")
    print(f"top {ns.top} kernels by device time per step:")
    for name, (ms, count) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:ns.top]:
        print(f"  {ms:8.2f} ms  {count:6.0f} x  {name[:110]}")
    result = {"model": engine.cfg.model, "dtype": engine.cfg.compute_dtype,
              "step_ms": step_ms,
              "device_ms_per_step": device_ms,
              "families": {k: v[0] for k, v in families.items()}}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
