#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one NVIDIA
card.

Run from the root of a checkout, with one card and no arguments::

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from this checkout's sources and
runs the port (``vfd_gan_tpu_torch``, never jax nor the JAX package) in
phases, one line each (or a few):

1. device: the card's name and power limit (nvidia-smi);
2. build: the kernel library (one nvcc per source, in parallel), timed;
3. kernel vs plain: the opening kernel against its plain PyTorch version
   at the infer shapes in both planes, k = 3 and 5, binary and float
   masks, and a 512 x 512 plane (the tiled branch): bit-equal, then timed
   with CUDA events (20 repetitions of 10 back-to-back calls);
4. flow kernels vs plain: the warp, refine and fused kernels at the train
   step's shapes (240 fields at 64^2, 32^2 and 16^2, and 128^2 for
   flow_scale 1.0) on polynomial planes of smooth frames with a planted
   (1, 2) px shift, against their plain versions (warp <= 1e-5 x max|field|,
   refine and fused q99 <= 1e-3 px), the fused flow recovering the shift;
   then timed as in phase 3;
5. video_to_flow_rgb: the three ``impl``s on one (16, 16, 128, 128, 3)
   mask batch with streams=2, held against each other;
6. generator: ``Generator(ngf=32)`` with random weights from a seed,
   written as a reference-format ``*_netG.pth`` and loaded back by the
   entry points' loader; its CUDA forward on a (1, 16, 128, 128, 3) clip
   against the CPU (max-abs <= 1e-4, TF32 off), and its b8 forward time;
7. serving: ``cli.serve.serve`` on port 0 at ``--max_batch 8 --nfr 16
   --isize 128 --device cuda``, answering HTTP requests (1 clip; 3 clips
   with ``?mask=1``; a 2-clip ``/predict_stream``; 8 concurrent clips;
   rounds of 8-clip requests for the b8 batch latency);
8. infer: ``cli.infer.predict_clips`` on two uint8 clips, which must go
   through the opening kernel and match the plain opening;
9. train step CUDA vs CPU: one ``MyGanEngine._gan_core`` step at a small
   size from the same weights and the same injected flows, TF32 off:
   losses, updated G and D parameters and D BatchNorm statistics;
10. training: ``cli.trainer.main`` at the reference width (b8, T16, 128^2,
    ngf = ndf = 32, flow_scale 0.5, float32, synthetic data) for a few
    steps and one test sweep; finite losses, ROC/PR/F1, the best
    ``*_netG.pth``/``*_netD.pth`` loaded back with strict=True, step time
    and peak memory;
11. two-kernel path: one train step of that engine with
    ``flow_impl="two_kernel"`` (``--flow_impl two_kernel``), which runs
    the warp and refine kernels;
12. supervised training: ``cli.trainer.main --model clstm`` (8 steps, the
    slice's main path: the augment kernel every step, the 3x3 conv kernel
    forward and dx in the ConvLSTM), then ``--model c2plus1d`` and
    ``--model xception --xwidth 1.0`` (4 steps each), each at b8, T16,
    128^2, float32, with a one-batch sweep; finite losses, ROC/PR/F1, the
    best ``{roc|pr}-*.pth`` loaded back with strict=True, step time, peak
    memory and launch counts.

Before the serving phase come two more kernel phases: the augment gather
kernel against its plain version (bit-equal on all three outputs at the
train shape, a ragged clip and a 45 degree draw) and the 3x3 conv kernel
against ``F.conv2d`` and its autograd (TF32 off; forward 1e-5, dx and dw
1e-4) at the nine distinct launches of one ConvLSTM step (forward F1-F5,
dx D1-D4), a ragged and a wide case, each timed in turns with ``F.conv2d``
(library, kernel, kernel, library); and after the MyGAN step parity, a
CUDA-vs-CPU supervised step for each family at a small size.

Each main path (serve + infer; MyGAN training; the two-kernel step; each
supervised training run) starts with the launch counts of the kernels set
to 0 and reads them after.  Then come one JSON line of kernel results
and, last, ``{"ok": true, "device": {...}}``.  Per kernel the JSON line
holds its time (``ms``), its plain version's (``plain_ms``), the time of
one PyTorch call that computes the same function where there is one
(``library_ms``, else null; the port never calls it), the least time the
card could take (``bound_ms``: the larger of the bytes of the timed shape,
each input read and each output written once, over 3.35 TB/s and its
operations over the peak rate of the pipes that do them, the published
peaks of the H100 SXM: 67 TFLOP/s for float32 operations outside the tensor
cores, and for the conv kernel, whose products run as three tf32 passes on
the tensor cores, three times its float32 operations over 495 TFLOP/s;
``bound_by`` says which), its launches on its main path (``launches``) and
per train step of that path (``launches_per_step``; the opening kernel: per
batch of the test sweep, which alone runs it), both read from the run's
counters; the conv kernel also one entry per shape, and the three flow
kernels one per plane size (``shapes``), the refine and fused kernels' with
the launches per step at that size and, as the conv kernel, their times x
launches summed over one step of their path (``step_ms_sum``,
``step_bound_ms_sum``).  Any failure raises:
the script exits non-zero and prints no last line.  It does the same
without a card, and outside a checkout of the repo.
"""

from __future__ import annotations

import base64
import collections
import json
import math
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
NFR, ISIZE, BATCH = 16, 128, 8
# name -> (source, the TPU kernel it replaces)
KERNELS = {
    "morphology_open": ("vfd_gan_tpu_torch/ops/cuda/morphology_open.cu",
                        "vfd_gan_tpu/ops/pallas/morphology.py:24"),
    "flow_fused": ("vfd_gan_tpu_torch/ops/cuda/flow_fused.cu",
                   "vfd_gan_tpu/ops/pallas/flow_fused.py:68"),
    "flow_warp": ("vfd_gan_tpu_torch/ops/cuda/flow_warp.cu",
                  "vfd_gan_tpu/ops/pallas/warp.py:193"),
    "flow_refine": ("vfd_gan_tpu_torch/ops/cuda/flow_refine.cu",
                    "vfd_gan_tpu/ops/pallas/flow_refine.py:41"),
    "augment_gather": ("vfd_gan_tpu_torch/ops/cuda/augment_gather.cu",
                       "vfd_gan_tpu/ops/pallas/augment.py:54"),
    "conv3x3": ("vfd_gan_tpu_torch/ops/cuda/conv3x3.cu",
                "vfd_gan_tpu/ops/pallas/spatial_conv.py:42"),
}
# the train step's flow fields: 2 streams x B x (T - 1)
FIELDS = 2 * BATCH * (NFR - 1)
# flow levels at flow_scale 0.5 (64, 32, 16) and the top one at 1.0 (128)
FLOW_SIZES = (64, 32, 16, 128)
TRAIN_STEPS = 24
# the supervised families' training phases: model -> (steps, extra flags)
SUPERVISED_RUNS = {"clstm": (8, []), "c2plus1d": (4, []),
                   "xception": (4, ["--xwidth", "1.0"])}


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def event_ms(fn, reps: int = 20, calls: int = 10, warmup: int = 5) -> float:
    """Median over ``reps`` of the time per call of ``fn``, in ms, from one
    CUDA event pair around ``calls`` back-to-back calls.  Before each pair
    the card is given ~3 ms of other work (a 4096^2 float32 matmul), so the
    host enqueues the timed
    calls while the card is still busy and the pair spans the card's time
    for them: a wrapper's host side (checks, allocation, the launch: 20-35
    us) is longer than the device side of a small kernel, and without the
    lead the pair would time the host.  In a train step the host runs
    ahead of the card in the same way."""
    lead = torch.ones((4096, 4096), device="cuda")
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.mm(lead, lead)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) / calls for s, e in pairs)


# published peaks of the H100 SXM (dense): device memory rate, float32 rate
# outside the tensor cores, tf32 rate on them
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_TF32_FLOP_PER_S = 495e12


def bound(nbytes: float, flop: float,
          flop_per_s: float = PEAK_F32_FLOP_PER_S) -> dict:
    """The least time the card could take for ``nbytes`` moved and ``flop``
    operations on pipes of ``flop_per_s``, and which of the two sets it."""
    by_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    by_flop = 1e3 * flop / flop_per_s
    return {"bound_ms": max(by_bytes, by_flop),
            "bound_by": "bytes" if by_bytes >= by_flop else "operations"}


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False: "
                         "this needs an NVIDIA card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    say("device", f"torch {torch.__version__} cuda {torch.version.cuda}; "
                  f"{name}; count {torch.cuda.device_count()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return name


def import_port():
    """The port from this checkout, not from anywhere else on the path."""
    sys.path.insert(0, str(ROOT))
    import vfd_gan_tpu_torch

    where = Path(vfd_gan_tpu_torch.__file__).resolve().parent.parent
    check(where == ROOT, f"vfd_gan_tpu_torch comes from {where}, not {ROOT}")


def phase_build() -> None:
    from vfd_gan_tpu_torch.ops import cuda

    t0 = time.perf_counter()
    cuda.library()
    say("build", f"{cuda.library_path().relative_to(ROOT)} from "
                 f"{[str(s.relative_to(ROOT)) for s in cuda.sources()]} "
                 f"in {time.perf_counter() - t0:.2f} s")


def phase_kernel(device) -> dict:
    from vfd_gan_tpu_torch.ops.morphology import (
        open_planes_cuda,
        open_planes_plain,
    )

    g = torch.Generator(device=device).manual_seed(0)
    cases = {"th": (BATCH * ISIZE, NFR, ISIZE),      # B*W planes of (T, H)
             "hw": (BATCH * NFR, ISIZE, ISIZE),      # B*T planes of (H, W)
             "tiled512": (2, 512, 512)}
    worst = 0.0
    for label, shape in cases.items():
        for k in (3, 5):
            for binary in (True, False):
                x = torch.rand(shape, generator=g, device=device)
                if binary:
                    x = (x > 0.5).float()
                got = open_planes_cuda(x, k)
                want = open_planes_plain(x, k)
                torch.cuda.synchronize()
                worst = max(worst, (got - want).abs().max().item())
                check(torch.equal(got, want),
                      f"kernel == plain at {label} {shape} k={k} "
                      f"binary={binary}")
    say("kernel", f"bit-equal to the plain version in all "
                  f"{len(cases) * 4} cases (max_abs_err {worst})")

    times = {}
    for label in ("th", "hw"):
        x = (torch.rand(cases[label], generator=g, device=device) > 0.5).float()
        kernel = lambda: open_planes_cuda(x, 5)  # noqa: E731
        plain = lambda: open_planes_plain(x, 5)  # noqa: E731
        # ~0.2 s of work first: an idle card runs at a low clock
        for _ in range(1000):
            kernel()
            plain()
        # plain, kernel, kernel, plain
        p1, k1, k2, p2 = (event_ms(fn) for fn in (plain, kernel, kernel,
                                                  plain))
        times[label] = (statistics.median((k1, k2)),
                        statistics.median((p1, p2)))
        say("kernel", f"{label} {cases[label]} k=5: kernel "
                      f"{times[label][0]:.4f} ms, plain "
                      f"{times[label][1]:.4f} ms (medians of 20x10, L2-warm, "
                      f"run as plain/kernel/kernel/plain: {p1:.4f} "
                      f"{k1:.4f} {k2:.4f} {p2:.4f})")
    pred = torch.rand((BATCH, NFR, ISIZE, ISIZE, 1), generator=g,
                      device=device)
    copy_ms = event_ms(lambda: pred.permute(0, 3, 4, 1, 2).contiguous())
    say("kernel", f"th plane permute copy of a {tuple(pred.shape)} pred: "
                  f"{copy_ms:.4f} ms")
    # th planes in and out once; per pixel 2 x 2 x (k - 1) comparisons
    # (erosion and dilation, each separable)
    px = math.prod(cases["th"])
    return {"max_abs_err": worst, "ms": times["th"][0],
            "plain_ms": times["th"][1], "library_ms": None,
            **bound(8 * px, 4 * (5 - 1) * px)}


def _flow_case(device, n: int, h: int, w: int):
    """Polynomial planes (N, 5, H, W) of smooth frames and of copies moved
    by a planted (1, 2) px shift, and a random flow of ~1 px."""
    from vfd_gan_tpu_torch.ops.flow import _poly_planes

    g = torch.Generator(device=device).manual_seed(h)
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    phase = torch.rand(n, 1, 1, generator=g, device=device) * 6.28
    freq = 0.1 + 0.1 * torch.rand(n, 1, 1, generator=g, device=device)

    def frame(dx, dy):
        return 128 + 60 * torch.sin(freq * (xx - dx) + phase) * torch.cos(
            0.8 * freq * (yy - dy)) + 30 * torch.sin(
            0.11 * (xx + yy - dx - dy))

    planes = _poly_planes(torch.cat([frame(0, 0), frame(1, 2)]))
    flow = torch.randn(n, 2, h, w, generator=g, device=device)
    return planes[:n].contiguous(), planes[n:].contiguous(), flow


def _q(err: torch.Tensor, q: float) -> float:
    flat = err.flatten()
    if flat.numel() > 1 << 24:     # torch.quantile's input limit
        flat = flat[torch.randperm(flat.numel(), device=flat.device)
                    [:1 << 24]]
    return torch.quantile(flat, q).item()


def _time_pair(kernel, plain) -> tuple[float, float, str]:
    """Kernel and plain ms, run as plain, kernel, kernel, plain."""
    for _ in range(20):
        kernel()
        plain()
    p1, k1, k2, p2 = (event_ms(fn) for fn in (plain, kernel, kernel, plain))
    return (statistics.median((k1, k2)), statistics.median((p1, p2)),
            f"{p1:.4f} {k1:.4f} {k2:.4f} {p2:.4f}")


def phase_flow_kernels(device) -> dict:
    """Each flow kernel against its plain version at the train step's
    shapes; returns the per-kernel results at the 64^2 level, with one
    entry per size under ``shapes``."""
    from vfd_gan_tpu_torch.ops import flow_fused, flow_refine, warp

    shapes = {name: [] for name in ("flow_warp", "flow_refine", "flow_fused")}
    for size in FLOW_SIZES:
        p1, p2, f = _flow_case(device, FIELDS, size, size)
        zero = torch.zeros_like(f)
        w2 = warp.bilinear_warp_plain(p2, f)
        cases = {
            "flow_warp": (lambda: warp.bilinear_warp_cuda(p2, f),
                          lambda: warp.bilinear_warp_plain(p2, f)),
            "flow_refine": (
                lambda: flow_refine.flow_refine_step_cuda(p1, w2, f, 15),
                lambda: flow_refine.flow_refine_step_plain(p1, w2, f, 15)),
            "flow_fused": (
                lambda: flow_fused.flow_refine_fused_cuda(p1, p2, zero, 15,
                                                          3),
                lambda: flow_fused.flow_refine_fused_plain(p1, p2, zero, 15,
                                                           3)),
        }
        for name, (kernel, plain) in cases.items():
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            err = (got - want).abs()
            worst, q99 = err.max().item(), _q(err, 0.99)
            check(bool(torch.isfinite(got).all()), f"{name} {size}: finite")
            if name == "flow_warp":
                limit = 1e-5 * p2.abs().max().item()
                check(worst <= limit, f"{name} {size}: max-abs {worst} <= "
                                      f"{limit}")
                tol = f"max-abs <= {limit:.3g}"
            else:
                check(q99 <= 1e-3, f"{name} {size}: q99 {q99} <= 1e-3 px")
                tol = "q99 <= 1e-3 px"
            extra = ""
            if name == "flow_fused" and size >= 32:
                inner = got[:, :, 8:-8, 8:-8]
                mx, my = (inner[:, i].median().item() for i in (0, 1))
                check(abs(mx - 1) < 0.3 and abs(my - 2) < 0.3,
                      f"fused flow recovers the (1, 2) shift: ({mx}, {my})")
                extra = f"; planted (1, 2) px -> median ({mx:.3f}, {my:.3f})"
            k_ms, p_ms, order = _time_pair(kernel, plain)
            say("flow", f"{name} {FIELDS}x{size}^2: max-abs {worst:.3g}, "
                        f"q99 {q99:.3g} ({tol}){extra}; kernel {k_ms:.4f} "
                        f"ms, plain {p_ms:.4f} ms (plain/kernel/kernel/plain "
                        f"{order})")
            shapes[name].append({
                "size": size, "max_abs_err": worst, "q99": q99, "ms": k_ms,
                "plain_ms": p_ms, "library_ms": None,
                **_flow_bound(name, FIELDS * size * size)})
        if size == 64:
            shapes["flow_warp"][-1]["library_ms"] = _grid_sample_ms(p2, f)
    keys = ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by")
    results = {}
    for name, cases in shapes.items():
        main_case = next(c for c in cases if c["size"] == 64)
        results[name] = {**{key: main_case[key] for key in keys},
                         "shape": 64, "shapes": cases}
    return results


def _flow_bound(name: str, px: int) -> dict:
    """Bounds of the flow kernels over ``px`` pixels, float32 planes: the
    warp reads 5 planes and a 2-plane flow and writes 5; refine and fused
    read 2 x 5 planes and the flow and write a flow.  Operations per pixel:
    a warp ~50 (4 taps x 5 planes, weights), one solve round ~45 for the
    normal equations and the 2 x 2 solve plus the separable 15-tap box
    blur of 5 sums (2 x 15 x 2 each); the fused kernel runs 3 rounds of
    warp + solve."""
    solve = 45 + 5 * 2 * 15 * 2
    flop = {"flow_warp": 50, "flow_refine": solve,
            "flow_fused": 3 * (50 + solve)}[name]
    planes = {"flow_warp": 12, "flow_refine": 14, "flow_fused": 14}[name]
    return bound(4 * planes * px, flop * px)


def _grid_sample_ms(fields: torch.Tensor, flow: torch.Tensor) -> float:
    """``F.grid_sample`` (bilinear, border padding, align_corners) on a
    grid normalised from the flow ahead of the timing: the one PyTorch
    call that computes the warp.  Only timed here."""
    n, _, h, w = fields.shape
    ys = torch.arange(h, device=flow.device)[None, :, None] + flow[:, 1]
    xs = torch.arange(w, device=flow.device)[None, None, :] + flow[:, 0]
    grid = torch.stack([2 * xs / (w - 1) - 1, 2 * ys / (h - 1) - 1], dim=-1)
    sample = lambda: torch.nn.functional.grid_sample(  # noqa: E731
        fields, grid, mode="bilinear", padding_mode="border",
        align_corners=True)
    ms = event_ms(sample)
    from vfd_gan_tpu_torch.ops.warp import bilinear_warp_cuda
    diff = (sample() - bilinear_warp_cuda(fields, flow)).abs().max().item()
    say("flow", f"flow_warp {n}x{h}^2: F.grid_sample on a precomputed grid "
                f"{ms:.4f} ms (max-abs vs the kernel {diff:.3g} on fields "
                f"of max {fields.abs().max().item():.3g})")
    return ms


def _mask_batch(device, b: int, seed: int) -> torch.Tensor:
    """A streams=2 batch of RGB mask videos (b, 16, 128, 128, 3) in
    [-1, 1]: moving binary squares (gt), then soft copies (predictions)."""
    g = torch.Generator(device=device).manual_seed(seed)
    half = b // 2
    t = torch.arange(NFR, device=device)[None, :, None, None]
    yy = torch.arange(ISIZE, device=device)[None, None, :, None]
    xx = torch.arange(ISIZE, device=device)[None, None, None, :]
    y0 = torch.randint(10, 60, (half, 1, 1, 1), generator=g, device=device)
    x0 = torch.randint(10, 60, (half, 1, 1, 1), generator=g, device=device)
    gt = ((yy >= y0 + t) & (yy < y0 + t + 40) & (xx >= x0 + 2 * t)
          & (xx < x0 + 2 * t + 40)).float()
    pred = 0.2 + 0.6 * gt + 0.05 * torch.rand(gt.shape, generator=g,
                                              device=device)
    video = torch.cat([gt, pred])[..., None].expand(-1, -1, -1, -1, 3)
    return video * 2 - 1


def phase_flow_video(device) -> None:
    from vfd_gan_tpu_torch.ops.flow import IMPLS, video_to_flow_rgb

    video = _mask_batch(device, 16, 1)
    out = {impl: video_to_flow_rgb(video, 0.5, 2, impl) for impl in IMPLS}
    torch.cuda.synchronize()
    ref = out["fused"]
    check(ref.shape == video.shape and bool(torch.isfinite(ref).all()),
          "flow video shape and finite")
    check(ref.min().item() >= -1 - 1e-5 and ref.max().item() <= 1 + 1e-5,
          "flow video in [-1, 1]")
    parts = []
    for impl in ("two_kernel", "warp"):
        err = (out[impl] - ref).abs()
        q99 = _q(err, 0.99)
        check(q99 <= 0.05, f"video_to_flow_rgb {impl} vs fused: q99 {q99}")
        parts.append(f"{impl} vs fused max-abs {err.max().item():.3g} "
                     f"q50 {_q(err, 0.5):.3g} q99 {q99:.3g}")
    ms = event_ms(lambda: video_to_flow_rgb(video, 0.5, 2), reps=5, calls=2,
                  warmup=2)
    say("flowvideo", f"{tuple(video.shape)} streams=2 scale=0.5: "
                     f"{'; '.join(parts)} (bound q99 <= 0.05); fused "
                     f"{ms:.3f} ms per call")


def phase_augment_kernel(device) -> dict:
    """The augment gather kernel against its plain version, bit-equal on
    all three outputs: the train shape, a ragged clip and a 45 degree draw
    that zero-fills heavily; then timed at the train shape."""
    from vfd_gan_tpu_torch.ops import augment

    cases = {"train": (BATCH, NFR, augment.staging_size(ISIZE), ISIZE, None),
             "ragged": (3, 5, 37, 33, None),
             "rot45": (BATCH, NFR, augment.staging_size(ISIZE), ISIZE,
                       math.pi / 4)}
    timed = None
    for label, (b, t, s, isize, angle) in cases.items():
        g = torch.Generator(device=device).manual_seed(b + s)
        streams = [torch.randint(0, 256, (b, t, s, s, c), generator=g,
                                 device=device, dtype=torch.uint8)
                   for c in (3, 3, 1)]
        streams[2] = (streams[2] > 127).to(torch.uint8) * 255
        params = augment.sample_clip_params(g, b, s, isize)
        if angle is not None:
            params = (torch.full_like(params[0], angle),) + params[1:]
        src_x, src_y = (c.contiguous() for c in augment._src_coords(
            *params, s, isize))
        got = augment.augment_gather_cuda(*streams, src_x, src_y)
        want = augment.augment_gather_plain(*streams, src_x, src_y)
        torch.cuda.synchronize()
        for name, a, w in zip(("data", "real", "mask"), got, want):
            check(a.shape == w.shape and torch.equal(a, w),
                  f"augment kernel == plain at {label} ({name})")
        outside = (src_x < 0) | (src_x >= s) | (src_y < 0) | (src_y >= s)
        say("augment", f"{label} b{b} T{t} {s}^2 -> {isize}^2, C 3+3+1: "
                       f"bit-equal on data, real and mask; "
                       f"{outside.float().mean().item():.3f} of the pixels "
                       "zero-filled")
        if timed is None:
            timed = (streams, src_x, src_y)
    streams, src_x, src_y = timed
    k_ms, p_ms, order = _time_pair(
        lambda: augment.augment_gather_cuda(*streams, src_x, src_y),
        lambda: augment.augment_gather_plain(*streams, src_x, src_y))
    say("augment", f"train shape: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms"
                   f" (plain/kernel/kernel/plain {order})")
    # the three uint8 streams and the two coordinate maps in, three
    # float32 clips out; per output value one scaling
    nbytes = sum(t.numel() * t.element_size() for t in (
        *streams, src_x, src_y)) + 4 * 7 * BATCH * NFR * ISIZE * ISIZE
    return {"max_abs_err": 0.0, "ms": k_ms, "plain_ms": p_ms,
            "library_ms": None,
            **bound(nbytes, 7 * BATCH * NFR * ISIZE * ISIZE)}


# The 3x3 conv kernel's cases: id -> (N, H, W, Cin, Cout, flip, launches per
# clstm step, what).  F1-D4 are the nine distinct launches of one ConvLSTM
# step at b8, T16, 128^2 (hidden widths 16/12/12, gate widths 64/48/48):
# the input halves over B*T frames, the hidden halves over B frames once
# per time step, and their input gradients (flip: the kernel reads the
# forward's weights flipped and transposed in place).  The first layer's
# input and each layer's first hidden state need no gradient.
CONV_CASES = {
    "F1": (BATCH * NFR, ISIZE, ISIZE, 3, 64, False, 1, "input half, layer 1"),
    "F2": (BATCH * NFR, ISIZE, ISIZE, 16, 48, False, 1,
           "input half, layer 2"),
    "F3": (BATCH * NFR, ISIZE, ISIZE, 12, 48, False, 1,
           "input half, layer 3"),
    "F4": (BATCH, ISIZE, ISIZE, 16, 64, False, NFR, "hidden half, layer 1"),
    "F5": (BATCH, ISIZE, ISIZE, 12, 48, False, 2 * NFR,
           "hidden half, layers 2-3"),
    "D1": (BATCH, ISIZE, ISIZE, 64, 16, True, NFR - 1, "dx of F4"),
    "D2": (BATCH, ISIZE, ISIZE, 48, 12, True, 2 * (NFR - 1), "dx of F5"),
    "D3": (BATCH * NFR, ISIZE, ISIZE, 48, 16, True, 1, "dx of F2"),
    "D4": (BATCH * NFR, ISIZE, ISIZE, 48, 12, True, 1, "dx of F3"),
    "ragged": (5, 24, 40, 7, 9, False, 0, "ragged 7->9"),
    "wide": (BATCH, ISIZE, ISIZE, 64, 64, False, 0, "wide 64->64"),
}
CONV_LAUNCHES_PER_STEP = sum(c[6] for c in CONV_CASES.values())
# the entry of the kernels line: the first layer's hidden half
CONV_MAIN_CASE = "F4"


def _conv_close(what: str, label: str, got, want, tol: float) -> float:
    err = (got - want).abs()
    check(bool((err <= tol + tol * want.abs()).all()),
          f"conv3x3 {what} at {label}: max-abs {err.max().item()}")
    return err.max().item()


def phase_conv_kernel(device) -> dict:
    """The conv kernel against ``F.conv2d`` and its autograd, TF32 off, at
    every case: through ``conv3x3``, forward rtol = atol = 1e-5 against
    ``F.conv2d`` in float32, dx (the kernel with ``flip``) and dw (tap
    matmuls) 1e-4 against its autograd in float64 (at 64 -> 64 the
    library's own float32 weight gradient is 2e-4 from the float64 one);
    the case's own launch (with ``flip`` for a dx case) 1e-5 against
    ``F.conv2d`` in float32; unit-normal x, w x 0.1, dy unit-normal over
    sqrt(N*H*W).  Then the case's launch timed in turns with ``F.conv2d``
    on the same (for dx: ready flipped) weights.  Returns the kernels-line
    entry, with one entry per case under ``shapes``."""
    from vfd_gan_tpu_torch.ops import spatial_conv

    shapes = []
    for label, (n, h, w, cin, cout, flip, per_step, what) in \
            CONV_CASES.items():
        g = torch.Generator(device=device).manual_seed(cin)
        x = torch.randn((n, h, w, cin), generator=g, device=device)
        k = torch.randn((3, 3, cin, cout), generator=g, device=device) * 0.1
        # scaled so that dw, a sum over every pixel, stays O(1)
        dy = torch.randn((n, h, w, cout), generator=g, device=device) / (
            n * h * w) ** 0.5
        grads = []
        for fn, dtype in ((spatial_conv.conv3x3, torch.float32),
                          (spatial_conv.conv3x3_plain, torch.float64)):
            xa = x.to(dtype, copy=True).requires_grad_()
            ka = k.to(dtype, copy=True).requires_grad_()
            y = fn(xa, ka)
            y.backward(dy.to(dtype))
            grads.append((xa.grad.float(), ka.grad.float()))
            if fn is spatial_conv.conv3x3:
                got = y.detach()
            del xa, ka, y
        torch.cuda.synchronize()
        errs = [_conv_close("forward", label, got,
                            spatial_conv.conv3x3_plain(x, k), 1e-5),
                _conv_close("dx", label, grads[0][0], grads[1][0], 1e-4),
                _conv_close("dw", label, grads[0][1], grads[1][1], 1e-4)]
        del grads, got, dy
        if flip:
            # the launch the backward makes: w (3, 3, Cout, Cin) as it is
            kt = torch.randn((3, 3, cout, cin), generator=g,
                             device=device) * 0.1
            k = kt.flip(0, 1).transpose(2, 3).contiguous()
            kernel = lambda: spatial_conv.conv3x3_cuda(  # noqa: E731
                x, kt, flip=True)
        else:
            kernel = lambda: spatial_conv.conv3x3_cuda(x, k)  # noqa: E731
        library = lambda: spatial_conv.conv3x3_plain(x, k)  # noqa: E731
        own = _conv_close("launch", label, kernel(), library(), 1e-5)
        k_ms, p_ms, order = _time_pair(kernel, library)
        px = n * h * w
        # the products run as three tf32 passes on the tensor cores
        flop = 2 * px * 9 * cin * cout
        limit = bound(4 * (px * (cin + cout) + 9 * cin * cout), 3 * flop,
                      PEAK_TF32_FLOP_PER_S)
        f32_pipes_ms = 1e3 * flop / PEAK_F32_FLOP_PER_S
        say("conv3x3", f"{label} ({what}) N{n} {h}x{w} {cin}->{cout}"
                       f"{' flip' if flip else ''}: max-abs forward "
                       f"{errs[0]:.3g}, dx {errs[1]:.3g}, dw {errs[2]:.3g}, "
                       f"this launch {own:.3g} (<= 1e-5 / 1e-4 / 1e-4 / 1e-5 "
                       f"abs + rel; forward and launch vs F.conv2d float32, "
                       f"dx and dw vs its float64 autograd); kernel {k_ms:.4f} ms, F.conv2d "
                       f"{p_ms:.4f} ms (library/kernel/kernel/library "
                       f"{order}); bound {limit['bound_ms']:.4f} ms by "
                       f"{limit['bound_by']} (its float32 operations on the "
                       f"float32 pipes: {f32_pipes_ms:.4f} ms); x{per_step} "
                       f"per step")
        shapes.append({"id": label, "what": what, "n": n, "h": h, "w": w,
                       "cin": cin, "cout": cout, "flip": flip,
                       "launches_per_step": per_step, "max_abs_err": own,
                       "ms": k_ms, "plain_ms": p_ms, "library_ms": p_ms,
                       **limit, "f32_pipes_ms": f32_pipes_ms})
        del x, k
    step = {key: sum(c["launches_per_step"] * c[key] for c in shapes)
            for key in ("ms", "library_ms", "bound_ms")}
    say("conv3x3", f"times x launches over one clstm step "
                   f"({CONV_LAUNCHES_PER_STEP} launches): kernel "
                   f"{step['ms']:.3f} ms, F.conv2d {step['library_ms']:.3f} "
                   f"ms, bound {step['bound_ms']:.3f} ms")
    main_case = next(c for c in shapes if c["id"] == CONV_MAIN_CASE)
    keys = ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by")
    return {**{key: main_case[key] for key in keys},
            "shape": CONV_MAIN_CASE, "shapes": shapes,
            "step_ms_sum": step["ms"], "step_library_ms_sum":
            step["library_ms"], "step_bound_ms_sum": step["bound_ms"]}


def make_checkpoint(tmp: Path) -> Path:
    """A full-width Generator with random weights from a seed, saved as a
    reference-format .pth.  The head is drawn wider than the reference init
    and zero-mean over each input channel's 27 taps, so that the mask
    follows local structure, crosses the 0.5 threshold and gives the
    opening work to do (at init it sits just above 0.5 everywhere)."""
    from vfd_gan_tpu_torch.models.mygan import Generator

    seed = torch.Generator().manual_seed(0)
    model = Generator(ngf=32, generator=seed)
    with torch.no_grad():
        head = 0.5 * torch.randn(model.conv_last.weight.shape, generator=seed)
        model.conv_last.weight.copy_(
            head - head.mean(dim=(2, 3, 4), keepdim=True))
    path = tmp / "smoke_netG.pth"
    torch.save({"epoch": 0, "state_dict": model.state_dict()}, path)
    return path


def phase_generator(path: Path, device) -> torch.nn.Module:
    from vfd_gan_tpu_torch.cli.infer import _load
    from vfd_gan_tpu_torch.ops.image import to_channel_first
    from vfd_gan_tpu_torch.utils.runtime import resolve_device

    resolve_device("cuda")                       # TF32 off, as the CLIs do
    model, name = _load(str(path), device)
    cpu_model, _ = _load(str(path), torch.device("cpu"))
    clip = np.random.default_rng(1).uniform(
        -1, 1, (1, NFR, ISIZE, ISIZE, 3)).astype(np.float32)
    x = to_channel_first(torch.from_numpy(clip))
    with torch.inference_mode():
        want = cpu_model(x)
        got = model(x.to(device)).cpu()
        err = (got - want).abs().max().item()
        check(got.shape == (1, 1, NFR, ISIZE, ISIZE), f"shape {got.shape}")
        check(bool(torch.isfinite(got).all()), "finite mask")
        check(err <= 1e-4, f"CUDA vs CPU max-abs {err} <= 1e-4")
        x8 = torch.rand((BATCH, 3, NFR, ISIZE, ISIZE), device=device) * 2 - 1
        b8_ms = event_ms(lambda: model(x8), reps=10, calls=1, warmup=3)
    say("generator", f"{name} ngf=32 from {path.name}: CUDA vs CPU max-abs "
                     f"{err:.3g} on a (1,{NFR},{ISIZE},{ISIZE},3) clip; "
                     f"mask in [{got.min().item():.4f}, "
                     f"{got.max().item():.4f}]; b{BATCH} forward "
                     f"{b8_ms:.3f} ms (median of 10)")
    return model


def _post(base: str, path: str, clips: np.ndarray, headers=None) -> dict:
    req = urllib.request.Request(f"{base}{path}", data=clips.tobytes(),
                                 method="POST", headers=headers or {})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def _scores_ok(scores, k: int) -> None:
    s = np.asarray(scores)
    check(s.shape == (k, NFR), f"frame scores shape {s.shape}")
    check(bool(np.all((s >= 0) & (s <= 1))), "frame scores in [0, 1]")


def phase_serve(path: Path, model: torch.nn.Module) -> None:
    from vfd_gan_tpu_torch.cli.serve import build_parser, serve
    from vfd_gan_tpu_torch.ops.image import to_channel_first

    args = build_parser().parse_args(
        ["--ckpt", str(path), "--port", "0", "--max_batch", str(BATCH),
         "--nfr", str(NFR), "--isize", str(ISIZE), "--device", "cuda"])
    httpd = serve(args)
    srv = httpd.inference
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    rng = np.random.default_rng(2)
    clips = lambda k: rng.uniform(  # noqa: E731
        -1, 1, (k, NFR, ISIZE, ISIZE, 3)).astype(np.float32)
    try:
        one = clips(1)
        out = _post(base, "/predict", one)
        _scores_ok(out["frame_scores"], 1)
        with torch.inference_mode():
            direct = model(to_channel_first(torch.from_numpy(one)).cuda())
        want = direct[:, 0].flatten(2).mean(dim=2).cpu().numpy()
        err = float(np.abs(np.asarray(out["frame_scores"]) - want).max())
        check(err <= 1e-5, f"served frame scores vs direct forward {err}")

        out = _post(base, "/predict?mask=1", clips(3), {"X-Clip-Count": "3"})
        _scores_ok(out["frame_scores"], 3)
        check(out["mask_shape"] == [3, NFR, ISIZE, ISIZE], "mask shape")
        check(len(base64.b64decode(out["mask_u8_b64"])) == 3 * NFR * ISIZE ** 2,
              "mask bytes")

        body = clips(2).tobytes()
        with socket.create_connection(httpd.server_address, timeout=300) as sk:
            sk.sendall((f"POST /predict_stream HTTP/1.0\r\n"
                        f"Content-Length: {len(body)}\r\n\r\n").encode())
            sk.sendall(body)
            raw = b""
            while chunk := sk.recv(1 << 16):
                raw += chunk
        lines = [json.loads(ln) for ln in
                 raw.partition(b"\r\n\r\n")[2].splitlines() if ln]
        check([ln["clip"] for ln in lines] == [0, 1], "stream lines")
        _scores_ok([ln["frame_scores"] for ln in lines], 2)

        results: dict = {}
        inputs = [clips(1) for _ in range(BATCH)]
        workers = [threading.Thread(
            target=lambda i: results.__setitem__(
                i, _post(base, "/predict", inputs[i])), args=(i,))
            for i in range(BATCH)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=300)
        check(not any(w.is_alive() for w in workers) and len(results) == BATCH,
              "8 concurrent requests answered")
        for r in results.values():
            _scores_ok(r["frame_scores"], 1)

        n_before = len(srv.latencies_ms)
        request_ms = []
        for _ in range(10):
            t0 = time.perf_counter()
            out = _post(base, "/predict", clips(BATCH),
                        {"X-Clip-Count": str(BATCH)})
            request_ms.append((time.perf_counter() - t0) * 1000)
            _scores_ok(out["frame_scores"], BATCH)
        b8 = sorted(srv.latencies_ms[n_before:])
        with urllib.request.urlopen(f"{base}/stats", timeout=60) as r:
            stats = json.loads(r.read())
        say("serve", f"4 request kinds answered; served vs direct frame "
                     f"scores max-abs {err:.3g}; /stats {json.dumps(stats)}")
        say("serve", f"b{BATCH} batches over 10 requests: median "
                     f"{statistics.median(b8):.2f} ms, max {b8[-1]:.2f} ms; "
                     f"HTTP request p50 {statistics.median(request_ms):.2f} ms"
                     f", max {max(request_ms):.2f} ms (25 MB body each)")
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()
    thread.join(timeout=10)
    check(not thread.is_alive(), "server thread stopped")


def phase_infer(model: torch.nn.Module) -> None:
    from vfd_gan_tpu_torch.cli.infer import predict_clips
    from vfd_gan_tpu_torch.ops.image import threshold
    from vfd_gan_tpu_torch.ops.morphology import open_planes_cuda, video_open

    frames = np.random.default_rng(3).integers(
        0, 256, (2, NFR, ISIZE, ISIZE, 3), dtype=np.uint8)
    before = open_planes_cuda.launches
    pred, opened, scores = predict_clips(model, frames, "th")
    torch.cuda.synchronize()
    check(open_planes_cuda.launches > before, "predict_clips launched the "
                                              "opening kernel")
    check(pred.shape == opened.shape == (2, NFR, ISIZE, ISIZE, 1),
          "infer shapes")
    check(tuple(scores.shape) == (2, NFR), "infer frame scores shape")
    # a CPU tensor takes the plain version
    want = video_open(threshold(pred).cpu(), "th")
    check(torch.equal(opened.cpu(), want), "opened == plain opening of pred")
    on = threshold(pred).mean().item()
    say("infer", f"predict_clips on 2 uint8 clips: mask on {on:.3f} -> "
                 f"{opened.mean().item():.3f} after the th opening, equal to "
                 "the plain version; mp4 decode/encode (cv2) is covered by "
                 "the CPU tests, not run here")


def _wrappers() -> dict:
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from vfd_gan_tpu_torch.ops import (
        augment,
        flow_fused,
        flow_refine,
        spatial_conv,
        warp,
    )
    from vfd_gan_tpu_torch.ops.morphology import open_planes_cuda

    return {"morphology_open": open_planes_cuda,
            "flow_fused": flow_fused.flow_refine_fused_cuda,
            "flow_warp": warp.bilinear_warp_cuda,
            "flow_refine": flow_refine.flow_refine_step_cuda,
            "augment_gather": augment.augment_gather_cuda,
            "conv3x3": spatial_conv.conv3x3_cuda}


def _reset_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
        if hasattr(fn, "launches_by_plane"):
            fn.launches_by_plane.clear()


def _counts() -> dict:
    """Launches per kernel, and for the solver kernels, which count them by
    plane as well, per ``"kernel@HxW"``."""
    counts = {k: fn.launches for k, fn in _wrappers().items()}
    for k, fn in _wrappers().items():
        for (h, w), n in getattr(fn, "launches_by_plane", {}).items():
            counts[f"{k}@{h}x{w}"] = n
    return counts


def run_trainer(argv, engine_cls):
    """``cli.trainer.main(argv)`` as one main path: the kernels' launch
    counts are set to 0 just before it and read just after.  Returns the
    engine, those counts, the part of them made inside the test sweep
    (``engine_cls.test`` is wrapped for the run to read the counters around
    it) and the wall seconds."""
    from vfd_gan_tpu_torch.cli.trainer import main as train_main

    sweep = collections.Counter(dict.fromkeys(_wrappers(), 0))
    test = engine_cls.test

    def counted_test(self):
        before = _counts()
        out = test(self)
        for k, n in _counts().items():
            sweep[k] += n - before.get(k, 0)
        return out

    engine_cls.test = counted_test
    try:
        _reset_counts()                  # the main path starts
        t0 = time.perf_counter()
        engine = train_main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()               # ... and ends
    finally:
        engine_cls.test = test
    return engine, counts, dict(sweep), wall


def phase_step_parity(tmp: Path) -> None:
    """One _gan_core step on the card and on the CPU from the same weights
    and injected flows.  Tolerances: losses 1e-5, except the train-mode
    spatial D's, 5e-4 relative (float32 sums of its BatchNorms in another
    order, amplified through its deep BN chain, as in
    tests/test_torch_port_train.py); updated parameters within Adam's
    first-step sign-flip envelope of 2.5 lr (a conv bias under a BN has a
    true gradient of 0); BN statistics 1e-5 (spatial D: 5e-4 relative)."""
    from vfd_gan_tpu_torch.config import Config
    from vfd_gan_tpu_torch.train.gan_engine import MyGanEngine

    b, s = 2, 64
    cfg = Config(model="mygan", isize=s, nfr=NFR, batchsize=b, ngf=8, ndf=8,
                 ep=1, compute_dtype="float32", result_root=str(tmp))
    rng = np.random.default_rng(4)
    data = rng.uniform(-1, 1, (b, NFR, s, s, 3)).astype(np.float32)
    gt = (rng.uniform(size=(b, NFR, s, s, 1)) > 0.85).astype(np.float32)
    flows = rng.uniform(-1, 1, (2 * b, NFR, s, s, 3)).astype(np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        device = torch.device(dev)
        eng = MyGanEngine(cfg, None, None, device=device)
        eng.netg.drop_rate = 0.0
        fl = torch.from_numpy(flows).to(device)
        eng._flow = lambda v, streams=1, fl=fl: fl  # noqa: E731
        metrics = eng._gan_core(torch.from_numpy(data).to(device),
                                torch.from_numpy(gt).to(device))
        out[dev] = ({k: float(v) for k, v in metrics.items()},
                    {k: v.cpu() for k, v in eng.netg.state_dict().items()},
                    {k: v.cpu() for k, v in eng.netd.state_dict().items()})
    (m_cpu, g_cpu, d_cpu), (m_gpu, g_gpu, d_gpu) = out["cpu"], out["cuda"]
    worst_loss = 0.0
    for k, v in m_cpu.items():
        rel = 5e-4 if ("_s/" in k or k in ("d/err_d_real/train",
                                           "d/err_d_fake/train",
                                           "d/err_d/train", "g/err_g/train",
                                           "g/err_g_adv/train")) else 0.0
        diff = abs(m_gpu[k] - v)
        check(np.isfinite(m_gpu[k]) and diff <= 1e-5 + rel * abs(v),
              f"step loss {k}: cuda {m_gpu[k]} vs cpu {v}")
        worst_loss = max(worst_loss, diff)
    lr = cfg.lr
    worst_param = worst_stat = 0.0
    for sd_cpu, sd_gpu in ((g_cpu, g_gpu), (d_cpu, d_gpu)):
        for k, v in sd_cpu.items():
            if k.endswith("num_batches_tracked"):
                continue
            diff = (sd_gpu[k] - v).abs().max().item()
            if "running" in k:
                bound = 1e-5 + (5e-4 * v.abs().max().item()
                                if k.startswith("spatdisc") else 0.0)
                check(diff <= bound, f"BN stat {k}: {diff} <= {bound}")
                worst_stat = max(worst_stat, diff)
            else:
                check(diff <= 2.5 * lr, f"param {k}: {diff} <= 2.5 lr")
                worst_param = max(worst_param, diff)
    say("stepparity", f"_gan_core b{b} T{NFR} {s}^2 ngf=ndf=8, CUDA vs CPU "
                      f"(TF32 off): losses max-abs {worst_loss:.3g}, params "
                      f"{worst_param:.3g} (<= 2.5 lr = {2.5 * lr:.3g}), BN "
                      f"stats {worst_stat:.3g}")


# the supervised families' CUDA-vs-CPU step sizes (the CPU tests' own):
# model -> (batch, nfr, isize, extra Config fields)
SUPERVISED_PARITY = {"clstm": (2, 8, 16, {}), "c2plus1d": (2, 16, 16, {}),
                     "xception": (2, 8, 32, {"xwidth": 1 / 16})}


def phase_supervised_parity(tmp: Path) -> None:
    """One SupervisedEngine step per family on the card and on the CPU,
    from the same seeded weights and the same injected augment draws
    (gathered by the kernel on the card, by the plain version on the CPU),
    dropout at rate 0.  Tolerances as the CPU tests hold the port to JAX:
    the loss 1e-5, BN statistics 1e-5, updated parameters within Adam's
    first-step envelope of 2.5 lr with at most 2% beyond 5e-6."""
    from vfd_gan_tpu_torch.config import Config
    from vfd_gan_tpu_torch.ops.augment import (
        _src_coords,
        augment_gather,
        staging_size,
    )
    from vfd_gan_tpu_torch.train.supervised_engine import SupervisedEngine

    for family, (b, t, isize, extra) in SUPERVISED_PARITY.items():
        cfg = Config(model=family, batchsize=b, nfr=t, isize=isize, ep=1,
                     compute_dtype="float32", result_root=str(tmp), **extra)
        s = staging_size(isize)
        rng = np.random.default_rng(5)
        data = rng.integers(0, 256, (b, t, s, s, 3), dtype=np.uint8)
        mask = np.zeros((b, t, s, s, 1), np.uint8)
        mask[:, :, 4:s - 4, 5:s - 6] = 255
        draws = (np.linspace(-0.17, 0.15, b).astype(np.float32),
                 np.arange(b) % 2, np.ones(b, np.int64), np.arange(b) % 2 == 0)
        # the source coordinates once, on the CPU: cos and sin on the card
        # may differ by an ulp and flip a floor
        src_x, src_y = (c.contiguous() for c in _src_coords(
            *(torch.from_numpy(np.asarray(v)) for v in draws), s, isize))
        out = {}
        for dev in ("cpu", "cuda"):
            device = torch.device(dev)
            eng = SupervisedEngine(cfg, None, None, device=device)
            for m in eng.model.modules():
                if hasattr(m, "drop_rate"):
                    m.drop_rate = 0.0
            batch = [torch.from_numpy(v).to(device)
                     for v in (data, data, mask)]
            x, _, gt = augment_gather(*batch, src_x.to(device),
                                      src_y.to(device))
            loss = float(eng._step(x, gt)["loss/err/train"])
            out[dev] = (loss, {k: v.cpu() for k, v in
                               eng.model.state_dict().items()})
        (l_cpu, sd_cpu), (l_gpu, sd_gpu) = out["cpu"], out["cuda"]
        check(np.isfinite(l_gpu) and abs(l_gpu - l_cpu) <= 1e-5,
              f"{family} step loss: cuda {l_gpu} vs cpu {l_cpu}")
        lr = cfg.lr
        worst_param = worst_stat = 0.0
        total = loose = 0
        for k, v in sd_cpu.items():
            if k.endswith("num_batches_tracked"):
                continue
            d = (sd_gpu[k] - v).abs()
            if "running" in k:
                check(d.max().item() <= 1e-5, f"{family} BN stat {k}")
                worst_stat = max(worst_stat, d.max().item())
            else:
                check(d.max().item() <= 2.5 * lr, f"{family} param {k}")
                worst_param = max(worst_param, d.max().item())
                total += d.numel()
                loose += int((d > 5e-6).sum())
        check(loose / total < 0.02, f"{family}: {loose} of {total} params "
                                    "beyond 5e-6")
        say("stepparity", f"{family} b{b} T{t} {isize}^2 {extra}: CUDA vs "
                          f"CPU (TF32 off) loss {abs(l_gpu - l_cpu):.3g}, "
                          f"params max {worst_param:.3g} (<= 2.5 lr), "
                          f"{loose}/{total} beyond 5e-6, BN stats "
                          f"{worst_stat:.3g}")


def phase_supervised_train(tmp: Path, family: str) -> dict:
    """``cli.trainer.main --model family`` at the reference width, b8, T16,
    128^2, float32, with a one-batch test sweep; returns the engine, the
    kernels' launch counts on the run and those of its sweep."""
    from vfd_gan_tpu_torch.models import build_mask_model
    from vfd_gan_tpu_torch.train.supervised_engine import SupervisedEngine
    from vfd_gan_tpu_torch.utils.checkpoint import load_state_dict

    steps, extra = SUPERVISED_RUNS[family]
    root = tmp / f"runs_{family}"
    argv = ["--model", family, "--batchsize", str(BATCH), "--nfr", str(NFR),
            "--isize", str(ISIZE), "--compute_dtype", "float32",
            "--synthetic_data", str(steps), "--synthetic_test_batches", "1",
            "--ep", "1", "--freq", str(steps), "--device", "cuda",
            "--result_root", str(root), *extra]
    torch.cuda.reset_peak_memory_stats()
    engine, counts, sweep, wall = run_trainer(argv, SupervisedEngine)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    check(engine.global_step == steps, f"{family}: all train steps ran")
    losses = {k: engine.errors[k] for k in ("loss/err/train",
                                            "loss/err/test")}
    check(all(np.isfinite(v) for v in losses.values()),
          f"{family}: finite losses {losses}")
    roc, pr, f1 = (engine.scores[f"score/{k}"] for k in ("roc", "pr", "f1"))
    check(all(np.isfinite(v) for v in (roc, pr, f1)),
          f"{family}: sweep scores")
    pth = sorted(root.rglob("*.pth"))
    check(len(pth) == 1 and pth[0].name.startswith("roc-"),
          f"{family}: one best .pth: {pth}")
    build_mask_model(family, engine.cfg).load_state_dict(
        load_state_dict(str(pth[0])), strict=True)
    check(counts["augment_gather"] == steps,
          f"{family}: every step launched the augment kernel: {counts}")
    check(counts["morphology_open"] > 0,
          f"{family}: the sweep launched the opening kernel")
    if family == "clstm":
        # per forward 3 input halves + 3 x T hidden halves; the backward
        # launches dx for each but the first layer's input half and each
        # layer's first hidden half (their inputs need no gradient)
        fwd = 3 * (1 + NFR)
        check(counts["conv3x3"] - sweep["conv3x3"] == steps * (2 * fwd - 4)
              and sweep["conv3x3"] == fwd * engine.test_iter.n_batches,
              f"clstm launched the conv kernel {counts['conv3x3']} times, "
              f"{sweep['conv3x3']} of them in the sweep; expected "
              f"{2 * fwd - 4} per step (forward and dx) and {fwd} per sweep "
              "batch")
        check(2 * fwd - 4 == CONV_LAUNCHES_PER_STEP,
              "the conv phase's cases are one step's launches")
    steady = engine.step_seconds[2:] if steps > 4 else engine.step_seconds[1:]
    say(f"train-{family}",
        f"trainer.main --model {family} b{BATCH} T{NFR} {ISIZE}^2 float32 "
        f"{' '.join(extra)}: {steps} steps + sweep in {wall:.1f} s; step "
        f"median {1e3 * statistics.median(steady):.1f} ms (min "
        f"{1e3 * min(steady):.1f}, max {1e3 * max(steady):.1f}, after "
        f"{steps - len(steady)} warm-up); first step "
        f"{1e3 * engine.step_seconds[0]:.0f} ms; peak memory {peak:.0f} "
        f"MiB; losses {json.dumps(losses)}")
    say(f"train-{family}", f"sweep: roc {roc:.6g} pr {pr:.6g} f1 {f1:.6g}; "
                           f"saved {pth[0].name} (loaded strict); launches "
                           f"{json.dumps(counts)}, of them in the sweep "
                           f"{json.dumps(sweep)}")
    return engine, counts, sweep


def phase_train(tmp: Path):
    """The training main path at the reference width; returns the engine,
    the kernels' launch counts on it and those of its sweep."""
    from vfd_gan_tpu_torch.models.mygan import DualDisc, Generator
    from vfd_gan_tpu_torch.train.gan_engine import MyGanEngine
    from vfd_gan_tpu_torch.utils.checkpoint import load_state_dict

    argv = ["--model", "mygan", "--batchsize", str(BATCH), "--nfr", str(NFR),
            "--isize", str(ISIZE), "--ngf", "32", "--ndf", "32",
            "--flow_scale", "0.5", "--compute_dtype", "float32",
            "--synthetic_data", str(TRAIN_STEPS),
            "--synthetic_test_batches", "2", "--ep", "1",
            "--freq", str(TRAIN_STEPS), "--device", "cuda",
            "--result_root", str(tmp / "runs")]
    torch.cuda.reset_peak_memory_stats()
    engine, counts, sweep, wall = run_trainer(argv, MyGanEngine)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    check(engine.global_step == TRAIN_STEPS, "all train steps ran")
    losses = {k: v for k, v in engine.errors.items() if "/" in k}
    check(len(losses) > 20 and all(np.isfinite(v) for v in losses.values()),
          f"finite losses: {losses}")
    roc, pr, f1 = (engine.scores[f"score/{k}"] for k in ("roc", "pr", "f1"))
    check(all(np.isfinite(v) for v in (roc, pr, f1)), "sweep scores")
    g_pth = sorted((tmp / "runs").rglob("*_netG.pth"))
    d_pth = sorted((tmp / "runs").rglob("*_netD.pth"))
    check(len(g_pth) == len(d_pth) == 1, f"one best pair: {g_pth} {d_pth}")
    Generator(32).load_state_dict(load_state_dict(str(g_pth[0])),
                                  strict=True)
    DualDisc(32, NFR, ISIZE).load_state_dict(load_state_dict(str(d_pth[0])),
                                             strict=True)
    check(counts["flow_fused"] > 0, "training launched the fused kernel")
    check(counts["augment_gather"] > 0,
          "training launched the augment kernel")
    check(counts["morphology_open"] > 0,
          "the test sweep launched the opening kernel")
    steady = engine.step_seconds[4:]
    say("train", f"trainer.main b{BATCH} T{NFR} {ISIZE}^2 ngf=ndf=32 "
                 f"flow_scale 0.5 float32: {TRAIN_STEPS} steps + sweep in "
                 f"{wall:.1f} s; step median {1e3 * statistics.median(steady):.1f}"
                 f" ms (min {1e3 * min(steady):.1f}, max "
                 f"{1e3 * max(steady):.1f}, steps 5-{TRAIN_STEPS}); first "
                 f"step {1e3 * engine.step_seconds[0]:.0f} ms; peak memory "
                 f"{peak:.0f} MiB")
    say("train", "losses at the last step: " + ", ".join(
        f"{k} {v:.5g}" for k, v in sorted(losses.items())
        if k.endswith("/train")))
    say("train", f"sweep: roc {roc:.6g} pr {pr:.6g} f1 {f1:.6g}; saved "
                 f"{g_pth[0].name}, {d_pth[0].name} (loaded strict); "
                 f"launches {json.dumps(counts)}, of them in the sweep "
                 f"{json.dumps(sweep)}")
    return engine, counts, sweep


def phase_two_kernel(engine) -> dict:
    """One train step of the trained engine with the two-kernel flow."""
    batch = next(iter(engine.train_iter))
    engine.flow_impl = "two_kernel"
    _reset_counts()                      # the two-kernel path starts
    t0 = time.perf_counter()
    metrics = engine._train_step_impl(batch)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    counts = _counts()                   # ... and ends
    check(all(np.isfinite(float(v)) for v in metrics.values()),
          "two-kernel step losses finite")
    check(counts["flow_warp"] > 0 and counts["flow_refine"] > 0,
          f"the two-kernel step launched warp and refine: {counts}")
    check(counts["flow_fused"] == 0, "and not the fused kernel")
    say("twokernel", f"one train step with flow_impl=two_kernel in {ms:.1f}"
                     f" ms: launches {json.dumps(counts)}")
    return counts


def main() -> None:
    name = phase_device()
    import_port()
    from vfd_gan_tpu_torch.ops.morphology import open_planes_cuda
    from vfd_gan_tpu_torch.utils.runtime import resolve_device

    device = torch.device("cuda")
    resolve_device("cuda")               # TF32 off, as the entry points do
    phase_build()
    results = {"morphology_open": phase_kernel(device)}
    results.update(phase_flow_kernels(device))
    results["augment_gather"] = phase_augment_kernel(device)
    results["conv3x3"] = phase_conv_kernel(device)
    phase_flow_video(device)
    with tempfile.TemporaryDirectory() as tmp:
        path = make_checkpoint(Path(tmp))
        model = phase_generator(path, device)
        open_planes_cuda.launches = 0            # the serving path starts
        phase_serve(path, model)
        phase_infer(model)
        serve_launches = open_planes_cuda.launches
        check(serve_launches > 0, "serve + infer launched the opening kernel")
        say("serve", f"serve + infer path: morphology_open launches "
                     f"{serve_launches}")
        del model
        phase_step_parity(Path(tmp))
        phase_supervised_parity(Path(tmp))
        engine, gan_counts, gan_sweep = phase_train(Path(tmp))
        gan_steps = engine.global_step
        gan_sweep_batches = engine.test_iter.n_batches
        two_counts = phase_two_kernel(engine)
        del engine
        for family in SUPERVISED_RUNS:
            engine, counts, sweep = phase_supervised_train(Path(tmp), family)
            if family == "clstm":
                clstm_counts, clstm_sweep = counts, sweep
                clstm_steps = engine.global_step
            del engine
    # launches: each kernel's count on the main path that runs it (MyGAN's
    # trainer for the fused and opening kernels, its --flow_impl
    # two_kernel step for warp and refine, the clstm trainer for the
    # augment and conv kernels); per step: the launches made outside the
    # test sweep over the train steps the engine counted (the opening: the
    # sweep's launches per sweep batch)
    launches = {"morphology_open": gan_counts, "flow_fused": gan_counts,
                "flow_warp": two_counts, "flow_refine": two_counts,
                "augment_gather": clstm_counts, "conv3x3": clstm_counts}
    per_step = {
        "morphology_open": gan_sweep["morphology_open"] / gan_sweep_batches,
        "flow_fused": (gan_counts["flow_fused"] - gan_sweep["flow_fused"])
        / gan_steps,
        "flow_warp": float(two_counts["flow_warp"]),
        "flow_refine": float(two_counts["flow_refine"]),
        "augment_gather": (clstm_counts["augment_gather"]
                           - clstm_sweep["augment_gather"]) / clstm_steps,
        "conv3x3": (clstm_counts["conv3x3"] - clstm_sweep["conv3x3"])
        / clstm_steps}
    check(gan_counts["morphology_open"] == gan_sweep["morphology_open"],
          "only the sweep runs the opening kernel")
    # the solver kernels by plane size: launches per step from the same
    # counters, and times x launches over one step of the kernel's path
    for k, counts, sweep, steps in (
            ("flow_fused", gan_counts, gan_sweep, gan_steps),
            ("flow_refine", two_counts, {}, 1)):
        for case in results[k]["shapes"]:
            plane = f"{k}@{case['size']}x{case['size']}"
            case["launches_per_step"] = (
                counts.get(plane, 0) - sweep.get(plane, 0)) / steps
        for key in ("ms", "bound_ms"):
            results[k][f"step_{key}_sum"] = sum(
                case["launches_per_step"] * case[key]
                for case in results[k]["shapes"])
        check(sum(c["launches_per_step"] for c in results[k]["shapes"])
              == per_step[k], f"{k}: every launch of a step is at a timed "
                              f"size: {counts}")
        say("flow", f"{k} times x launches over one step ({per_step[k]:g} "
                    f"launches): kernel {results[k]['step_ms_sum']:.4f} ms, "
                    f"bound {results[k]['step_bound_ms_sum']:.4f} ms")
    print(json.dumps({"kernels": [{
        "name": k, "route": "cuda", "source": KERNELS[k][0],
        "replaces": KERNELS[k][1], "launches": launches[k][k],
        "launches_per_step": per_step[k], **results[k]}
        for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
