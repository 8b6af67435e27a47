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
3. kernel vs plain: the opening kernel, which reads a tensor where it
   lies, against its plain PyTorch version: the serve batch's video in
   both planes of ``video_open``, a channel-3 and a ragged video, ragged
   planes, a 512 x 512 plane (tiled in both window axes) and a permuted
   view, k = 3 and 5, binary and float masks: bit-equal and contiguous;
   then both planes of the video timed with CUDA events (20 repetitions of
   10 back-to-back calls);
4. flow kernels vs plain: the warp, refine and fused kernels at the train
   step's shapes (240 fields at 64^2, 32^2 and 16^2, and 128^2 for
   flow_scale 1.0) on polynomial planes of smooth frames with a planted
   (1, 2) px shift, against their plain versions (warp <= 1e-5 x max|field|,
   refine and fused q99 <= 1e-3 px), the fused flow recovering the shift;
   then timed as in phase 3;
5. video_to_flow_rgb: the three ``impl``s on one (16, 16, 128, 128, 3)
   mask batch with streams=2, held against each other;
6. checkpoints and generator: a full-width model of each served family
   (MyGAN ``Generator(ngf=32)``, ConvLSTM, the "c2plus1d" AutoEncoder,
   Xception-3D) with random weights from a seed, written as
   reference-format ``.pth`` files and loaded back by the entry points'
   loader from the file names; the Generator's CUDA forward on a (1, 16,
   128, 128, 3) clip against the CPU (max-abs <= 1e-4, TF32 off), and its
   b8 forward time;
7. serving: ``cli.serve.serve`` on port 0 at ``--max_batch 8 --nfr 16
   --isize 128 --device cuda``, answering HTTP requests for the MyGAN
   checkpoint (1 clip; 3 clips with ``?mask=1``; a 2-clip
   ``/predict_stream``; 8 concurrent clips; rounds of 8-clip requests for
   the b8 batch latency), then for each supervised family's checkpoint (1
   clip against a direct forward, <= 1e-5; a masked request; four full
   batches); the ConvLSTM's forward must go through the conv3x3 kernel;
8. infer: ``cli.infer.predict_clips`` on eight uint8 clips for each of the
   four families, the card against the CPU from the same checkpoint
   (prediction <= 1e-4; the opened mask equal wherever no prediction
   within the opening's reach is within 1e-4 of 0.5), each through one
   launch of the opening kernel, equal to the plain opening; and each
   family's b8 forward time;
9. train step CUDA vs CPU: one ``MyGanEngine._gan_core`` step at a small
   size from the same weights and the same injected flows, TF32 off:
   losses, updated G and D parameters and D BatchNorm statistics;
10. training: ``cli.trainer.main`` at the reference width (b8, T16, 128^2,
    ngf = ndf = 32, flow_scale 0.5, float32, synthetic data) for 10
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

13. AnoGAN and GANomaly (the last two families): a CUDA-vs-CPU step of
    each (``_ano_core`` with z and dropout masks from the CPU,
    ``_ganomaly_core``), then ``cli.trainer.main --model anogan|ganomaly``
    at b8, T16, 128^2 (their widths are fixed) for 6 steps and a 2-batch
    sweep: finite losses and scores, the best ``*_netG.pth``/``*_netD.pth``
    pair loaded back with strict=True, one augment launch per step, one
    opening launch per AnoGAN sweep batch (none in GANomaly's frame-level
    sweep), step median, clips/s and peak memory;
14. device scoring: one full-width two-batch sweep of each family with
    and without ``--device_scoring``, from the same seed: roc/pr/f1
    within 1e-5 and the same best checkpoint, and the time of
    ``score_and_checkpoint`` on each path (GANomaly's frame-level ROC
    stays on the host, as in the JAX engine);
15. host data: clips in memory (a stand-in for the mp4 dataset, which
    needs cv2: staged at 140^2 for train, 128^2 for test) through the
    port's ``ClipBatchIterator`` and ``device_prefetch`` (pinned buffers, a
    side stream) into ``MyGanEngine`` and ``SupervisedEngine(clstm)`` for a
    few steps and a sweep: the prefetched batches equal the iterator's bit
    for bit, the kernels launch as with synthetic data; step median, the
    wait for a batch and the host-to-device copy's time;
16. resume: for mygan and clstm a run with ``--autosave_every`` that is
    sent a SIGTERM after step k parks ``latest.pt`` and returns; a new
    engine with ``--resume`` holds the saved state bit for bit at the cursor
    ``(epoch, k)`` and runs on to N; whether two unbroken runs are
    bit-equal: if so the resumed run's losses must equal theirs, else lie
    within 1e-5 + 1% of them; the file's size and the cost of a synchronous and an
    asynchronous autosave as the step loop sees them;
17. sweep options: ``--cache_gt_flow`` (the second sweep solves half the
    flow fields of the first, scores equal to an uncached engine's),
    ``--ref_mode_quirks`` (G's and D's BatchNorm running statistics move
    over a sweep) and one ``--ae`` step CUDA vs CPU;
18. tensorboard: one short trainer run with the logger on; says whether a
    writer existed, and then finds its event file.  The other trainer
    phases pass ``--no-tensorboard``.
19. accum: ``cli.trainer.main --accum k`` at the reference size, 4 steps
    and a one-batch sweep each: MyGAN float32 and bf16 at k 2 and 4 (b8),
    bf16 ``--batchsize 32 --accum 4``, clstm float32 k 2; one augment
    launch per step, 3 k fused-flow launches per MyGAN step, k x 98 conv
    launches per clstm step; step median and peak memory beside the
    accum-1 run's; then one b8 float32 ``--accum 2`` step against the same
    step by hand from one state (SGD(1.0): the updates within 4 x the
    spread of two hand-made steps, the buffers equal);
20. remat: MyGAN b8 float32 and bf16 with ``--remat`` and ``--remat
    --remat_blocks dconv1,uconv1`` (step median, peak memory beside the
    plain run's); one step of a remat engine against two plain ones from
    one state: G's gradient within their spread, every BatchNorm buffer
    (``num_batches_tracked`` too) as plain's;
21. evaluate: ``cli.export_torch`` of a 2-step MyGAN run's ``latest.pt``
    (the pair loads strict=True), then ``cli.evaluate_models`` on that G
    and the seed-0 clstm, c2plus1d and xception files over clips held in
    memory (b4, T16, 128^2): AUC, EER, F1 and seconds per model, each
    within 1e-4 of the same call on the CPU, no opening launch;
22. host-only: with ``import cv2`` made to fail, ``--host_flow`` exits when
    the engine is built, naming cv2; where cv2 imports, a 2-step
    ``--host_flow`` MyGAN run (no flow kernel) and ``cli.frames`` on a
    synthetic mp4 tree.
23. moe: ``cli.trainer.main --model xception --xwidth 1.0 --moe_experts
    4`` (4 steps and a one-batch sweep, float32 and the default bf16;
    step median, clips/s, peak memory, the MoE layer's token count and
    dispatch bytes, the augment and opening launches); then one step on
    the card against the CPU at b2, T8, 32^2, xwidth 1/16, with the
    tokens routed to another expert counted (the card's step run again
    with the CPU's routing where any are), held by loss, parameters, BN
    statistics and the gradient against the CPU's float64 step;
24. int8-serve: the four families calibrated on 8 synthetic clips and
    served int8 (``build_int8_serving``; ``predict_clips`` on 8 uint8
    clips, one opening launch each; one HTTP request through ``serve
    --quant int8``; ``infer.main --quant int8`` on a 2-clip mp4 where cv2
    imports), as one main path; then every ``int8_matmul`` shape of each
    b8 forward bit-equal to its plain version, each int8 input against
    the CPU's on a 64^2 clip (flips by one step only), the int8 mask
    against the BN-folded float forward, and the b8 int8 forward's time
    and peak beside the float32 and bf16 forwards';
25. int8-disc: MyGAN ``--int8_disc``, 4 steps and a sweep in float32 and
    bf16 (step median, peak, int8 GEMM launches), and G after them
    against two plain float32 runs (within 4 x their spread).
26. dp: ``cli.trainer.main --dp 0`` at the reference width on the
    default command line (bf16) resolves to the one card and says so;
    then ``tools/dp_equivalence.py`` ranks: one NCCL rank runs 3 float32
    MyGAN steps on the dp code path (synced BatchNorms, the synced flow
    stretch, the sliced draws, the gradient and metric all-reduces), two
    gloo ranks on this one card run MyGAN and clstm at b8 (4 per rank),
    and this process runs the same steps twice on the plain path.  The
    dp path at dp 1 (MyGAN and clstm, twice each) lies within
    ``parallel/verify.py``'s K = 10 x the spread of the two plain runs
    (+1e-5), and dp 2 within 10 x the spread of the two dp-1 runs, by
    parameters and running statistics (not 4 x: the dp path's kernels
    round otherwise, 3.5-6.1 x the atomics' spread on MyGAN; ``_dp_close``);
    both gloo ranks hold the same parameters bit for bit, and each rank
    launched the augment kernel once per step, the fused flow kernel 3
    times per MyGAN step and the conv kernel as at dp 1 per clstm step;
    step medians beside the plain runs', and the NCCL rank's all-reduce
    milliseconds per step by caller;
27. native: the host runtime on mp4 files written to disk (b8, T16,
    staged 140^2 from 160^2): decode + pack ms per batch and the train
    loop's wait per batch with a consumer holding each batch 150 ms,
    with the library and with the Python forms, in turns.

bfloat16, the JAX package's and the trainer's default compute dtype, runs
beside float32: the conv kernel's bf16 form at the nine launches of a
clstm step against its plain version (at least 99% of the elements equal,
every one within one bf16 ulp beyond the float32 sums' own spread), timed
with its plain version and ``F.conv2d`` in bf16; after the serving phases,
``--dtype bfloat16`` serving of the four families (``predict_clips`` on
the card against the CPU's bf16, the b8 forward beside float32's, HTTP
requests); after the float32 step parities, the same CUDA-vs-CPU steps in
bf16 (MyGAN, ``--ae`` and the supervised families; losses 1e-2 relative,
parameters 2.5 lr, as the CPU tests hold the port to JAX); after the
float32 training phases, the default command line (no ``--compute_dtype``)
for MyGAN (10 steps and a one-batch sweep), ``--ae`` (3 steps), clstm,
c2plus1d, xception, anogan and ganomaly, each step median and peak memory
printed beside the float32 run's, clstm's launches all on the bf16 conv
kernel.

Before the serving phase come two more kernel phases: the augment gather
kernel against its plain version (bit-equal on all three outputs at the
train shape, a ragged clip, a 45 degree draw, coordinates all outside the
source and channel counts other than 3 + 3 + 1) and the 3x3 conv kernel
against ``F.conv2d`` and its autograd (TF32 off; forward 1e-5, dx and dw
1e-4) at the nine distinct launches of one ConvLSTM step (forward F1-F5,
dx D1-D4), a ragged and a wide case, each timed in turns with ``F.conv2d``
(library, kernel, kernel, library); and after the MyGAN step parity, a
CUDA-vs-CPU supervised step for each family at a small size.

Each main path (serve + infer of the four families; MyGAN training; the
two-kernel step; each supervised, AnoGAN and GANomaly training run; each
``--accum``, ``--remat`` and ``--host_flow`` run and each model's
``evaluate_models`` call; each ``--moe_experts`` and ``--int8_disc`` run
and the int8 serve + infer path) starts with the launch counts of the
kernels set to 0 and reads them after; the same counters hold the int8
GEMM's calls (``int8_matmul``: cuBLASLt, no kernel of the port), printed
on the phases' lines and not on the kernels line.  ``--slice-only``
runs the build and phases 26-27 alone and prints no result line.  Then come one JSON line of kernel results
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
counters; the conv kernel also one entry per shape, the opening kernel
one per plane of the serve batch's video, and the three flow kernels one
per plane size (``shapes``), the refine and fused kernels' with
the launches per step at that size and, as the conv kernel, their times x
launches summed over one step of their path (``step_ms_sum``,
``step_bound_ms_sum``); each kernel also its nonzero launches on the
other runs (``launches_on``: AnoGAN and GANomaly for the augment and
opening kernels; every ``--accum``, ``--remat``, ``--host_flow``,
evaluate, ``--moe_experts``, int8 serve and ``--int8_disc`` run, and
each rank of the ``--dp`` runs).  Any failure raises: the script exits non-zero and
prints no last line.  It does the same without a card, and outside a
checkout of the repo.
"""

from __future__ import annotations

import base64
import collections
import contextlib
import copy
import gc
import io
import json
import math
import signal
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
    # the same TPU kernel on bfloat16 operands (compute_dtype bfloat16)
    "conv3x3_bf16": ("vfd_gan_tpu_torch/ops/cuda/conv3x3.cu",
                     "vfd_gan_tpu/ops/pallas/spatial_conv.py:42"),
}
# the train step's flow fields: 2 streams x B x (T - 1)
FIELDS = 2 * BATCH * (NFR - 1)
# flow levels at flow_scale 0.5 (64, 32, 16) and the top one at 1.0 (128)
FLOW_SIZES = (64, 32, 16, 128)
TRAIN_STEPS = 10
# the supervised families' training phases: model -> (steps, extra flags)
SUPERVISED_RUNS = {"clstm": (8, []), "c2plus1d": (4, []),
                   "xception": (4, ["--xwidth", "1.0"])}
# the --ae run in bfloat16: steps
AE_STEPS = 3
# the AnoGAN and GANomaly training runs: steps per dtype, sweep batches
FAMILIES = ("anogan", "ganomaly")
FAMILY_STEPS, FAMILY_SWEEP = 6, 2


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
PEAK_BF16_FLOP_PER_S = 989e12


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


# The opening kernel's cases: label -> (tensor shape, window axes).  The
# serve batch's video in both planes of ``video_open``, a channel-3 and a
# ragged video, and contiguous planes: a ragged one and one of 512 x 512
# (tiled in both window axes).
OPEN_CASES = {
    "th": ((BATCH, NFR, ISIZE, ISIZE, 1), (1, 2)),
    "hw": ((BATCH, NFR, ISIZE, ISIZE, 1), (2, 3)),
    "th_c3": ((2, NFR, 32, 24, 3), (1, 2)),
    "hw_c3": ((2, NFR, 32, 24, 3), (2, 3)),
    "ragged_th": ((1, 13, 37, 3, 1), (1, 2)),
    "ragged_planes": ((3, 13, 37), (1, 2)),
    "tiled512": ((2, 512, 512), (1, 2)),
}


def _open_plain(x: torch.Tensor, axes, k: int) -> torch.Tensor:
    """The plain opening over ``axes`` of ``x``: the plane moved to the
    trailing axes (a copy), ``open_planes_plain``, and moved back."""
    from vfd_gan_tpu_torch.ops.morphology import open_planes_plain

    moved = x.movedim(axes, (-2, -1)).contiguous()
    out = open_planes_plain(moved.reshape(-1, *moved.shape[-2:]), k)
    return out.reshape(moved.shape).movedim((-2, -1), axes)


def phase_kernel(device) -> dict:
    """The opening kernel, reading each tensor where it lies, against the
    plain version: bit-equal and contiguous in every case; then the serve
    batch's video timed in both planes against the plain version on ready
    contiguous planes (the copy that makes them is not in its time)."""
    from vfd_gan_tpu_torch.ops.morphology import (
        open_planes_cuda,
        open_planes_plain,
    )

    g = torch.Generator(device=device).manual_seed(0)
    worst = 0.0
    for label, (shape, axes) in OPEN_CASES.items():
        for k in (3, 5):
            for binary in (True, False):
                x = torch.rand(shape, generator=g, device=device)
                if binary:
                    x = (x > 0.5).float()
                got = open_planes_cuda(x, k, axes)
                want = _open_plain(x, axes, k)
                torch.cuda.synchronize()
                worst = max(worst, (got - want).abs().max().item())
                check(got.is_contiguous() and torch.equal(got, want),
                      f"kernel == plain at {label} {shape} k={k} "
                      f"binary={binary}")
    # a model's NCDHW mask seen channel-last: read by its strides
    view = torch.rand((BATCH, 1, NFR, 64, 48), generator=g,
                      device=device).permute(0, 2, 3, 4, 1)
    got = open_planes_cuda(view, 5, (1, 2))
    check(got.is_contiguous() and torch.equal(got, _open_plain(view, (1, 2),
                                                               5)),
          "kernel == plain on a permuted view")
    say("kernel", f"bit-equal to the plain version and contiguous in all "
                  f"{len(OPEN_CASES) * 4 + 1} cases (max_abs_err {worst})")

    shapes = []
    for label in ("th", "hw"):
        shape, axes = OPEN_CASES[label]
        x = (torch.rand(shape, generator=g, device=device) > 0.5).float()
        moved = x.movedim(axes, (-2, -1)).contiguous()
        planes = moved.reshape(-1, *moved.shape[-2:])
        kernel = lambda: open_planes_cuda(x, 5, axes)  # noqa: E731
        plain = lambda: open_planes_plain(planes, 5)  # noqa: E731
        # ~0.2 s of work first: an idle card runs at a low clock
        for _ in range(1000):
            kernel()
            plain()
        k_ms, p_ms, order = _time_pair(kernel, plain)
        # the video in and out once; per element 2 x 2 x (k - 1)
        # comparisons (erosion and dilation, each separable)
        limit = bound(8 * x.numel(), 4 * (5 - 1) * x.numel())
        say("kernel", f"{label} plane of a {shape} video, k=5, in place: "
                      f"kernel {k_ms:.4f} ms, plain on ready "
                      f"{tuple(planes.shape)} planes {p_ms:.4f} ms, bound "
                      f"{limit['bound_ms']:.4f} ms by {limit['bound_by']} "
                      f"(medians of 20x10, L2-warm, run as "
                      f"plain/kernel/kernel/plain: {order})")
        shapes.append({"plane": label, "shape": list(shape),
                       "max_abs_err": worst, "ms": k_ms, "plain_ms": p_ms,
                       "library_ms": None, **limit})
    keys = ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by")
    return {**{key: shapes[0][key] for key in keys}, "shape": "th",
            "shapes": shapes}


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
    all three outputs: the train shape, a ragged clip (no 16-byte aligned
    rows, T off the kernel's frame groups), a 45 degree draw that zero-fills
    heavily, coordinates that all lie outside the source, and channel counts
    other than 3 + 3 + 1 (the kernel's runtime-count form); then timed at
    the train shape."""
    from vfd_gan_tpu_torch.ops import augment

    stage = augment.staging_size(ISIZE)
    # label -> (B, T, S, isize, angle or None for the draw, shift, channels)
    cases = {"train": (BATCH, NFR, stage, ISIZE, None, 0.0, (3, 3, 1)),
             "ragged": (3, 5, 37, 33, None, 0.0, (3, 3, 1)),
             "rot45": (BATCH, NFR, stage, ISIZE, math.pi / 4, 0.0, (3, 3, 1)),
             "outside": (2, 6, 37, 32, None, 1000.0, (3, 3, 1)),
             "c1+2+1": (2, 5, 37, 33, None, 0.0, (1, 2, 1)),
             "c4+3+4": (2, 5, 40, 36, 0.5, 0.0, (4, 3, 4))}
    timed = None
    for label, (b, t, s, isize, angle, shift, channels) in cases.items():
        g = torch.Generator(device=device).manual_seed(b + s)
        streams = [torch.randint(0, 256, (b, t, s, s, c), generator=g,
                                 device=device, dtype=torch.uint8)
                   for c in channels]
        streams[2] = (streams[2] > 127).to(torch.uint8) * 255
        params = augment.sample_clip_params(g, b, s, isize)
        if angle is not None:
            params = (torch.full_like(params[0], angle),) + params[1:]
        src_x, src_y = (c.contiguous() for c in augment._src_coords(
            *params, s, isize))
        src_x = src_x + shift
        got = augment.augment_gather_cuda(*streams, src_x, src_y)
        want = augment.augment_gather_plain(*streams, src_x, src_y)
        torch.cuda.synchronize()
        for name, a, w in zip(("data", "real", "mask"), got, want):
            check(a.shape == w.shape and torch.equal(a, w),
                  f"augment kernel == plain at {label} ({name})")
        outside = (src_x < 0) | (src_x >= s) | (src_y < 0) | (src_y >= s)
        say("augment", f"{label} b{b} T{t} {s}^2 -> {isize}^2, C "
                       f"{'+'.join(map(str, channels))}: bit-equal on data, "
                       f"real and mask; "
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


def phase_conv_kernel_bf16(device) -> dict:
    """The bfloat16 form of the conv kernel at the nine launches of a clstm
    step (``CONV_CASES`` F1-D4): the case's launch (with ``flip`` for a dx
    case) against its plain version on the same bfloat16 tensors (float32
    sums of the widened operands, rounded once): at least 99% of the
    elements equal and every one within one bfloat16 ulp of the plain
    result beyond the float32 sums' own spread (``conv_sum_slack``; a sum
    that cancels to near 0 is off by many ulps of itself, in any two
    orders).  Then timed in
    turns with the plain version and with ``F.conv2d`` in bfloat16 (cuDNN,
    the library call) on the same tensors.  Bound: the bytes at two per
    value over 3.35 TB/s against 2 N H W 9 Cin Cout over 989 TFLOP/s
    (dense bf16).  Returns the kernels-line entry, one entry per case under
    ``shapes``."""
    import torch.nn.functional as F

    from vfd_gan_tpu_torch.ops import spatial_conv

    shapes = []
    for label, (n, h, w, cin, cout, flip, per_step, what) in \
            CONV_CASES.items():
        if not per_step:
            continue
        g = torch.Generator(device=device).manual_seed(cin)
        x = torch.randn((n, h, w, cin), generator=g,
                        device=device).bfloat16()
        given = (torch.randn((3, 3, cout, cin) if flip else (3, 3, cin, cout),
                             generator=g, device=device) * 0.1).bfloat16()
        # the weights the launch convolves by, (3, 3, Cin, Cout)
        k = given.flip(0, 1).transpose(2, 3).contiguous() if flip else given
        kernel = lambda: spatial_conv.conv3x3_cuda(  # noqa: E731
            x, given, flip=flip)
        plain = lambda: spatial_conv.conv3x3_plain(x, k)  # noqa: E731
        xc, kc = x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1)
        library = lambda: F.conv2d(xc, kc, padding=1)  # noqa: E731
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        check(got.dtype == torch.bfloat16, f"conv3x3 bf16 {label} dtype")
        ulps = spatial_conv.bf16_ulps(got, want,
                                        spatial_conv.conv_sum_slack(x, k))
        raw = spatial_conv.bf16_ulps(got, want)
        beyond = (raw > 1).float().mean().item()
        raw_max = raw.max().item()
        equal = (got == want).float().mean().item()
        check(equal >= 0.99 and ulps.max().item() <= 1.0,
              f"conv3x3 bf16 {label}: {equal:.6f} equal, "
              f"{ulps.max().item()} ulps beyond the sums' spread")
        err = (got.float() - want.float()).abs().max().item()
        lib_err = (library().permute(0, 2, 3, 1).float()
                   - want.float()).abs().max().item()
        del got, want, ulps, raw
        k_ms, p_ms, _ = _time_pair(kernel, plain)
        _, l_ms, order = _time_pair(kernel, library)
        px = n * h * w
        limit = bound(2 * (px * (cin + cout) + 9 * cin * cout),
                      2 * px * 9 * cin * cout, PEAK_BF16_FLOP_PER_S)
        say("conv3x3-bf16",
            f"{label} ({what}) N{n} {h}x{w} {cin}->{cout}"
            f"{' flip' if flip else ''}: {100 * equal:.4f}% equal to the "
            f"plain version, the rest within one bf16 ulp beyond the float32 "
            f"sums' spread ({100 * beyond:.4f}% more than one ulp apart, "
            f"{raw_max:.0f} at most, where the products cancel), max-abs "
            f"{err:.3g} (F.conv2d bf16 {lib_err:.3g}); kernel {k_ms:.4f} "
            f"ms, plain {p_ms:.4f} ms, F.conv2d bf16 {l_ms:.4f} ms "
            f"(library/kernel/kernel/library {order}); bound "
            f"{limit['bound_ms']:.4f} ms by {limit['bound_by']}; "
            f"x{per_step} per step")
        shapes.append({"id": label, "what": what, "n": n, "h": h, "w": w,
                       "cin": cin, "cout": cout, "flip": flip,
                       "launches_per_step": per_step, "max_abs_err": err,
                       "equal_share": equal, "ms": k_ms, "plain_ms": p_ms,
                       "library_ms": l_ms, **limit})
        del x, given, k, xc, kc
    step = {key: sum(c["launches_per_step"] * c[key] for c in shapes)
            for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    say("conv3x3-bf16", f"times x launches over one bf16 clstm step "
                        f"({CONV_LAUNCHES_PER_STEP} launches): kernel "
                        f"{step['ms']:.3f} ms, plain {step['plain_ms']:.3f} "
                        f"ms, F.conv2d bf16 {step['library_ms']:.3f} ms, "
                        f"bound {step['bound_ms']:.3f} ms")
    main_case = next(c for c in shapes if c["id"] == CONV_MAIN_CASE)
    keys = ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by")
    return {**{key: main_case[key] for key in keys},
            "shape": CONV_MAIN_CASE, "shapes": shapes,
            **{f"step_{key}_sum": v for key, v in step.items()}}


# The served families: name -> the substring of a checkpoint's file name
# that ``cli.infer._load`` dispatches on.
SERVED = {"mygan": "netG", "clstm": "clstm", "c2plus1d": "c2plus1d",
          "xception": "xception"}


def make_checkpoints(tmp: Path) -> dict:
    """A full-width model of every served family with random weights from
    seed 0, saved as reference-format .pth files; family -> path.  Each head
    is drawn wider than the reference init and zero-mean over each input
    channel's taps, so that the mask follows local structure, crosses the
    0.5 threshold and gives the opening work to do (a Generator at init
    sits just above 0.5 everywhere).  The supervised families' heads are
    then scaled (Xception's, which has a bias, also shifted) so that the
    logits of a small probe clip have unit spread."""
    from vfd_gan_tpu_torch.models.convlstm import ConvLSTMModel
    from vfd_gan_tpu_torch.models.mygan import Generator
    from vfd_gan_tpu_torch.models.stcnn import AutoEncoder
    from vfd_gan_tpu_torch.models.xception3d import Xception3D

    build = {"mygan": lambda g: Generator(ngf=32, generator=g),
             "clstm": lambda g: ConvLSTMModel(generator=g),
             "c2plus1d": lambda g: AutoEncoder(generator=g),
             "xception": lambda g: Xception3D(3, 1.0, generator=g)}
    paths = {}
    for family, substring in SERVED.items():
        seed = torch.Generator().manual_seed(0)
        model = build[family](seed).eval()
        with torch.no_grad():
            weight = model.conv_last.weight
            head = 0.5 * torch.randn(weight.shape, generator=seed)
            weight.copy_(head - head.mean(dim=(2, 3, 4), keepdim=True))
            if family != "mygan":
                probe = torch.rand((1, 3, NFR, 32, 32), generator=seed) * 2 - 1
                p = model(probe).clamp(1e-6, 1 - 1e-6)
                logit = torch.log(p / (1 - p))
                weight.div_(logit.std())
                if model.conv_last.bias is not None:
                    model.conv_last.bias.copy_(
                        (model.conv_last.bias - logit.mean()) / logit.std())
        paths[family] = tmp / f"smoke_{substring}.pth"
        torch.save({"epoch": 0, "state_dict": model.state_dict()},
                   paths[family])
    return paths


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


@contextlib.contextmanager
def _serving(path: Path, dtype: str = "float32", extra: tuple = ()):
    """``cli.serve.serve`` for ``path`` on port 0 at the serving shape,
    ``--dtype`` and ``extra`` flags, its HTTP loop on a thread; yields
    (server, base URL, httpd) and stops both."""
    from vfd_gan_tpu_torch.cli.serve import build_parser, serve

    args = build_parser().parse_args(
        ["--ckpt", str(path), "--port", "0", "--max_batch", str(BATCH),
         "--nfr", str(NFR), "--isize", str(ISIZE), "--dtype", dtype,
         "--device", "cuda", *extra])
    httpd = serve(args)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield (httpd.inference, f"http://127.0.0.1:{httpd.server_address[1]}",
               httpd)
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.inference.close()
    thread.join(timeout=10)
    check(not thread.is_alive(), "server thread stopped")


def _served_vs_direct(base: str, model: torch.nn.Module,
                      one: np.ndarray, tol: float = 1e-5) -> float:
    """One served clip's frame scores against a direct forward of the
    same weights (<= ``tol``)."""
    from vfd_gan_tpu_torch.ops.image import to_channel_first

    out = _post(base, "/predict", one)
    _scores_ok(out["frame_scores"], 1)
    with torch.inference_mode():
        direct = model(to_channel_first(torch.from_numpy(one)).cuda())
    want = direct[:, 0].flatten(2).mean(dim=2).cpu().numpy()
    err = float(np.abs(np.asarray(out["frame_scores"]) - want).max())
    check(err <= tol, f"served frame scores vs direct forward {err}")
    return err


def _b8_rounds(srv, base: str, clips, rounds: int) -> tuple[list, list]:
    """``rounds`` requests of a full batch: the server's batch times and
    the requests' wall times, in ms."""
    n_before = len(srv.latencies_ms)
    request_ms = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        out = _post(base, "/predict", clips(BATCH),
                    {"X-Clip-Count": str(BATCH)})
        request_ms.append((time.perf_counter() - t0) * 1000)
        _scores_ok(out["frame_scores"], BATCH)
    return sorted(srv.latencies_ms[n_before:]), request_ms


def phase_serve(path: Path, model: torch.nn.Module) -> None:
    rng = np.random.default_rng(2)
    clips = lambda k: rng.uniform(  # noqa: E731
        -1, 1, (k, NFR, ISIZE, ISIZE, 3)).astype(np.float32)
    with _serving(path) as (srv, base, httpd):
        err = _served_vs_direct(base, model, clips(1))

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

        b8, request_ms = _b8_rounds(srv, base, clips, 10)
        with urllib.request.urlopen(f"{base}/stats", timeout=60) as r:
            stats = json.loads(r.read())
        say("serve", f"4 request kinds answered; served vs direct frame "
                     f"scores max-abs {err:.3g}; /stats {json.dumps(stats)}")
        say("serve", f"b{BATCH} batches over 10 requests: median "
                     f"{statistics.median(b8):.2f} ms, max {b8[-1]:.2f} ms; "
                     f"HTTP request p50 {statistics.median(request_ms):.2f} ms"
                     f", max {max(request_ms):.2f} ms (25 MB body each)")


def phase_serve_family(family: str, path: Path,
                       model: torch.nn.Module) -> None:
    """A supervised family's checkpoint served over HTTP: one clip against
    a direct forward, a masked request, and a few full batches for the
    batch time."""
    rng = np.random.default_rng(6)
    clips = lambda k: rng.uniform(  # noqa: E731
        -1, 1, (k, NFR, ISIZE, ISIZE, 3)).astype(np.float32)
    before = _counts()
    with _serving(path) as (srv, base, _):
        err = _served_vs_direct(base, model, clips(1))
        out = _post(base, "/predict?mask=1", clips(2), {"X-Clip-Count": "2"})
        _scores_ok(out["frame_scores"], 2)
        check(out["mask_shape"] == [2, NFR, ISIZE, ISIZE], "mask shape")
        b8, request_ms = _b8_rounds(srv, base, clips, 4)
        name = srv.name
    conv = _counts()["conv3x3"] - before["conv3x3"]
    if family == "clstm":
        check(conv > 0, "serving clstm launched the conv3x3 kernel")
    say(f"serve-{family}", f"{name} from {path.name}: served vs direct frame "
                           f"scores max-abs {err:.3g}; b{BATCH} batches over "
                           f"4 requests: median {statistics.median(b8):.2f} "
                           f"ms, max {b8[-1]:.2f} ms; HTTP request p50 "
                           f"{statistics.median(request_ms):.2f} ms; conv3x3 "
                           f"launches {conv}")


def phase_infer(family: str, path: Path, model: torch.nn.Module) -> None:
    """``predict_clips`` on a full batch of uint8 clips, the card against
    the CPU from the same checkpoint: the prediction within 1e-4; the
    opened mask equal wherever no CPU prediction within the opening's reach
    (2r = 4 along T and H) is within 1e-4 of 0.5; one launch of the
    opening kernel (and the ConvLSTM's forward on the conv kernel); then
    the b8 forward timed."""
    from vfd_gan_tpu_torch.cli.infer import _load, predict_clips
    from vfd_gan_tpu_torch.ops.image import threshold
    from vfd_gan_tpu_torch.ops.morphology import video_open

    frames = np.random.default_rng(3).integers(
        0, 256, (BATCH, NFR, ISIZE, ISIZE, 3), dtype=np.uint8)
    cpu_model, name = _load(str(path), torch.device("cpu"))
    t0 = time.perf_counter()
    pred_cpu, opened_cpu, _ = predict_clips(cpu_model, frames, "th")
    cpu_s = time.perf_counter() - t0
    del cpu_model
    before = _counts()
    pred, opened, scores = predict_clips(model, frames, "th")
    torch.cuda.synchronize()
    counts = {k: n - before.get(k, 0) for k, n in _counts().items()}
    check(counts["morphology_open"] == 1,
          f"predict_clips launched the opening kernel once: {counts}")
    if family == "clstm":
        # 3 input halves + 3 x T hidden halves
        check(counts["conv3x3"] == 3 * (1 + NFR),
              f"the ConvLSTM's forward ran on the conv kernel: {counts}")
    check(pred.shape == opened.shape == (BATCH, NFR, ISIZE, ISIZE, 1)
          and opened.is_contiguous(), "infer shapes")
    check(tuple(scores.shape) == (BATCH, NFR), "infer frame scores shape")
    check(bool(torch.isfinite(pred).all()), "finite prediction")
    err = (pred.cpu() - pred_cpu).abs().max().item()
    check(err <= 1e-4, f"{family} predict_clips CUDA vs CPU max-abs {err}")
    # the kernel against the plain version on the card's own prediction
    # (a CPU tensor takes the plain version)
    check(torch.equal(opened.cpu(), video_open(threshold(pred).cpu(), "th")),
          "opened == plain opening of pred")
    close = ((pred_cpu - 0.5).abs() <= 1e-4).float()[..., 0]   # (B, T, H, W)
    reach = torch.nn.functional.max_pool2d(
        close.permute(0, 3, 1, 2), 9, 1, 4).permute(0, 2, 3, 1)[..., None] > 0
    check(torch.equal(opened.cpu()[~reach], opened_cpu[~reach]),
          f"{family} opened mask CUDA vs CPU")
    x8 = torch.rand((BATCH, 3, NFR, ISIZE, ISIZE), device="cuda") * 2 - 1
    with torch.inference_mode():
        b8_ms = event_ms(lambda: model(x8), reps=5, calls=1, warmup=2)
    on = threshold(pred).mean().item()
    say(f"infer-{family}",
        f"{name}: predict_clips on {BATCH} uint8 clips, CUDA vs CPU max-abs "
        f"{err:.3g} (<= 1e-4), mask on {on:.3f} -> "
        f"{opened.mean().item():.3f} after the th opening, equal to the "
        f"plain version, and to the CPU's mask outside the "
        f"{reach.float().mean():.4f} of the pixels within the opening's "
        f"reach of a prediction that close to 0.5; launches "
        f"{json.dumps(counts)}; b{BATCH} "
        f"forward {b8_ms:.3f} ms (median of 5); the CPU took {cpu_s:.1f} s; "
        "mp4 decode/encode (cv2) is covered by the CPU tests, not run here")
    return b8_ms


def phase_serve_bf16(paths: dict, f32_ms: dict) -> dict:
    """``--dtype bfloat16`` serving, one main path over the four families:
    each checkpoint loaded by the entry points' loader computing in
    bfloat16 (name tagged `` [bf16]``, parameters float32); ``predict_clips``
    on eight uint8 clips on the card, its first clip against the same
    bfloat16 model's on the CPU (one clip: the CPU is slow at full width)
    by the CPU tests' noise criterion: the mean distance to the CPU's
    bfloat16 prediction at most twice the CPU's own bfloat16-vs-float32
    distance (bf16 sums in two orders differ by an ulp now and then, and a
    recurrence or a deep net carries that on: 0.7% of the ConvLSTM's
    prediction is beyond 2^-7 relative of the CPU's, max-abs 5e-3); one
    launch of the opening kernel, the ConvLSTM on the bf16 conv kernel
    and never the float32 one; the b8 forward timed beside ``f32_ms``, the
    float32 one of this run; then a served request against a direct
    forward (frame scores, means of 16k pixels, within 2e-3: the server's
    batch of 8 may take other cuDNN algorithms than a direct forward of
    one) and four full batches over HTTP.  Returns family -> b8 ms."""
    from vfd_gan_tpu_torch.cli.infer import _load, predict_clips

    _reset_counts()                         # the bf16 serving path starts
    frames = np.random.default_rng(3).integers(
        0, 256, (BATCH, NFR, ISIZE, ISIZE, 3), dtype=np.uint8)
    rng = np.random.default_rng(7)
    clips = lambda k: rng.uniform(  # noqa: E731
        -1, 1, (k, NFR, ISIZE, ISIZE, 3)).astype(np.float32)
    out = {}
    for family, path in paths.items():
        model, name = _load(str(path), torch.device("cuda"), torch.bfloat16)
        check(name.endswith(" [bf16]") and all(
            p.dtype == torch.float32 for p in model.parameters()),
            f"{family}: {name}, float32 parameters")
        cpu_model, _ = _load(str(path), torch.device("cpu"), torch.bfloat16)
        t0 = time.perf_counter()
        pred_cpu, _, _ = predict_clips(cpu_model, frames[:1], "th")
        cpu_s = time.perf_counter() - t0
        cpu32, _ = _load(str(path), torch.device("cpu"))
        pred_cpu32, _, _ = predict_clips(cpu32, frames[:1], "th")
        del cpu_model, cpu32
        before = _counts()
        pred, opened, scores = predict_clips(model, frames, "th")
        torch.cuda.synchronize()
        counts = {k: n - before.get(k, 0) for k, n in _counts().items()}
        check(counts["morphology_open"] == 1 and counts["conv3x3"] == 0,
              f"{family} bf16 predict_clips launches: {counts}")
        if family == "clstm":
            check(counts["conv3x3_bf16"] == 3 * (1 + NFR),
                  f"the bf16 ConvLSTM ran on the bf16 kernel: {counts}")
        check(pred.dtype == torch.float32 and bool(torch.isfinite(
            pred).all()) and tuple(scores.shape) == (BATCH, NFR),
            f"{family} bf16 prediction")
        got, want = pred[:1].cpu(), pred_cpu
        err = (got - want).abs()
        share = (err > 2.0 ** -7 * want.abs()).float().mean().item()
        own = (want - pred_cpu32).abs().mean().item()
        check(err.mean().item() <= 2 * own,
              f"{family} bf16 CUDA vs CPU: mean distance {err.mean().item()} "
              f"against the CPU's own bf16-vs-f32 {own}; {share} of the "
              f"prediction beyond 2^-7, max-abs {err.max().item()}")
        x8 = torch.rand((BATCH, 3, NFR, ISIZE, ISIZE), device="cuda") * 2 - 1
        with torch.inference_mode():
            b8_ms = event_ms(lambda: model(x8), reps=5, calls=1, warmup=2)
        with _serving(path, "bfloat16") as (srv, base, _):
            check(srv.name == name, f"served as {srv.name}")
            served = _served_vs_direct(base, model, clips(1), tol=2e-3)
            b8, request_ms = _b8_rounds(srv, base, clips, 4)
        say(f"serve-bf16-{family}",
            f"{name}: predict_clips b{BATCH} CUDA vs CPU (clip 0) max-abs "
            f"{err.max().item():.3g}, mean {err.mean().item():.3g} (the "
            f"CPU's bf16 vs its f32: {own:.3g}), {100 * share:.4f}% beyond "
            f"2^-7 relative; mask on {opened.float().mean().item():.3f} after "
            f"the opening; b{BATCH} forward {b8_ms:.3f} ms beside float32 "
            f"{f32_ms[family]:.3f} ms in this run; served vs direct frame "
            f"scores {served:.3g}; b{BATCH} serve batch median "
            f"{statistics.median(b8):.2f} ms, HTTP request p50 "
            f"{statistics.median(request_ms):.2f} ms; the CPU's bf16 "
            f"forward of one clip took {cpu_s:.1f} s; launches "
            f"{json.dumps(counts)}")
        out[family] = b8_ms
        del model
    counts = _counts()                      # ... and ends
    check(counts["morphology_open"] > 0 and counts["conv3x3_bf16"] > 0
          and counts["conv3x3"] == 0,
          f"bf16 serving: opening and bf16 conv kernels, no float32 conv: "
          f"{counts}")
    say("serve-bf16", f"bf16 serve + infer path, four families: launches "
                      f"{json.dumps(counts)}")
    return out


def _wrappers() -> dict:
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from vfd_gan_tpu_torch.ops import launches

    return launches.wrappers()


def _reset_counts() -> None:
    from vfd_gan_tpu_torch.ops import launches

    launches.reset()


def _counts() -> dict:
    """Launches per kernel, and for the solver kernels, which count them by
    plane as well, per ``"kernel@HxW"``."""
    from vfd_gan_tpu_torch.ops import launches

    return launches.counts()


def run_trainer(argv, engine_cls):
    """``cli.trainer.main(argv)`` as one main path: the kernels' launch
    counts are set to 0 just before it and read just after.  Returns the
    engine, those counts, the part of them made inside the test sweep
    (``engine_cls.test`` is wrapped for the run to read the counters around
    it) and the wall seconds."""
    from vfd_gan_tpu_torch.cli.trainer import main as train_main

    sweep = collections.Counter(dict.fromkeys(_counts(), 0))
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


# bfloat16 CUDA-vs-CPU gradient bounds by net, as
# tests/test_torch_port_bf16_step.py holds the port to JAX: the median
# parameter's and the whole gradient's relative L2 distance, read from
# Adam's first moment after one step
BF16_GRAD_RTOL = {"clstm": 0.03, "c2plus1d": 0.3, "xception": 0.6,
                  "netg": 0.45, "netd": 0.7, "netg_ae": 0.3, "netd_ae": 0.7,
                  "anogan_g": 0.3, "anogan_d": 0.15, "ganomaly_g": 0.25,
                  "ganomaly_d": 0.15}


# The families whose bfloat16 step parity runs in eval mode (the
# --ref_mode_quirks latch): Xception's train-mode forward on the card
# equals the CPU's through block 2, where cuDNN's sums round one value of
# one conv the other way, and its middle flow's train-mode BatchNorms (64
# values per channel at this size) grow that difference block by block,
# as a float64-summed conv does on the CPU
# (tests/test_torch_port_bf16_nets.py).  In eval mode no
# BatchNorm divides by a batch's spread.
BF16_EVAL_PARITY = ("xception",)


def bf16_gradients_close(what: str, gpu, cpu, control) -> str:
    """A net's bfloat16 gradients on the card (``NetState`` ``gpu``)
    within BF16_GRAD_RTOL[what] of the CPU's, where the control's (the
    card's step on the clip reversed in time and mirrored) median misses
    it, as a zero, stale or misrouted gradient does; returns the
    readings."""
    from vfd_gan_tpu_torch.train.state import relative_distances

    want = cpu.first_moments()
    median, whole = relative_distances(gpu.first_moments(), want)
    cmedian, _ = relative_distances(control.first_moments(), want)
    rtol = BF16_GRAD_RTOL[what]
    check(median <= rtol and whole <= rtol < cmedian,
          f"{what} bf16 gradients: median {median}, whole {whole} <= "
          f"{rtol} < control {cmedian}")
    return (f"{what} gradient median {median:.3g}, whole {whole:.3g} "
            f"(<= {rtol}; control {cmedian:.3g})")


def bf16_stats_close(what: str, gpu: dict, cpu: dict) -> float:
    """A net's BatchNorm running means, and its variances, on the card
    within 2e-2 of the CPU's as a whole (relative L2), as
    tests/test_torch_port_bf16_step.py holds the port to JAX (one deep
    statistic near 0 may be far off in bfloat16); returns the larger."""
    from vfd_gan_tpu_torch.train.state import relative_distances

    worst = 0.0
    for kind in ("running_mean", "running_var"):
        keys = [k for k in cpu if k.endswith(kind)]
        _, whole = relative_distances({k: gpu[k] for k in keys},
                                      {k: cpu[k] for k in keys})
        check(whole <= 2e-2, f"{what} bf16 {kind}: {whole} <= 2e-2")
        worst = max(worst, whole)
    return worst


def phase_step_parity(tmp: Path, ae: bool = False,
                      dtype: str = "float32") -> None:
    """One _gan_core step on the card and on the CPU from the same weights
    and injected flows (``ae``: with the AutoEncoder as G).  Tolerances in
    float32: losses 1e-5, except the train-mode
    spatial D's, 5e-4 relative (float32 sums of its BatchNorms in another
    order, amplified through its deep BN chain, as in
    tests/test_torch_port_train.py); updated parameters within Adam's
    first-step sign-flip envelope of 2.5 lr (a conv bias under a BN has a
    true gradient of 0); BN statistics 1e-5 (spatial D: 5e-4 relative).
    In bfloat16, as tests/test_torch_port_bf16_gan_step.py holds the port
    to JAX: losses 1e-2 relative (the spatial feature-matching loss, the
    most amplified, 5e-2), parameters 2.5 lr, BN statistics by
    ``bf16_stats_close`` and G's and D's gradients by
    ``bf16_gradients_close``."""
    from vfd_gan_tpu_torch.config import Config
    from vfd_gan_tpu_torch.train.gan_engine import MyGanEngine

    b, s = 2, 64
    bf16 = dtype == "bfloat16"
    cfg = Config(model="mygan", isize=s, nfr=NFR, batchsize=b, ngf=8, ndf=8,
                 ep=1, compute_dtype=dtype, tensorboard=False, ae=ae,
                 result_root=str(tmp))
    rng = np.random.default_rng(4)
    data = rng.uniform(-1, 1, (b, NFR, s, s, 3)).astype(np.float32)
    gt = (rng.uniform(size=(b, NFR, s, s, 1)) > 0.85).astype(np.float32)
    flows = rng.uniform(-1, 1, (2 * b, NFR, s, s, 3)).astype(np.float32)
    out, engines = {}, {}
    # the bfloat16 gradients' control: the card's step on the clip
    # reversed in time and mirrored
    runs = (("cpu", data), ("cuda", data)) + (
        (("control", data[:, ::-1, :, ::-1].copy()),) if bf16 else ())
    for run, clip in runs:
        device = torch.device("cpu" if run == "cpu" else "cuda")
        eng = MyGanEngine(cfg, None, None, device=device)
        for m in eng.netg.modules():
            if hasattr(m, "drop_rate"):
                m.drop_rate = 0.0
        fl = torch.from_numpy(flows).to(device)
        eng._flow = lambda v, streams=1, fl=fl: fl  # noqa: E731
        metrics = eng._gan_core(torch.from_numpy(clip).to(device),
                                torch.from_numpy(gt).to(device))
        engines[run] = eng
        out[run] = ({k: float(v) for k, v in metrics.items()},
                    {k: v.cpu() for k, v in eng.netg.state_dict().items()},
                    {k: v.cpu() for k, v in eng.netd.state_dict().items()})
    (m_cpu, g_cpu, d_cpu), (m_gpu, g_gpu, d_gpu) = out["cpu"], out["cuda"]
    worst_loss = 0.0
    for k, v in m_cpu.items():
        rel = 5e-4 if ("_s/" in k or k in ("d/err_d_real/train",
                                           "d/err_d_fake/train",
                                           "d/err_d/train", "g/err_g/train",
                                           "g/err_g_adv/train")) else 0.0
        if bf16:
            rel = 5e-2 if k.split("/")[1] in ("err_g_adv_s",
                                              "err_g_adv") else 1e-2
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
            if "running" in k and bf16:
                continue
            if "running" in k:
                bound = 1e-5 + (5e-4 * v.abs().max().item()
                                if k.startswith("spatdisc") else 0.0)
                check(diff <= bound, f"BN stat {k}: {diff} <= {bound}")
                worst_stat = max(worst_stat, diff)
            else:
                check(diff <= 2.5 * lr, f"param {k}: {diff} <= 2.5 lr")
                worst_param = max(worst_param, diff)
    grads = ""
    if bf16:
        worst_stat = max(bf16_stats_close("G", g_gpu, g_cpu),
                         bf16_stats_close("D", d_gpu, d_cpu))
        tag = "_ae" if ae else ""
        grads = "; " + "; ".join(bf16_gradients_close(
            net + tag, *(getattr(engines[r], attr)
                         for r in ("cuda", "cpu", "control")))
            for net, attr in (("netg", "g"), ("netd", "d")))
    say("stepparity", f"_gan_core{' --ae' if ae else ''} {dtype} b{b} T{NFR} "
                      f"{s}^2 "
                      f"{'AutoEncoder, ndf=8' if ae else 'ngf=ndf=8'}, "
                      f"CUDA vs CPU "
                      f"(TF32 off): losses max-abs {worst_loss:.3g}, params "
                      f"{worst_param:.3g} (<= 2.5 lr = {2.5 * lr:.3g}), BN "
                      f"stats {worst_stat:.3g}{' (relative L2)' if bf16 else ''}"
                      f"{grads}")


# the supervised families' CUDA-vs-CPU step sizes (the CPU tests' own):
# model -> (batch, nfr, isize, extra Config fields)
SUPERVISED_PARITY = {"clstm": (2, 8, 16, {}), "c2plus1d": (2, 16, 16, {}),
                     "xception": (2, 8, 32, {"xwidth": 1 / 16})}


def phase_supervised_parity(tmp: Path, dtype: str = "float32") -> None:
    """One SupervisedEngine step per family on the card and on the CPU,
    from the same seeded weights and the same injected augment draws
    (gathered by the kernel on the card, by the plain version on the CPU),
    dropout at rate 0.  Tolerances as the CPU tests hold the port to JAX:
    in float32 the loss 1e-5, BN statistics 1e-5, updated parameters
    within Adam's first-step envelope of 2.5 lr with at most 2% beyond
    5e-6; in bfloat16 (c2plus1d at 32^2, as
    tests/test_torch_port_bf16_step.py) the loss 1e-2 relative,
    parameters 2.5 lr, BN statistics by ``bf16_stats_close`` and the
    gradients by ``bf16_gradients_close``.  Xception's bfloat16 step runs
    in eval mode (``BF16_EVAL_PARITY``)."""
    from vfd_gan_tpu_torch.config import Config
    from vfd_gan_tpu_torch.ops.augment import (
        _src_coords,
        augment_gather,
        staging_size,
    )
    from vfd_gan_tpu_torch.train.supervised_engine import SupervisedEngine

    bf16 = dtype == "bfloat16"
    for family, (b, t, isize, extra) in SUPERVISED_PARITY.items():
        if bf16 and family == "c2plus1d":
            isize = 32
        eval_mode = bf16 and family in BF16_EVAL_PARITY
        cfg = Config(model=family, batchsize=b, nfr=t, isize=isize, ep=1,
                     compute_dtype=dtype, tensorboard=False,
                     result_root=str(tmp), ref_mode_quirks=eval_mode,
                     **extra)
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
        out, nets = {}, {}
        runs = (("cpu", data), ("cuda", data)) + (
            (("control", data[:, ::-1, :, ::-1].copy()),) if bf16 else ())
        for run, clip in runs:
            device = torch.device("cpu" if run == "cpu" else "cuda")
            eng = SupervisedEngine(cfg, None, None, device=device)
            for m in eng.model.modules():
                if hasattr(m, "drop_rate"):
                    m.drop_rate = 0.0
            if eval_mode:     # the --ref_mode_quirks latch: eval mode
                eng.global_step = cfg.freq + 1
            batch = [torch.from_numpy(v).to(device)
                     for v in (clip, clip, mask)]
            x, _, gt = augment_gather(*batch, src_x.to(device),
                                      src_y.to(device))
            loss = float(eng._step(x, gt)["loss/err/train"])
            nets[run] = eng.net
            out[run] = (loss, {k: v.cpu() for k, v in
                               eng.model.state_dict().items()})
        (l_cpu, sd_cpu), (l_gpu, sd_gpu) = out["cpu"], out["cuda"]
        check(np.isfinite(l_gpu) and abs(l_gpu - l_cpu) <= (
            1e-2 * abs(l_cpu) if bf16 else 1e-5),
            f"{family} step loss: cuda {l_gpu} vs cpu {l_cpu}")
        lr = cfg.lr
        worst_param = worst_stat = 0.0
        total = loose = 0
        for k, v in sd_cpu.items():
            if k.endswith("num_batches_tracked"):
                continue
            d = (sd_gpu[k] - v).abs()
            if "running" in k and not bf16:
                check(d.max().item() <= 1e-5, f"{family} BN stat {k}")
                worst_stat = max(worst_stat, d.max().item())
            elif "running" in k:
                continue
            else:
                check(d.max().item() <= 2.5 * lr, f"{family} param {k}")
                worst_param = max(worst_param, d.max().item())
                total += d.numel()
                loose += int((d > 5e-6).sum())
        if bf16:
            if not eval_mode:
                worst_stat = bf16_stats_close(family, sd_gpu, sd_cpu)
            grads = bf16_gradients_close(
                family, nets["cuda"], nets["cpu"], nets["control"])
        else:
            check(loose / total < 0.02,
                  f"{family}: {loose} of {total} params beyond 5e-6")
            grads = f"{loose}/{total} params beyond 5e-6"
        say("stepparity", f"{family} {dtype} b{b} T{t} {isize}^2 {extra}"
                          f"{' (eval mode)' if eval_mode else ''}: "
                          f"CUDA vs "
                          f"CPU (TF32 off) loss {abs(l_gpu - l_cpu):.3g}, "
                          f"params max {worst_param:.3g} (<= 2.5 lr), "
                          f"BN stats {worst_stat:.3g}"
                          f"{' (relative L2)' if bf16 else ''}; {grads}")


def _within(what: str, got: dict, want: dict, lr: float,
            stats_rtol: float) -> tuple[float, float]:
    """Updated parameters of one net within Adam's first-step envelope of
    2.5 lr; its BatchNorm running statistics (``stats_rtol`` not None)
    within 1e-5 relative plus ``stats_rtol`` of each vector's largest
    value.  Returns the largest parameter and statistic differences."""
    worst_param = worst_stat = 0.0
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            check(torch.equal(got[k], v), f"{what} {k}")
            continue
        diff = (got[k] - v).abs()
        if "running" in k:
            if stats_rtol is None:
                continue
            bound = 1e-5 * v.abs() + 1e-5 + stats_rtol * v.abs().max()
            check(bool((diff <= bound).all()), f"{what} BN stat {k}")
            worst_stat = max(worst_stat, diff.max().item())
        else:
            check(diff.max().item() <= 2.5 * lr,
                  f"{what} param {k}: {diff.max().item()} <= 2.5 lr")
            worst_param = max(worst_param, diff.max().item())
    return worst_param, worst_stat


def phase_family_parity(tmp: Path, model: str,
                        dtype: str = "float32") -> None:
    """One AnoGAN ``_ano_core`` or GANomaly ``_ganomaly_core`` step on the
    card and on the CPU from the same seeded weights, clip and z, AnoGAN's
    dropout masks drawn from one CPU generator for both (b2, 32^2; AnoGAN
    T16, GANomaly T8 folded to 16 frames).  Tolerances, as MyGAN's in
    float32: losses 1e-5 + 5e-4 relative (D's train-mode BatchNorms),
    parameters 2.5 lr (G's AnoGAN lr is 5x), running statistics 1e-5
    relative plus, for D, 5e-4 of each vector's largest value (AnoGAN's
    third D update reads the updated D behind its LeakyReLU(64)); in
    bfloat16 as PR 8's criteria: losses 1e-2 relative, parameters 2.5 lr,
    running statistics by ``bf16_stats_close`` and the gradients by
    ``bf16_gradients_close`` against a control step (the clip reversed in
    time and mirrored, z reversed)."""
    from vfd_gan_tpu_torch.config import Config
    from vfd_gan_tpu_torch.train.anogan_engine import AnoGanEngine
    from vfd_gan_tpu_torch.train.ganomaly_engine import GanomalyEngine, fold

    bf16 = dtype == "bfloat16"
    b, t, s = (2, NFR, 32) if model == "anogan" else (2, 8, 32)
    cfg = Config(model=model, batchsize=b, nfr=t, isize=s, ep=1,
                 compute_dtype=dtype, tensorboard=False,
                 result_root=str(tmp))
    rng = np.random.default_rng(6)
    clip = rng.uniform(-1, 1, (b, t, s, s, 3)).astype(np.float32)
    z = rng.standard_normal((b, 100)).astype(np.float32)
    runs = [("cpu", clip, z), ("cuda", clip, z)] + (
        [("control", clip[:, ::-1, :, ::-1].copy(), z[:, ::-1].copy())]
        if bf16 else [])
    out, engines = {}, {}
    for run, c, zz in runs:
        device = torch.device("cpu" if run == "cpu" else "cuda")
        x = torch.from_numpy(c).to(device)
        if model == "anogan":
            eng = AnoGanEngine(cfg, None, None, device=device)
            metrics, _ = eng._ano_core(x, torch.from_numpy(zz).to(device),
                                       torch.Generator().manual_seed(7))
        else:
            eng = GanomalyEngine(cfg, None, None, device=device)
            metrics, _ = eng._ganomaly_core(fold(x))
        engines[run] = eng
        out[run] = ({k: float(v) for k, v in metrics.items()},
                    {k: v.cpu() for k, v in eng.netg.state_dict().items()},
                    {k: v.cpu() for k, v in eng.netd.state_dict().items()})
    (m_cpu, g_cpu, d_cpu), (m_gpu, g_gpu, d_gpu) = out["cpu"], out["cuda"]
    worst_loss = 0.0
    for k, v in m_cpu.items():
        rel = 1e-2 if bf16 else 5e-4
        diff = abs(m_gpu[k] - v)
        check(np.isfinite(m_gpu[k]) and diff <= 1e-5 + rel * abs(v),
              f"{model} step loss {k}: cuda {m_gpu[k]} vs cpu {v}")
        worst_loss = max(worst_loss, diff)
    g_lr = 5 * cfg.lr if model == "anogan" else cfg.lr
    gp, gs = _within(f"{model} G", g_gpu, g_cpu, g_lr,
                     None if bf16 else 0.0)
    dp, ds = _within(f"{model} D", d_gpu, d_cpu, cfg.lr,
                     None if bf16 else 5e-4)
    worst_param, worst_stat = max(gp, dp), max(gs, ds)
    grads = ""
    if bf16:
        worst_stat = max(bf16_stats_close(f"{model} G", g_gpu, g_cpu),
                         bf16_stats_close(f"{model} D", d_gpu, d_cpu))
        grads = "; " + "; ".join(bf16_gradients_close(
            f"{model}_{net}", *(getattr(engines[r], net)
                                for r in ("cuda", "cpu", "control")))
            for net in ("g", "d"))
    for eng in engines.values():
        eng.close()
    say("stepparity", f"{model} {dtype} b{b} T{t} {s}^2, CUDA vs CPU (TF32 "
                      f"off): losses max-abs {worst_loss:.3g}, params "
                      f"{worst_param:.3g} (<= 2.5 lr), BN stats "
                      f"{worst_stat:.3g}"
                      f"{' (relative L2)' if bf16 else ''}{grads}")


def phase_family_train(tmp: Path, model: str,
                       dtype: str | None = "float32"):
    """``cli.trainer.main --model anogan|ganomaly`` at the reference size
    (b8, T16, 128^2; both families' widths are fixed) in ``dtype`` (None:
    the default command line, bfloat16) for ``FAMILY_STEPS`` steps and a
    ``FAMILY_SWEEP``-batch sweep; returns the engine, the kernels' launch
    counts on the run, those of its sweep, the step median (ms) and peak
    memory (MiB)."""
    from vfd_gan_tpu_torch.models.anogan import (
        AnoDiscriminator,
        AnoGenerator,
    )
    from vfd_gan_tpu_torch.models.ganomaly import (
        GanomalyDiscriminator,
        GanomalyGenerator,
    )
    from vfd_gan_tpu_torch.train.anogan_engine import AnoGanEngine
    from vfd_gan_tpu_torch.train.ganomaly_engine import GanomalyEngine
    from vfd_gan_tpu_torch.utils.checkpoint import load_state_dict

    ano = model == "anogan"
    flags, label = _dtype_flags(dtype)
    root = tmp / f"runs_{model}_{dtype or 'default'}"
    argv = ["--model", model, "--batchsize", str(BATCH), "--nfr", str(NFR),
            "--isize", str(ISIZE), *flags,
            "--synthetic_data", str(FAMILY_STEPS),
            "--synthetic_test_batches", str(FAMILY_SWEEP), "--ep", "1",
            "--freq", str(FAMILY_STEPS), "--device", "cuda",
            "--no-tensorboard", "--result_root", str(root)]
    torch.cuda.reset_peak_memory_stats()
    engine, counts, sweep, wall = run_trainer(
        argv, AnoGanEngine if ano else GanomalyEngine)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    check(engine.global_step == FAMILY_STEPS, f"{model}: all steps ran")
    losses = {k: v for k, v in engine.errors.items() if "/" in k
              and not k.startswith("perf/")}
    check(len(losses) >= (4 if ano else 5)
          and all(np.isfinite(v) for v in losses.values()),
          f"{model}: finite losses {losses}")
    heads = ("roc", "pr", "f1") if ano else ("roc",)
    scores = {k: engine.scores[f"score/{k}"] for k in heads}
    check(all(np.isfinite(v) for v in scores.values())
          and engine.scores["score/roc"] > 0, f"{model}: sweep {scores}")
    g_pth = sorted(root.rglob("*_netG.pth"))
    d_pth = sorted(root.rglob("*_netD.pth"))
    check(len(g_pth) == len(d_pth) == 1, f"{model}: one best pair: "
                                         f"{g_pth} {d_pth}")
    g_net, d_net = ((AnoGenerator(NFR, ISIZE), AnoDiscriminator(NFR, ISIZE))
                    if ano else (GanomalyGenerator(ISIZE),
                                 GanomalyDiscriminator(ISIZE)))
    g_net.load_state_dict(load_state_dict(str(g_pth[0])), strict=True)
    d_net.load_state_dict(load_state_dict(str(d_pth[0])), strict=True)
    check(counts["augment_gather"] == FAMILY_STEPS
          and sweep["augment_gather"] == 0,
          f"{model}: one augment launch per step, none in the sweep: "
          f"{counts}")
    check(counts["morphology_open"] == sweep["morphology_open"]
          == (FAMILY_SWEEP if ano else 0),
          f"{model}: opening launches {counts['morphology_open']} "
          f"(sweep {sweep['morphology_open']}), expected "
          f"{FAMILY_SWEEP if ano else 0}, all in the sweep")
    check(all(counts[k] == 0 for k in ("flow_fused", "flow_warp",
                                       "flow_refine", "conv3x3",
                                       "conv3x3_bf16")),
          f"{model} has no flow and no ConvLSTM: {counts}")
    steady = engine.step_seconds[2:]
    median = 1e3 * statistics.median(steady)
    what = f"train-{model}{'' if dtype == 'float32' else '-bf16'}"
    say(what, f"trainer.main --model {model} b{BATCH} T{NFR} {ISIZE}^2 "
              f"{label}: {FAMILY_STEPS} steps + {FAMILY_SWEEP}-batch sweep "
              f"in {wall:.1f} s; step median {median:.1f} ms "
              f"({BATCH * 1e3 / median:.1f} clips/s; min "
              f"{1e3 * min(steady):.1f}, max {1e3 * max(steady):.1f}, after "
              f"2 warm-up); first step {1e3 * engine.step_seconds[0]:.0f} "
              f"ms; peak memory {peak:.0f} MiB; losses {json.dumps(losses)}")
    say(what, f"sweep: {json.dumps(scores)}; saved {g_pth[0].name}, "
              f"{d_pth[0].name} (loaded strict); launches "
              f"{json.dumps(counts)}, of them in the sweep "
              f"{json.dumps(sweep)}")
    return engine, counts, sweep, median, peak


# --device_scoring: the families, each at the reference width with a
# two-batch sweep (model -> extra flags)
SCORED = {"anogan": [], "mygan": ["--ngf", "32", "--ndf", "32",
                                  "--flow_scale", "0.5"],
          "clstm": [], "c2plus1d": [], "xception": ["--xwidth", "1.0"],
          "ganomaly": []}


def phase_device_scoring(tmp: Path) -> None:
    """One full-width test sweep of each family with and without
    ``--device_scoring`` from the same seed (the same weights, test clips
    and AnoGAN z): roc/pr/f1 within 1e-5 and the same best checkpoint
    written.  GANomaly's frame-level sweep stays on the host either way,
    as in the JAX engine.  The time of ``score_and_checkpoint`` (the
    scoring and the checkpoint rule) on each path is printed."""
    from vfd_gan_tpu_torch.cli.trainer import build_engine

    for model, extra in SCORED.items():
        results, saved, ms = {}, {}, {}
        for flag in (False, True):
            root = tmp / f"scoring_{model}_{flag}"
            eng = build_engine(
                ["--model", model, "--batchsize", str(BATCH), "--nfr",
                 str(NFR), "--isize", str(ISIZE), "--compute_dtype",
                 "float32", "--synthetic_data", "1",
                 "--synthetic_test_batches", "2", "--device", "cuda",
                 "--no-tensorboard", "--result_root", str(root), *extra,
                 *(["--device_scoring"] if flag else [])])
            score = eng.score_and_checkpoint
            spent = []

            def timed(*a, score=score, spent=spent):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = score(*a)
                spent.append(1e3 * (time.perf_counter() - t0))
                return out

            eng.score_and_checkpoint = timed
            out = eng.test()
            results[flag] = out if isinstance(out, tuple) else (out,)
            ms[flag] = spent[0] if spent else float("nan")
            saved[flag] = sorted(p.name for p in root.rglob("*.pth"))
            check(("score/eer" in eng.scores) == (flag and model
                                                  != "ganomaly"),
                  f"{model}: the EER comes with device scoring")
            eng.close()
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        host, dev = results[False], results[True]
        check(all(np.isfinite(dev)) and all(
            abs(a - b) <= 1e-5 for a, b in zip(host, dev)),
            f"{model} --device_scoring {dev} vs host {host}")
        check(saved[True] == saved[False] and saved[True],
              f"{model}: the same best checkpoint: {saved}")
        spent = (f"score_and_checkpoint {ms[True]:.1f} ms (device) vs "
                 f"{ms[False]:.1f} ms (host)" if model != "ganomaly" else
                 "frame-level ROC on the host either way")
        diff = max(abs(a - b) for a, b in zip(host, dev))
        say("device-scoring", f"{model} b{BATCH} T{NFR} {ISIZE}^2, 2-batch "
                              f"sweep: device {dev} vs host {host}, max "
                              f"diff {diff:.3g}; saved {saved[True]} on "
                              f"both; {spent}")


def _dtype_flags(dtype: str | None) -> tuple[list, str]:
    """The trainer's flags for ``dtype`` (None: no flag, the default
    command line, which computes in bfloat16) and its label."""
    if dtype is None:
        return [], "bfloat16 (default: no --compute_dtype)"
    return ["--compute_dtype", dtype], dtype


def phase_supervised_train(tmp: Path, family: str,
                           dtype: str | None = "float32", steps: int = 0,
                           extra: tuple = (), tag: str = "") -> dict:
    """``cli.trainer.main --model family`` at the reference width, b8, T16,
    128^2, in ``dtype`` (None: the default command line, bfloat16), with a
    one-batch test sweep (``steps`` and ``extra`` flags, where given, in
    place of ``SUPERVISED_RUNS``'; ``tag`` names the run); returns the
    engine, the kernels' launch counts on the run, those of its sweep, the
    step median (ms) and peak memory (MiB)."""
    from vfd_gan_tpu_torch.models import build_mask_model
    from vfd_gan_tpu_torch.train.supervised_engine import SupervisedEngine
    from vfd_gan_tpu_torch.utils.checkpoint import load_state_dict

    if not steps:
        steps, extra = SUPERVISED_RUNS[family]
    flags, label = _dtype_flags(dtype)
    root = tmp / f"runs_{family}{tag}_{dtype or 'default'}"
    argv = ["--model", family, "--batchsize", str(BATCH), "--nfr", str(NFR),
            "--isize", str(ISIZE), *flags,
            "--synthetic_data", str(steps), "--synthetic_test_batches", "1",
            "--ep", "1", "--freq", str(steps), "--device", "cuda",
            "--no-tensorboard", "--result_root", str(root), *extra]
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
        # layer's first hidden half (their inputs need no gradient); all
        # on the kernel of the run's dtype, none on the other
        conv, other = (("conv3x3", "conv3x3_bf16") if dtype == "float32"
                       else ("conv3x3_bf16", "conv3x3"))
        fwd = 3 * (1 + NFR)
        check(counts[conv] - sweep[conv] == steps * (2 * fwd - 4)
              and sweep[conv] == fwd * engine.test_iter.n_batches
              and counts[other] == 0,
              f"clstm launched the {conv} kernel {counts[conv]} times, "
              f"{sweep[conv]} of them in the sweep, {other} "
              f"{counts[other]} times; expected {2 * fwd - 4} per step "
              f"(forward and dx), {fwd} per sweep batch, and 0")
        check(2 * fwd - 4 == CONV_LAUNCHES_PER_STEP,
              "the conv phase's cases are one step's launches")
    steady = engine.step_seconds[2:] if steps > 4 else engine.step_seconds[1:]
    median = 1e3 * statistics.median(steady)
    what = f"train-{family}{tag}{'' if dtype == 'float32' else '-bf16'}"
    say(what,
        f"trainer.main --model {family} b{BATCH} T{NFR} {ISIZE}^2 {label} "
        f"{' '.join(extra)}: {steps} steps + sweep in {wall:.1f} s; step "
        f"median {median:.1f} ms (min "
        f"{1e3 * min(steady):.1f}, max {1e3 * max(steady):.1f}, after "
        f"{steps - len(steady)} warm-up); first step "
        f"{1e3 * engine.step_seconds[0]:.0f} ms; peak memory {peak:.0f} "
        f"MiB; losses {json.dumps(losses)}")
    say(what, f"sweep: roc {roc:.6g} pr {pr:.6g} f1 {f1:.6g}; saved "
              f"{pth[0].name} (loaded strict); launches "
              f"{json.dumps(counts)}, of them in the sweep "
              f"{json.dumps(sweep)}")
    return engine, counts, sweep, median, peak


def phase_train(tmp: Path, dtype: str | None = "float32", ae: bool = False,
                steps: int = TRAIN_STEPS, sweep_batches: int = 2,
                extra: tuple = (), tag: str = ""):
    """The MyGAN training main path at the reference width in ``dtype``
    (None: the default command line, bfloat16; ``ae``: the AutoEncoder as
    G; ``extra`` flags, the run named by ``tag``); returns the engine, the
    kernels' launch counts on it, those of its sweep, the step median (ms)
    and peak memory (MiB)."""
    from vfd_gan_tpu_torch.models.mygan import DualDisc, Generator
    from vfd_gan_tpu_torch.models.stcnn import AutoEncoder
    from vfd_gan_tpu_torch.train.gan_engine import MyGanEngine
    from vfd_gan_tpu_torch.utils.checkpoint import load_state_dict

    flags, label = _dtype_flags(dtype)
    root = tmp / f"runs_mygan{'_ae' if ae else ''}{tag}_{dtype or 'default'}"
    argv = ["--model", "mygan", "--batchsize", str(BATCH), "--nfr", str(NFR),
            "--isize", str(ISIZE), "--ngf", "32", "--ndf", "32",
            "--flow_scale", "0.5", *flags, *(["--ae"] if ae else []), *extra,
            "--synthetic_data", str(steps),
            "--synthetic_test_batches", str(sweep_batches), "--ep", "1",
            "--freq", str(steps), "--device", "cuda",
            "--no-tensorboard", "--result_root", str(root)]
    torch.cuda.reset_peak_memory_stats()
    engine, counts, sweep, wall = run_trainer(argv, MyGanEngine)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    check(engine.global_step == steps, "all train steps ran")
    losses = {k: v for k, v in engine.errors.items() if "/" in k}
    check(len(losses) > 20 and all(np.isfinite(v) for v in losses.values()),
          f"finite losses: {losses}")
    roc, pr, f1 = (engine.scores[f"score/{k}"] for k in ("roc", "pr", "f1"))
    check(all(np.isfinite(v) for v in (roc, pr, f1)), "sweep scores")
    g_pth = sorted(root.rglob("*_netG.pth"))
    d_pth = sorted(root.rglob("*_netD.pth"))
    check(len(g_pth) == len(d_pth) == 1, f"one best pair: {g_pth} {d_pth}")
    (AutoEncoder() if ae else Generator(32)).load_state_dict(
        load_state_dict(str(g_pth[0])), strict=True)
    DualDisc(32, NFR, ISIZE).load_state_dict(load_state_dict(str(d_pth[0])),
                                             strict=True)
    check(counts["flow_fused"] > 0, "training launched the fused kernel")
    check(counts["augment_gather"] > 0,
          "training launched the augment kernel")
    check(counts["morphology_open"] > 0,
          "the test sweep launched the opening kernel")
    check(counts["conv3x3"] == counts["conv3x3_bf16"] == 0,
          "MyGAN has no ConvLSTM")
    warm = 4 if steps > 6 else 1
    steady = engine.step_seconds[warm:]
    median = 1e3 * statistics.median(steady)
    what = (f"train{'-ae' if ae else ''}{tag}"
            f"{'' if dtype == 'float32' else '-bf16'}")
    say(what, f"trainer.main b{BATCH} T{NFR} {ISIZE}^2 "
              f"{'--ae ' if ae else 'ngf=32 '}ndf=32 flow_scale 0.5 {label}: "
              f"{steps} steps + sweep in {wall:.1f} s; step median "
              f"{median:.1f} ms (min {1e3 * min(steady):.1f}, max "
              f"{1e3 * max(steady):.1f}, steps {warm + 1}-{steps}); first "
              f"step {1e3 * engine.step_seconds[0]:.0f} ms; peak memory "
              f"{peak:.0f} MiB")
    say(what, "losses at the last step: " + ", ".join(
        f"{k} {v:.5g}" for k, v in sorted(losses.items())
        if k.endswith("/train")))
    say(what, f"sweep: roc {roc:.6g} pr {pr:.6g} f1 {f1:.6g}; saved "
              f"{g_pth[0].name}, {d_pth[0].name} (loaded strict); "
              f"launches {json.dumps(counts)}, of them in the sweep "
              f"{json.dumps(sweep)}")
    return engine, counts, sweep, median, peak


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


class MemoryClips:
    """Clips in memory with the surface of the port's ``MdfVideoDataset``
    (``__len__``, ``__getitem__`` -> data, real, mask, label), made from a
    numpy seed: a blocky background, and in every second clip a square
    forgery that moves a pixel or two per frame, its outline as the gt mask
    (what the dataset's invert + Canny preparation finds).  No decode: the
    machine this runs on need not have cv2."""

    def __init__(self, n: int, nfr: int, size: int, seed: int):
        rng = np.random.default_rng(seed)
        coarse = rng.integers(0, 256, (n, nfr, size // 4, size // 4, 3),
                              dtype=np.uint8)
        self.real = coarse.repeat(4, axis=2).repeat(4, axis=3)
        self.data = self.real.copy()
        self.mask = np.zeros((n, nfr, size, size, 1), np.uint8)
        side = size // 4
        for i in range(0, n, 2):
            y0, x0 = rng.integers(0, size - side - 2 * nfr, 2)
            color = rng.integers(0, 256, 3, dtype=np.uint8)
            for t in range(nfr):
                y, x = y0 + t, x0 + 2 * t
                self.data[i, t, y:y + side, x:x + side] = color
                self.mask[i, t, y:y + side, x:x + side] = 255
                self.mask[i, t, y + 1:y + side - 1, x + 1:x + side - 1] = 0
        self.nfr = nfr

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, i: int):
        fake = bool(self.mask[i].any())
        return (self.data[i], self.real[i], self.mask[i],
                np.full(self.nfr, float(fake), np.float32))


def _full_width_cfg(model: str, root: Path, **kw):
    from vfd_gan_tpu_torch.config import Config

    return Config(model=model, batchsize=BATCH, nfr=NFR, isize=ISIZE, ngf=32,
                  ndf=32, flow_scale=0.5, compute_dtype="float32", ep=1,
                  tensorboard=False, result_root=str(root), **kw).validate()


def _memory_iterators(cfg, n_train: int, n_test: int):
    """The trainer's two iterators over clips in memory: the train split
    staged at ``staging_size(isize)``, both shuffled from ``cfg.seed``."""
    from vfd_gan_tpu_torch.data.dataset import ClipBatchIterator
    from vfd_gan_tpu_torch.ops.augment import staging_size

    def iterator(n, size, seed):
        return ClipBatchIterator(MemoryClips(n, cfg.nfr, size, seed),
                                 cfg.batchsize, shuffle=True, seed=cfg.seed,
                                 prefetch=cfg.prefetch, workers=cfg.workers)

    return (iterator(n_train, staging_size(cfg.isize), 10),
            iterator(n_test, cfg.isize, 11))


def _engine_cls(model: str):
    from vfd_gan_tpu_torch.train.gan_engine import MyGanEngine
    from vfd_gan_tpu_torch.train.supervised_engine import SupervisedEngine

    return MyGanEngine if model == "mygan" else SupervisedEngine


DATA_STEPS = 8


def phase_data(tmp: Path, device, synthetic_ms: dict) -> None:
    """Host batches through ``ClipBatchIterator`` and ``device_prefetch``
    into the MyGAN and clstm engines (``DATA_STEPS`` steps and a two-batch
    sweep each); ``synthetic_ms``: this run's step medians on synthetic
    data, printed beside."""
    from vfd_gan_tpu_torch.parallel.prefetch import device_prefetch

    # what the prefetcher yields is what the iterator gave, bit for bit
    cfg = _full_width_cfg("clstm", tmp / "data_probe")
    first, _ = _memory_iterators(cfg, 4 * BATCH, BATCH)
    second, _ = _memory_iterators(cfg, 4 * BATCH, BATCH)
    events: list = []
    n = nbytes = 0
    for got, want in zip(device_prefetch(first, device, depth=2,
                                         h2d_events=events), second):
        check(set(got) == set(want), "prefetched fields")
        for k, v in want.items():
            if k == "index":
                check(isinstance(got[k], np.ndarray)
                      and np.array_equal(got[k], v), "index stays on the host")
            else:
                check(got[k].device.type == "cuda" and np.array_equal(
                    got[k].cpu().numpy(), v), f"prefetched {k} == host {k}")
        nbytes = sum(v.nbytes for k, v in want.items() if k != "index")
        n += 1
    check(n == 4 and first.epoch == 1, "four batches, one pass")
    torch.cuda.synchronize()
    h2d = [s.elapsed_time(e) for s, e in events]
    say("data", f"device_prefetch over ClipBatchIterator: {n} batches of "
                f"{nbytes / 1e6:.1f} MB equal to the iterator's bit for bit; "
                f"host-to-device copy from pinned memory on the side stream "
                f"{statistics.median(h2d):.3f} ms per batch (max "
                f"{max(h2d):.3f}): {nbytes / 1e6 / statistics.median(h2d):.1f}"
                f" GB/s")

    for model in ("mygan", "clstm"):
        cfg = _full_width_cfg(model, tmp / f"data_{model}", freq=DATA_STEPS)
        train_iter, test_iter = _memory_iterators(cfg, DATA_STEPS * BATCH,
                                                  2 * BATCH)
        engine = _engine_cls(model)(cfg, train_iter, test_iter, device=device)
        engine.h2d_events = []
        _reset_counts()                  # the host-data path starts
        engine.train()
        torch.cuda.synchronize()
        counts = _counts()               # ... and ends
        engine.close()
        check(engine.global_step == DATA_STEPS, f"data-{model}: all steps ran")
        check(all(np.isfinite(v) for v in engine.errors.values()),
              f"data-{model}: finite losses")
        check(all(np.isfinite(engine.scores[f"score/{k}"])
                  for k in ("roc", "pr", "f1")), f"data-{model}: sweep scores")
        # launches as with synthetic data: the augment kernel once per
        # step, the opening once per sweep batch; MyGAN's fused kernel three
        # times per step and per sweep batch; clstm's conv kernel
        fwd = 3 * (1 + NFR)
        want = {"augment_gather": DATA_STEPS, "morphology_open": 2,
                "flow_fused": 3 * (DATA_STEPS + 2) if model == "mygan" else 0,
                "conv3x3": 0 if model == "mygan" else
                DATA_STEPS * CONV_LAUNCHES_PER_STEP + 2 * fwd}
        check(all(counts[k] == v for k, v in want.items()),
              f"data-{model}: launches {counts}, expected {want}")
        steady = engine.step_seconds[2:]
        waits = engine.data_seconds[2:]
        h2d = [s.elapsed_time(e) for s, e in engine.h2d_events]
        say(f"data-{model}",
            f"b{BATCH} T{NFR} {ISIZE}^2 float32 on host batches through "
            f"device_prefetch (depth {cfg.prefetch}): step median "
            f"{1e3 * statistics.median(steady):.1f} ms (min "
            f"{1e3 * min(steady):.1f}, max {1e3 * max(steady):.1f}, steps "
            f"3-{DATA_STEPS}) beside {synthetic_ms[model]:.1f} ms on "
            f"synthetic data in this run; wait for a batch median "
            f"{1e3 * statistics.median(waits):.3f} ms (max "
            f"{1e3 * max(waits):.3f}); H2D {statistics.median(h2d):.3f} ms "
            f"per batch over {len(h2d)} batches; launches "
            f"{json.dumps({k: counts[k] for k in want})}")


def _tree_equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype \
            and torch.equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) \
            and all(_tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) \
            and all(_tree_equal(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


def _recording(engine, losses: list, stop_at=None) -> None:
    """Record the losses of every train step of ``engine`` in ``losses``;
    ``stop_at``: raise a SIGTERM after that step."""
    step = engine._train_step_impl

    def recording_step(batch):
        out = step(batch)
        losses.append({k: float(v) for k, v in out.items()})
        if engine.global_step == stop_at:
            signal.raise_signal(signal.SIGTERM)
        return out

    engine._train_step_impl = recording_step


def _recorded_engine(model: str, root: Path, device, steps: int,
                     stop_at=None, **kw):
    """An engine for ``steps`` train steps on synthetic data (no sweep)
    and the list that will hold the losses of every step it takes."""
    from vfd_gan_tpu_torch.cli.trainer import build_iterators

    cfg = _full_width_cfg(model, root, synthetic_data=steps, freq=10 ** 6,
                          **kw)
    engine = _engine_cls(model)(cfg, *build_iterators(cfg, device),
                                device=device)
    losses: list = []
    _recording(engine, losses, stop_at)
    return engine, losses


RESUME_STEPS, RESUME_STOP = 6, 3


def phase_resume(tmp: Path, device) -> None:
    from vfd_gan_tpu_torch.train.checkpoints import (
        AsyncSaver,
        host_copy,
        restore_checkpoint,
        save_checkpoint,
    )

    for model in ("mygan", "clstm"):
        root = tmp / f"resume_{model}"
        whole, want = _recorded_engine(model, root / "a", device,
                                       RESUME_STEPS)
        again, twice = _recorded_engine(model, root / "a2", device,
                                        RESUME_STEPS)
        whole.train()
        again.train()
        repeat = want == twice and _tree_equal(
            host_copy(whole._ckpt_tree()), host_copy(again._ckpt_tree()))
        whole.close()
        again.close()
        del whole, again
        before = signal.getsignal(signal.SIGTERM)
        first, head = _recorded_engine(model, root / "b1", device,
                                       RESUME_STEPS, stop_at=RESUME_STOP,
                                       autosave_every=2)
        first.train()
        first.close()
        latest = Path(first.dirs.weights) / "latest.pt"
        check(first.global_step == RESUME_STOP and latest.is_file(),
              f"resume-{model}: SIGTERM after step {RESUME_STOP} parked "
              f"{latest}")
        check(signal.getsignal(signal.SIGTERM) == before,
              "the signal handlers are restored")
        saved = restore_checkpoint(str(latest))
        check(_tree_equal(saved, host_copy(first._ckpt_tree())),
              f"resume-{model}: latest.pt holds the parked state")
        size = latest.stat().st_size
        del first

        second, tail = _recorded_engine(model, root / "b2", device,
                                        RESUME_STEPS, resume=str(latest))
        check(_tree_equal(host_copy(second._ckpt_tree()), saved),
              f"resume-{model}: the restored state (parameters, BN buffers, "
              "Adam moments and steps, generator, cursor, best scores) "
              "equals the saved state bit for bit")
        check((second.epoch, second.batch_in_epoch, second.global_step)
              == (0, RESUME_STOP, RESUME_STOP) and not tail,
              "the cursor is (epoch, k)")
        for net in second._nets().values():
            check(all(p.device.type == "cuda"
                      for p in net.module.parameters()),
                  "restored parameters lie on the card")
            state = net.optimizer.state_dict()["state"]
            check(all(s["exp_avg"].device.type == "cuda"
                      for s in state.values()), "and the Adam moments too")
        second.train()
        check(second.global_step == RESUME_STEPS
              and len(tail) == RESUME_STEPS - RESUME_STOP,
              f"resume-{model}: ran on to step {RESUME_STEPS}")
        if repeat:
            check(head == want[:RESUME_STOP],
                  "the stopped run's steps are the unbroken run's")
        # Where two unbroken runs repeat bit for bit, the resumed run must
        # equal them bit for bit too.  Where they do not (cuDNN's weight
        # gradients and the trilinear upsample's backward sum with atomics,
        # and a GAN step amplifies the difference: two unbroken MyGAN runs
        # are 4-6e-4 apart, relative, at step 6), the resumed run's losses
        # are held to 1e-5 + 1% of the unbroken run's.
        def rel_diff(a, b):
            return abs(a - b) / (abs(b) + 1e-3)

        spread = max(rel_diff(a[k], b[k]) for a, b in zip(twice, want)
                     for k in b)
        worst = worst_rel = 0.0
        for got, ref in zip(tail, want[RESUME_STOP:]):
            for k, v in ref.items():
                diff = abs(got[k] - v)
                check(np.isfinite(got[k]) and (
                    diff == 0.0 if repeat else diff <= 1e-5 + 1e-2 * abs(v)),
                    f"resume-{model} {k}: resumed {got[k]} vs unbroken {v} "
                    f"(two unbroken runs bit-equal: {repeat}, apart by "
                    f"{spread:.3g} relative)")
                worst = max(worst, diff)
                worst_rel = max(worst_rel, rel_diff(got[k], v))
        exact = tail == want[RESUME_STOP:]

        # an autosave as the step loop sees it: synchronous, and the call
        # that hands the write to a thread
        path = str(root / "timed.pt")
        sync_ms, async_ms, write_ms = [], [], []
        saver = AsyncSaver()
        for _ in range(3):
            t0 = time.perf_counter()
            save_checkpoint(path, second._ckpt_tree())
            sync_ms.append(1e3 * (time.perf_counter() - t0))
            t0 = time.perf_counter()
            check(saver.save(path, second._ckpt_tree()), "async save taken")
            async_ms.append(1e3 * (time.perf_counter() - t0))
            saver.wait()
            write_ms.append(1e3 * (time.perf_counter() - t0))
        second.close()
        say(f"resume-{model}",
            f"b{BATCH} full width, {RESUME_STEPS} steps, SIGTERM after step "
            f"{RESUME_STOP}: latest.pt {size / 1e6:.1f} MB, restored bit for "
            f"bit at cursor (0, {RESUME_STOP}); resumed losses vs the "
            f"unbroken run's max-abs {worst:.3g}, relative {worst_rel:.3g} "
            f"(held to {'equality' if repeat else '1e-5 + 1%'}), bit-equal: "
            f"{exact}; two unbroken runs bit-equal (losses and final "
            f"state): {repeat}, their losses apart by {spread:.3g} relative "
            f"at most; autosave seen by the "
            f"loop: synchronous {statistics.median(sync_ms):.1f} ms, "
            f"asynchronous {statistics.median(async_ms):.1f} ms (its write "
            f"done after {statistics.median(write_ms):.1f} ms), medians of 3")


def phase_sweep_options(tmp: Path, device) -> None:
    from vfd_gan_tpu_torch.ops.flow_fused import flow_refine_fused_cuda
    from vfd_gan_tpu_torch.train.gan_engine import MyGanEngine

    def engine_for(name, **kw):
        cfg = _full_width_cfg("mygan", tmp / f"sweep_{name}", **kw)
        return MyGanEngine(cfg, *_memory_iterators(cfg, BATCH, 2 * BATCH),
                           device=device)

    def sweep(engine):
        _reset_counts()
        t0 = time.perf_counter()
        scores = engine.test()
        torch.cuda.synchronize()
        return (scores, flow_refine_fused_cuda.fields,
                flow_refine_fused_cuda.launches,
                1e3 * (time.perf_counter() - t0))

    cached, plain = engine_for("cached", cache_gt_flow=True), engine_for(
        "plain")
    sweep(plain)                                         # warm
    (s1, f1, l1, ms1), (s2, f2, l2, ms2) = sweep(cached), sweep(cached)
    p1, pf, _, pms = sweep(plain)
    check(f1 == pf == 2 * 3 * FIELDS and f2 * 2 == f1 and l1 == l2,
          f"--cache_gt_flow: fields {f1} then {f2} (uncached {pf})")
    check(len(cached._gt_flow_cache) == 2 * BATCH, "every test clip cached")
    check(s1 == s2 == p1 and all(np.isfinite(s1)),
          f"cached scores {s1} {s2} == uncached {p1}")
    say("sweep-cache", f"--cache_gt_flow, two sweeps of 2 batches: fused "
                       f"kernel fields {f1} then {f2} in {l1} launches each "
                       f"(uncached {pf}); roc/pr/f1 {s2} equal to the "
                       f"uncached sweep's; sweep {ms1:.0f} ms then "
                       f"{ms2:.0f} ms, uncached {pms:.0f} ms (host scoring "
                       "included)")
    cached.close()
    plain.close()

    def stats(module):
        return {k: v.clone() for k, v in module.state_dict().items()
                if "running" in k}

    quirk = engine_for("quirk", ref_mode_quirks=True)
    g0, d0 = stats(quirk.netg), stats(quirk.netd)
    scores, _, _, _ = sweep(quirk)
    moved = [sum(not torch.equal(v, old[k]) for k, v in stats(m).items())
             for m, old in ((quirk.netg, g0), (quirk.netd, d0))]
    check(moved[0] == len(g0) and moved[1] == len(d0),
          f"--ref_mode_quirks: every BN statistic moved: {moved}")
    check(quirk.netg.training and quirk.netd.training
          and len(quirk._gt_flow_cache) == 0 and all(np.isfinite(scores)),
          "--ref_mode_quirks: train mode, no cache, finite scores")
    say("sweep-quirks", f"--ref_mode_quirks sweep: G and D in train mode, "
                        f"{moved[0]} of G's and {moved[1]} of D's BN running "
                        f"statistics moved; roc/pr/f1 {scores}")
    quirk.close()
    phase_step_parity(tmp, ae=True)


def phase_tensorboard(tmp: Path) -> None:
    from vfd_gan_tpu_torch.cli.trainer import main as train_main

    engine = train_main(
        ["--model", "clstm", "--batchsize", str(BATCH), "--nfr", str(NFR),
         "--isize", str(ISIZE), "--compute_dtype", "float32",
         "--synthetic_data", "2", "--synthetic_test_batches", "1", "--ep",
         "1", "--freq", "2", "--device", "cuda", "--tensorboard",
         "--result_root", str(tmp / "runs_tb")])
    events = sorted(Path(engine.dirs.runs).rglob("events.out.tfevents.*"))
    lines = (Path(engine.dirs.root) / "metrics.jsonl").read_text().splitlines()
    check(len(lines) == 1, "metrics.jsonl is written either way")
    try:
        import tensorboard  # noqa: F401
        installed = True
    except ImportError:
        installed = False
    check(bool(events) == installed,
          f"an event file in runs/ exactly where tensorboard is installed "
          f"({installed}): {events}")
    what = "existed" if installed else \
        "did not exist (the tensorboard package is not installed)"
    say("tensorboard", f"trainer run with --tensorboard: a writer {what}; "
                       f"{len(events)} event files under runs/ "
                       f"({sum(e.stat().st_size for e in events)} bytes); "
                       f"video panels (moviepy) "
                       f"{'on' if engine.summary.videos else 'off'}; "
                       f"metrics.jsonl {len(lines)} line")


# the new single-card training options at the reference size: (tag, model,
# dtype (None: the default command line, bf16), batch, extra flags)
ACCUM_RUNS = (
    ("mygan-f32-accum2", "mygan", "float32", BATCH, ["--accum", "2"]),
    ("mygan-f32-accum4", "mygan", "float32", BATCH, ["--accum", "4"]),
    ("mygan-bf16-accum2", "mygan", None, BATCH, ["--accum", "2"]),
    ("mygan-bf16-accum4", "mygan", None, BATCH, ["--accum", "4"]),
    ("mygan-bf16-b32-accum4", "mygan", None, 32, ["--accum", "4"]),
    ("clstm-f32-accum2", "clstm", "float32", BATCH, ["--accum", "2"]),
)
REMAT_RUNS = (
    ("remat", ["--remat"]),
    ("remat-dconv1,uconv1", ["--remat", "--remat_blocks", "dconv1,uconv1"]),
)
SHORT_STEPS = 4
# the clstm conv kernel's launches per microbatch of a train step: forward
# 3 x (1 + T), dx for all but the first layer's input half and each
# layer's first hidden half
CLSTM_CONV_PER_MICRO = 2 * 3 * (1 + NFR) - 4


def _short_run(tmp: Path, tag: str, model: str, dtype: str | None,
               extra: list, batch: int = BATCH, steps: int = SHORT_STEPS):
    """``cli.trainer.main`` at the reference width (MyGAN ngf = ndf = 32,
    flow_scale 0.5) for ``steps`` steps and a one-batch sweep, as one main
    path; returns the engine, the launch counts, those of the sweep, the
    step median after the first step (ms) and the peak memory (MiB) of
    the train steps (read as the sweep starts) and of the whole run."""
    flags, _ = _dtype_flags(dtype)
    widths = ["--ngf", "32", "--ndf", "32", "--flow_scale", "0.5"] \
        if model == "mygan" else []
    argv = ["--model", model, "--batchsize", str(batch), "--nfr", str(NFR),
            "--isize", str(ISIZE), *widths, *flags, *extra,
            "--synthetic_data", str(steps), "--synthetic_test_batches", "1",
            "--ep", "1", "--freq", str(steps), "--device", "cuda",
            "--no-tensorboard", "--result_root", str(tmp / f"runs_{tag}")]
    gc.collect()
    torch.cuda.empty_cache()
    cls = _engine_cls(model)
    test, train_peak = cls.test, []

    def peak_then_test(self):
        train_peak.append(torch.cuda.max_memory_allocated() / 2 ** 20)
        return test(self)

    cls.test = peak_then_test
    torch.cuda.reset_peak_memory_stats()
    try:
        engine, counts, sweep, _ = run_trainer(argv, cls)
    finally:
        cls.test = test
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    check(engine.global_step == steps and len(train_peak) == 1,
          f"{tag}: all train steps ran, then one sweep")
    check(all(np.isfinite(v) for v in engine.errors.values()),
          f"{tag}: finite losses {engine.errors}")
    median = 1e3 * statistics.median(engine.step_seconds[1:])
    return engine, counts, sweep, median, (train_peak[0], peak)


def _spread_close(what: str, got: dict, want: dict, again: dict,
                  factor: float = 4.0) -> str:
    """``got`` within ``factor`` x the spread of two runs of the same thing
    (``want``, ``again``) plus 1e-5, by relative L2 distance, the median
    tensor's and the whole set's (``tools/step_reference.within_spread``);
    returns the readings."""
    from vfd_gan_tpu_torch.tools.step_reference import within_spread

    dist, spread, ok = within_spread(got, want, again, factor)
    check(ok, f"{what}: {dist} within {factor:g} x the spread {spread} + "
              f"1e-5")
    return (f"{what} median {dist[0]:.3g}, whole {dist[1]:.3g} (two "
            f"reference runs: {spread[0]:.3g}, {spread[1]:.3g})")


def _buffers_as_plain(what: str, got: dict, want: dict, again: dict) -> str:
    """Every buffer of ``got`` equal to ``want``'s where two plain runs
    (``want``, ``again``) are equal, else within 4 x their spread;
    ``num_batches_tracked`` always equal."""
    unequal = 0
    for k, v in want.items():
        if "running" not in k and not k.endswith("num_batches_tracked"):
            continue
        if k.endswith("num_batches_tracked") or torch.equal(v, again[k]):
            check(torch.equal(got[k], v), f"{what} buffer {k} equal")
        else:
            unequal += 1
            check((got[k] - v).abs().max() <= 4 * (again[k] - v).abs().max(),
                  f"{what} buffer {k} within the plain runs' spread")
    return f"{what} buffers equal ({unequal} within the spread)"


def _step_inputs(device, b: int = BATCH):
    rng = np.random.default_rng(21)
    data = rng.uniform(-1, 1, (b, NFR, ISIZE, ISIZE, 3)).astype(np.float32)
    gt = (rng.uniform(size=(b, NFR, ISIZE, ISIZE, 1)) > 0.9).astype(
        np.float32)
    return (torch.from_numpy(data).to(device),
            torch.from_numpy(gt).to(device))


def _cpu_state(module) -> dict:
    return {k: v.detach().to("cpu", copy=True)
            for k, v in module.state_dict().items()}


def phase_accum_reference(tmp: Path, device) -> str:
    """One ``--accum 2`` MyGAN step at the reference size (float32, the
    fused flow per microbatch, dropout on) against the same step by hand,
    twice, from one state, with SGD(1.0) so that each update is the
    averaged gradient: the engine's updates within the spread of the two
    hand-made ones."""
    from vfd_gan_tpu_torch.tools.step_reference import manual_gan_accum
    from vfd_gan_tpu_torch.train.gan_engine import MyGanEngine

    cfg = _full_width_cfg("mygan", tmp / "accum_ref", accum=2)
    data, gt = _step_inputs(device)
    before, steps, stats = None, [], []
    for i in range(3):
        eng = MyGanEngine(cfg, None, None, device=device)
        if before is None:
            before = {n: _cpu_state(net.module)
                      for n, net in eng._nets().items()}
        for net in eng._nets().values():
            net.optimizer = torch.optim.SGD(net.module.parameters(), lr=1.0)
        drop = torch.Generator(device=device).manual_seed(3)
        if i == 0:
            eng._gan_core(data, gt, drop)
        else:
            manual_gan_accum(eng, data, gt, 2, drop)
        after = {n: _cpu_state(net.module) for n, net in eng._nets().items()}
        params = {n: [k for k, _ in net.module.named_parameters()]
                  for n, net in eng._nets().items()}
        steps.append({f"{n}.{k}": after[n][k] - before[n][k]
                      for n in after for k in params[n]
                      if not k.endswith(("spatial_conv.bias",
                                         "temporal_conv.bias"))})
        stats.append({f"{n}.{k}": v for n in after
                      for k, v in after[n].items()})
        del eng
    return "; ".join((_spread_close("updates", *steps),
                      _buffers_as_plain("G and D", *stats)))


def phase_accum(tmp: Path, device, base: dict) -> dict:
    """The ``--accum`` runs (``ACCUM_RUNS``), each its own main path: one
    augment launch per step, 3 x k fused-flow launches per MyGAN step, k x
    the clstm step's conv launches; step median and peak memory printed
    beside the accum-1 run's (``base``: tag -> (ms, MiB)); then one step
    against its manual reference.  Returns the counts by run."""
    out = {}
    for tag, model, dtype, batch, extra in ACCUM_RUNS:
        k = int(extra[-1])
        engine, counts, sweep, ms, peak = _short_run(tmp, tag, model, dtype,
                                                     extra, batch)
        steps = engine.global_step
        train = {key: n - sweep.get(key, 0) for key, n in counts.items()}
        check(train["augment_gather"] == steps,
              f"{tag}: one augment launch per step: {counts}")
        if model == "mygan":
            check(train["flow_fused"] == 3 * k * steps,
                  f"{tag}: 3 x {k} fused launches per step: {train}")
        else:
            conv = "conv3x3" if dtype == "float32" else "conv3x3_bf16"
            check(train[conv] == k * CLSTM_CONV_PER_MICRO * steps,
                  f"{tag}: {k} x {CLSTM_CONV_PER_MICRO} conv launches per "
                  f"step: {train}")
        ref = base.get(f"{model}-{'f32' if dtype else 'bf16'}")
        beside = (f"; accum 1 at b{BATCH}: {ref[0]:.1f} ms, {ref[1]:.0f} "
                  "MiB with its sweep" if ref else "")
        say("accum", f"trainer.main --model {model} b{batch} T{NFR} "
                     f"{ISIZE}^2 {dtype or 'bfloat16 (default)'} "
                     f"{' '.join(extra)}: step median {ms:.1f} ms "
                     f"({1e3 * batch / ms:.1f} clips/s), peak memory "
                     f"{peak[0]:.0f} MiB in the train steps, {peak[1]:.0f} "
                     f"with the sweep{beside}; launches per step "
                     + json.dumps({key: train[key] / steps for key in (
                         "augment_gather", "flow_fused", "conv3x3",
                         "conv3x3_bf16") if train[key]}))
        out[tag] = counts
        engine.close()
        del engine
    gc.collect()
    torch.cuda.empty_cache()
    say("accum", "one --accum 2 step (float32, b8) against the same step "
                 "by hand: " + phase_accum_reference(tmp, device))
    return out


def phase_remat(tmp: Path, device, base: dict) -> dict:
    """``--remat`` and ``--remat --remat_blocks dconv1,uconv1`` runs of
    MyGAN in float32 and bf16, step median and peak memory beside the
    plain run's; then one step of a remat engine against two plain ones
    from one state: G's gradient within the plain steps' spread and every
    BatchNorm buffer as plain's."""
    from vfd_gan_tpu_torch.train.gan_engine import MyGanEngine

    out = {}
    for dtype in ("float32", None):
        key = f"mygan-{'f32' if dtype else 'bf16'}"
        for tag, extra in REMAT_RUNS:
            engine, counts, _, ms, peak = _short_run(
                tmp, f"{key}-{tag}", "mygan", dtype, extra)
            check(engine.netg.remat and counts["flow_fused"] > 0,
                  f"{tag}: the Generator rematerializes its blocks")
            ref = base.get(key)
            beside = (f"; plain: {ref[0]:.1f} ms, {ref[1]:.0f} MiB with "
                      "its sweep" if ref else "")
            say("remat", f"trainer.main --model mygan b{BATCH} "
                         f"{dtype or 'bfloat16 (default)'} "
                         f"{' '.join(extra)}: step median {ms:.1f} ms, peak "
                         f"memory {peak[0]:.0f} MiB in the train steps, "
                         f"{peak[1]:.0f} with the sweep{beside}")
            out[f"{key} {' '.join(extra)}"] = counts
            engine.close()
            del engine
        gc.collect()
        torch.cuda.empty_cache()
        cfg = _full_width_cfg("mygan", tmp / "remat_ref")
        cfg.compute_dtype = dtype or "bfloat16"
        data, gt = _step_inputs(device)
        grads, stats = [], []
        for remat in (False, False, True):
            cfg.remat = remat
            eng = MyGanEngine(cfg, None, None, device=device)
            eng._gan_core(data, gt, torch.Generator(device=device)
                          .manual_seed(3))
            grads.append({k: p.grad.detach().to("cpu", copy=True)
                          for k, p in eng.netg.named_parameters()})
            stats.append({f"{n}.{k}": v for n, net in eng._nets().items()
                          for k, v in _cpu_state(net.module).items()})
            del eng
        say("remat", f"one step, {dtype or 'bfloat16'}, --remat against "
                     "plain: " + "; ".join((
                         _spread_close("G's gradient", grads[2], *grads[:2]),
                         _buffers_as_plain("G and D", stats[2],
                                           *stats[:2]))))
    return out


EVAL_BATCH = 4


def phase_evaluate(tmp: Path, device, paths: dict) -> dict:
    """``cli.export_torch`` of a short MyGAN run's ``latest.pt`` (the pair
    loads strict=True), then ``cli.evaluate_models`` on that G and the
    seed-0 clstm, c2plus1d and xception files, over clips held in memory
    (b4, T16, 128^2; no cv2 to decode with here): raw sigmoid scores, so
    no opening launch; per model AUC, EER, F1 and seconds, each against
    the same call on the CPU within 1e-4."""
    from vfd_gan_tpu_torch.cli import evaluate_models, export_torch
    from vfd_gan_tpu_torch.models.mygan import DualDisc, Generator
    from vfd_gan_tpu_torch.utils.checkpoint import load_state_dict

    engine, _, _, _, _ = _short_run(tmp, "export", "mygan", "float32",
                                    ["--autosave_every", "2"], steps=2)
    latest = Path(engine.dirs.weights) / "latest.pt"
    engine.close()
    del engine
    out_dir = tmp / "mygan_export"                 # "mygan": the dispatch
    written = export_torch.main(["--ckpt", str(latest), "--out",
                                 str(out_dir)])
    g_pth, d_pth = (out_dir / f"latest_{n}.pth" for n in ("netG", "netD"))
    check([Path(p) for p, _ in written] == [g_pth, d_pth],
          f"export wrote the pair: {written}")
    Generator(32).load_state_dict(load_state_dict(str(g_pth)), strict=True)
    DualDisc(32, NFR, ISIZE).load_state_dict(load_state_dict(str(d_pth)),
                                             strict=True)
    clips = MemoryClips(EVAL_BATCH, NFR, ISIZE, seed=12)
    batch = {k: np.stack([clips[i][j] for i in range(EVAL_BATCH)])
             for j, k in enumerate(("data", "real", "mask"))}
    lines, counts_by = [], {}
    for ckpt in (g_pth, paths["clstm"], paths["c2plus1d"],
                 paths["xception"]):
        _reset_counts()                          # the evaluate path starts
        t0 = time.perf_counter()
        got = evaluate_models.evaluate_checkpoints(
            [str(ckpt)], [batch], "roc", str(tmp / "eval_cuda"), device)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = _counts()                       # ... and ends
        t0 = time.perf_counter()
        want = evaluate_models.evaluate_checkpoints(
            [str(ckpt)], [batch], "roc", str(tmp / "eval_cpu"),
            torch.device("cpu"))
        cpu_secs = time.perf_counter() - t0
        (name, r), = got.items()
        check(list(want) == [name], f"{ckpt.name}: one model, {name}")
        for key in ("auc", "eer", "f1"):
            check(np.isfinite(r[key]) and abs(r[key] - want[name][key])
                  <= 1e-4, f"{name} {key}: cuda {r[key]} vs cpu "
                           f"{want[name][key]}")
        check(counts["morphology_open"] == 0,
              f"{name}: raw scores, no opening: {counts}")
        counts_by[name] = counts
        lines.append(f"{name} ({ckpt.name}): AUC {r['auc']:.6f} EER "
                     f"{r['eer']:.6f} F1 {r['f1']:.6f} in {secs:.2f} s "
                     f"(CPU {cpu_secs:.2f} s, within 1e-4)")
    check(counts_by["ConvLSTM"]["conv3x3"] > 0,
          "the ConvLSTM's forward launched the conv3x3 kernel")
    say("evaluate", f"export_torch {latest.name} -> {g_pth.name}, "
                    f"{d_pth.name} (strict loads); evaluate_models, "
                    f"b{EVAL_BATCH} T{NFR} {ISIZE}^2 clips in memory: "
                    + "; ".join(lines))
    return counts_by


def phase_host_only(tmp: Path, device) -> dict:
    """``--host_flow`` and ``cli.frames`` need cv2.  With the import made to
    fail, ``--host_flow`` must exit when the engine is built, naming cv2 and
    the flag.  Where cv2 imports, a short ``--host_flow`` MyGAN run (no
    fused-flow launch in its train steps: the flow is OpenCV's on the host)
    and ``cli.frames`` on a synthetic mp4 tree; where it does not, that is
    said.  Returns the run's launch counts (empty without cv2)."""
    import importlib.util

    from vfd_gan_tpu_torch.cli.trainer import build_engine

    argv = ["--model", "mygan", "--batchsize", "2", "--nfr", str(NFR),
            "--isize", "64", "--ngf", "8", "--ndf", "8", "--host_flow",
            "--synthetic_data", "1", "--device", "cuda", "--no-tensorboard",
            "--result_root", str(tmp / "runs_host_flow")]
    saved = sys.modules.get("cv2")
    sys.modules["cv2"] = None                    # import cv2 now fails
    try:
        build_engine(argv)
    except SystemExit as e:
        msg = str(e)
    else:
        raise RuntimeError("check failed: --host_flow built an engine "
                           "without cv2")
    finally:
        if saved is None:
            del sys.modules["cv2"]
        else:
            sys.modules["cv2"] = saved
    check("cv2" in msg and "--host_flow" in msg,
          f"--host_flow names cv2 and the flag: {msg}")
    say("host-only", f"without cv2, --host_flow exits when the engine is "
                     f"built: {msg}")
    if importlib.util.find_spec("cv2") is None:
        say("host-only", "--host_flow and cli.frames need cv2, which this "
                         "machine lacks: not run here (the CPU tests hold "
                         "them to JAX)")
        return {}
    from vfd_gan_tpu_torch.cli import frames
    from vfd_gan_tpu_torch.data.synthetic import make_dataset

    engine, counts, sweep, ms, _ = _short_run(tmp, "host-flow", "mygan",
                                              "float32", ["--host_flow"],
                                              steps=2)
    check(counts["flow_fused"] == counts["flow_warp"] == 0
          and counts["augment_gather"] == 2,
          f"--host_flow: no flow kernel, one augment launch per step: "
          f"{counts}")
    engine.close()
    make_dataset(str(tmp / "mp4"), n_train=1, n_test=1, frames=16, size=64)
    t0 = time.perf_counter()
    frames.main(["--src", str(tmp / "mp4"), "--dst", str(tmp / "png")])
    pngs = len(list((tmp / "png").rglob("*.png")))
    check(pngs == 2 * 3 * 16, f"frames wrote every frame: {pngs} PNGs")
    say("host-only", f"cv2 imports here: trainer.main --model mygan b{BATCH} "
                     f"float32 --host_flow: step median {ms:.1f} ms, no flow "
                     f"kernel launched; cli.frames: {pngs} PNGs in "
                     f"{time.perf_counter() - t0:.2f} s")
    return counts


# -- the MoE block and quant/ ----------------------------------------------

MOE_EXPERTS, MOE_STEPS = 4, 4
# the MoE step's CUDA-vs-CPU size (the supervised parity's Xception size)
MOE_PARITY = (2, 8, 32, 1 / 16)
# the float32 step's gradient against the CPU's float64 step, where a
# control step must miss it: the gradient is ill-conditioned at this size
# (tests/test_torch_port_moe.py: the CPU's float32 step 0.9% from its
# float64 step, JAX's 19%)
MOE_F64_RTOL = 0.1
INT8_STEPS = 4
# an int8 forward on the card against the same int8 model on the CPU (one
# 64^2 clip), held site by site: int32 sums are exact on both (and
# int8_matmul is held bit for bit), but the float32 pools, upsamples,
# sigmoid and tanh round apart, and a value within an ulp of a .5 of the
# int8 grid then quantises to the neighbouring int8 at the next site.  So
# every site's int8 input must equal the CPU's but for elements one step
# apart: at the first site with any, at most INT8_FIRST_FLIPS of them; at
# any later
# site, where the flips before it have moved whole regions of its input,
# at most INT8_FLIP_SHARE (measured 1.2% in c2plus1d's last block).  The
# masks are reported.
INT8_FIRST_FLIPS, INT8_FLIP_SHARE, INT8_CPU_SIZE = 1e-3, 5e-2, 64
# the int8 forward against the BN-folded float forward: the CPU tests'
# bounds (tests/test_quant.py: max 0.12, mean 0.02), but for Xception at
# full width.  With these weights (its head scaled to unit logit spread)
# its 30 int8 sites in sequence put the mask 0.56-0.65 max / 0.054 mean
# from the float forward at 128^2; at full width the JAX package's own
# int8 Xception is as far from its float forward as the port's
# (tests/test_torch_port_quant.py, 32^2, T4: mean 0.0120 both), so this is
# the scheme's error at this depth.  Xception's mean is held to 0.1 and
# its max only reported.
INT8_FLOAT_MAX = {"mygan": 0.12, "clstm": 0.12, "c2plus1d": 0.12,
                  "xception": float("inf")}
INT8_FLOAT_MEAN = {"mygan": 0.02, "clstm": 0.02, "c2plus1d": 0.02,
                   "xception": 0.1}


def _moe_dispatch_line(cf: float = 2.0, width: int = 728) -> str:
    """The MoE layer's token count at the reference size and the bytes of
    its dispatch: JAX's one-hot ``(T, E, C)`` tensors against the port's
    ``(E, C, D)`` buffers, float32."""
    from vfd_gan_tpu_torch.parallel.moe import capacity

    t = BATCH * NFR * (ISIZE // 16) ** 2
    c = capacity(t, MOE_EXPERTS, cf)
    dense = t * MOE_EXPERTS * c * 4
    ours = 2 * MOE_EXPERTS * c * width * 4
    return (f"T {t} tokens at width {width}, E {MOE_EXPERTS}, capacity "
            f"{c}: a one-hot (T, E, C) dispatch tensor would hold "
            f"{dense / 2 ** 20:.0f} MiB; the port's gather/scatter buffers "
            f"(E, C, D) in and out hold {ours / 2 ** 20:.1f} MiB")


def phase_moe_parity(tmp: Path) -> None:
    """One ``--moe_experts 4`` Xception step on the card and on the CPU at
    a small size, float32, from the same seeded weights and the same
    augmented clip (dropout off).  The tokens' expert choices are read on
    both devices; where any differs the card's step is run again with the
    CPU's choices fed in (``MoEMlp.choice``) and that one is held.  Held:
    the loss 1e-5, parameters within Adam's first-step envelope (2.5 lr),
    BN statistics 1e-5, and the gradient (Adam's first moment) within
    ``MOE_F64_RTOL`` of the CPU's float64 step (median tensor and whole,
    relative L2), which the card's step on the clip reversed in time and
    mirrored must miss."""
    from vfd_gan_tpu_torch.config import Config
    from vfd_gan_tpu_torch.ops.augment import (
        _src_coords,
        augment_gather,
        staging_size,
    )
    from vfd_gan_tpu_torch.parallel.moe import capacity, route
    from vfd_gan_tpu_torch.train.state import relative_distances
    from vfd_gan_tpu_torch.train.supervised_engine import SupervisedEngine

    b, t, isize, xwidth = MOE_PARITY
    cfg = Config(model="xception", batchsize=b, nfr=t, isize=isize, ep=1,
                 compute_dtype="float32", tensorboard=False,
                 result_root=str(tmp), xwidth=xwidth,
                 moe_experts=MOE_EXPERTS)
    s = staging_size(isize)
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, (b, t, s, s, 3), dtype=np.uint8)
    mask = np.zeros((b, t, s, s, 1), np.uint8)
    mask[:, :, 4:s - 4, 5:s - 6] = 255
    draws = (np.linspace(-0.17, 0.15, b).astype(np.float32),
             np.arange(b) % 2, np.ones(b, np.int64), np.arange(b) % 2 == 0)
    src_x, src_y = (c.contiguous() for c in _src_coords(
        *(torch.from_numpy(np.asarray(v)) for v in draws), s, isize))

    def step(device, choice=None, double=False, clip=data):
        eng = SupervisedEngine(cfg, None, None, device=device)
        for m in eng.model.modules():
            if hasattr(m, "drop_rate"):
                m.drop_rate = 0.0
        moe = eng.model.moe
        moe.choice = choice
        if double:
            eng.model.double()
            moe.dtype = torch.float64
            eng.net.optimizer = torch.optim.Adam(
                eng.model.parameters(), lr=cfg.lr, betas=(cfg.beta1, 0.999))
        seen = []

        def read_choice(m, args):
            # the routing moe_apply computes, from the weights before the
            # step
            x = args[0]
            tokens = x.permute(0, 2, 3, 4, 1).reshape(-1, x.shape[1])
            c = capacity(tokens.shape[0], MOE_EXPERTS, m.capacity_factor)
            seen.append(route(tokens.to(m.dtype) @ m.router, c)[1].cpu())

        hook = moe.register_forward_pre_hook(read_choice)
        batch = [torch.from_numpy(v).to(device) for v in (clip, clip, mask)]
        x, _, gt = augment_gather(*batch, src_x.to(device), src_y.to(device))
        loss = float(eng._step(x.double() if double else x,
                               gt)["loss/err/train"])
        hook.remove()
        return (loss, {k: v.cpu() for k, v in eng.model.state_dict().items()},
                {k: v.cpu() for k, v in eng.net.first_moments().items()},
                seen[0])

    l_cpu, sd_cpu, m_cpu, ch_cpu = step(torch.device("cpu"))
    cuda = torch.device("cuda")
    l_gpu, sd_gpu, m_gpu, ch_gpu = step(cuda)
    flips = int((ch_gpu != ch_cpu).sum())
    if flips:
        l_gpu, sd_gpu, m_gpu, _ = step(cuda, choice=ch_cpu.to(cuda))
    _, _, m_f64, _ = step(torch.device("cpu"), double=True)
    _, _, m_ctl, _ = step(cuda, clip=data[:, ::-1, :, ::-1].copy())
    check(np.isfinite(l_gpu) and abs(l_gpu - l_cpu) <= 1e-5,
          f"moe step loss: cuda {l_gpu} vs cpu {l_cpu}")
    worst_param = worst_stat = 0.0
    for k, v in sd_cpu.items():
        if k.endswith("num_batches_tracked"):
            continue
        d = (sd_gpu[k] - v).abs().max().item()
        if "running" in k:
            check(d <= 1e-5, f"moe BN stat {k}: {d}")
            worst_stat = max(worst_stat, d)
        else:
            check(d <= 2.5 * cfg.lr, f"moe param {k}: {d}")
            worst_param = max(worst_param, d)
    median, whole = relative_distances(m_gpu, m_f64)
    cpu_median, cpu_whole = relative_distances(m_cpu, m_f64)
    missed, _ = relative_distances(m_ctl, m_f64)
    check(median <= MOE_F64_RTOL and whole <= MOE_F64_RTOL < missed,
          f"moe gradient vs the CPU's float64 step: {median}, {whole}; "
          f"control {missed}")
    say("moe", f"CUDA vs CPU step, xception --moe_experts {MOE_EXPERTS} "
               f"b{b} T{t} {isize}^2 xwidth {xwidth:g} float32: "
               f"{flips} of {ch_cpu.numel()} tokens routed to another "
               f"expert on the card"
               f"{' (the step held with the CPU routing fed in)' if flips else ''}"
               f"; loss {abs(l_gpu - l_cpu):.3g} apart, params max "
               f"{worst_param:.3g} (<= 2.5 lr), BN stats {worst_stat:.3g}; "
               f"gradient vs the CPU's float64 step median {median:.3g}, "
               f"whole {whole:.3g} (<= {MOE_F64_RTOL}; the CPU's float32 "
               f"{cpu_median:.3g}, {cpu_whole:.3g}; the control's median "
               f"{missed:.3g})")


def phase_moe(tmp: Path) -> dict:
    """``--model xception --xwidth 1.0 --moe_experts 4`` at b8, T16, 128^2:
    4 steps and a one-batch sweep in float32 and on the default command
    line (bf16), each a main path (the augment kernel once per step, the
    opening kernel in the sweep); then the CUDA-vs-CPU step.  Returns the
    launch counts by run."""
    say("moe", _moe_dispatch_line())
    runs = {}
    for dtype in ("float32", None):
        gc.collect()
        torch.cuda.empty_cache()
        engine, counts, sweep, ms, peak = phase_supervised_train(
            tmp, "xception", dtype, steps=MOE_STEPS,
            extra=("--xwidth", "1.0", "--moe_experts", str(MOE_EXPERTS)),
            tag="-moe")
        aux = {k: float(v) for k, v in engine.model.moe.aux.items()}
        check(aux["load_balance_loss"] > 0 and 0 <= aux["dropped_frac"] < 1,
              f"moe aux {aux}")
        label = dtype or "bfloat16 (default)"
        say("moe", f"xception --moe_experts {MOE_EXPERTS} {label}: step "
                   f"median {ms:.1f} ms, {1e3 * BATCH / ms:.1f} clips/s, "
                   f"peak {peak:.0f} MiB; last sweep batch's aux "
                   f"{json.dumps(aux)}; augment launches "
                   f"{counts['augment_gather']} over {MOE_STEPS} steps, "
                   f"opening {counts['morphology_open']} in the sweep")
        runs[f"xception --moe_experts {MOE_EXPERTS} {label}"] = counts
        del engine
    phase_moe_parity(tmp)
    return runs


def _int8_families():
    from vfd_gan_tpu_torch.quant import qclstm, qmygan, qstcnn, qxception

    return {"mygan": (qmygan.fold_generator, qmygan._forward),
            "clstm": (qclstm.fold_convlstm, qclstm._forward),
            "c2plus1d": (qstcnn.fold_autoencoder, qstcnn._forward),
            "xception": (qxception.fold_xception, qxception._forward)}


def _int8_gemm_bit_equal(q, x) -> int:
    """Run ``q`` on ``x`` with every ``int8_matmul`` of a new (M, K, N)
    shape held bit for bit against its plain version on the card (a
    float64 matmul); returns the number of shapes."""
    from vfd_gan_tpu_torch.ops import int8 as int8_ops

    gemm, seen = int8_ops.int8_matmul, set()

    def checked(a, b):
        out = gemm(a, b)
        shape = (a.shape[0], a.shape[1], b.shape[1])
        if shape not in seen:
            seen.add(shape)
            check(torch.equal(out, int8_ops.int8_matmul_plain(a, b)),
                  f"int8_matmul {shape} equals its plain version")
        return out

    # the wrapper's own count goes to the stand-in, off every main path
    checked.launches = 0
    int8_ops.int8_matmul = checked
    try:
        with torch.inference_mode():
            q(x)
    finally:
        int8_ops.int8_matmul = gemm
    return len(seen)


def _int8_inputs(q, x) -> list:
    """``q(x)`` and the int8 input of every conv site, on the host, in
    order."""
    from vfd_gan_tpu_torch.quant import qmygan

    quant, seen = qmygan._quant, []

    def recording(v, scale):
        out = quant(v, scale)
        seen.append(out.cpu())
        return out

    qmygan._quant = recording
    try:
        with torch.inference_mode():
            out = q(x).cpu()
    finally:
        qmygan._quant = quant
    return out, seen


def _int8_infer_mp4(tmp: Path, path: Path) -> str:
    """``cli.infer.main --quant int8`` on a synthetic 2-clip mp4 (cv2),
    or why not."""
    from vfd_gan_tpu_torch.cli import infer
    from vfd_gan_tpu_torch.data.video_io import write_video

    try:
        import cv2  # noqa: F401
    except ImportError:
        return "cv2 does not import here: infer.main not run"
    frames = np.random.default_rng(8).integers(
        0, 256, (2 * NFR, ISIZE, ISIZE, 3), dtype=np.uint8)
    video = tmp / "int8_infer" / "clip.mp4"
    write_video(str(video), frames)
    out = tmp / "int8_infer" / "out"
    before = _counts()
    infer.main(["--video", str(video), "--ckpt", str(path), "--out",
                str(out), "--quant", "int8", "--device", "cuda"])
    opened = _counts()["morphology_open"] - before["morphology_open"]
    check(opened == 2, f"infer --quant int8 opened each of 2 clips: {opened}")
    check(all((out / f).exists() for f in ("mask.mp4", "overlay.mp4",
                                           "scores.csv")), "infer outputs")
    return "infer.main --quant int8 on a 2-clip mp4: 2 opening launches"


def phase_int8_serve(tmp: Path, paths: dict, f32_ms: dict,
                     bf16_ms: dict) -> dict:
    """``--quant int8`` serving of the four families at full width, one
    main path (counts set to 0 before, read after): each seed-0 checkpoint
    loaded and calibrated on 8 synthetic clips (``build_int8_serving``),
    ``predict_clips`` on 8 uint8 clips (one opening launch each), one HTTP
    request through ``serve --quant int8`` (MyGAN) and ``infer.main
    --quant int8`` on an mp4 (MyGAN).  Then, off the path: every
    ``int8_matmul`` shape of each forward bit-equal to its plain version,
    the int8 forward against the CPU's and against the BN-folded float
    forward, and the b8 int8 forward's time and peak memory beside the
    float32 and bf16 forwards'."""
    from vfd_gan_tpu_torch.cli.infer import _load, predict_clips
    from vfd_gan_tpu_torch.ops.image import to_channel_first
    from vfd_gan_tpu_torch.quant import build_int8_serving
    from vfd_gan_tpu_torch.quant.qmygan import Convs

    frames = np.random.default_rng(3).integers(
        0, 256, (BATCH, NFR, ISIZE, ISIZE, 3), dtype=np.uint8)
    models, calib_s = {}, {}
    _reset_counts()                              # the int8 path starts
    for family, path in paths.items():
        model, _ = _load(str(path), torch.device("cuda"))
        t0 = time.perf_counter()
        models[family] = build_int8_serving(model, isize=ISIZE, nfr=NFR,
                                            calib_clips=8)
        torch.cuda.synchronize()
        calib_s[family] = time.perf_counter() - t0
        before = _counts()["morphology_open"]
        pred, opened, scores = predict_clips(models[family], frames, "th")
        check(_counts()["morphology_open"] - before == 1,
              f"{family} int8 predict_clips opened once")
        check(bool(torch.isfinite(pred).all()) and pred.shape == (
            BATCH, NFR, ISIZE, ISIZE, 1), f"{family} int8 prediction")
        del model
    with _serving(paths["mygan"], extra=("--quant", "int8")) as (srv, base,
                                                                 _):
        check(srv.name.endswith("[int8]"), f"served name {srv.name}")
        one = np.random.default_rng(4).uniform(
            -1, 1, (1, NFR, ISIZE, ISIZE, 3)).astype(np.float32)
        served_err = _served_vs_direct(base, srv.model, one)
    mp4 = _int8_infer_mp4(tmp, paths["mygan"])
    counts = _counts()                           # ... and ends
    check(counts["int8_matmul"] > 0, "the int8 path ran the int8 GEMM")
    say("int8-serve", f"four families calibrated (8 clips each: "
                      + ", ".join(f"{k} {v:.1f} s" for k, v in
                                  calib_s.items())
                      + f") and served; one HTTP request through serve "
                        f"--quant int8 ({served_err:.3g} from the direct "
                        f"forward); {mp4}; launches {json.dumps(counts)}")

    x1 = torch.rand((1, 3, NFR, ISIZE, ISIZE), device="cuda") * 2 - 1
    small = (x1[:, :, :, :INT8_CPU_SIZE, :INT8_CPU_SIZE]).contiguous()
    x8 = torch.rand((BATCH, 3, NFR, ISIZE, ISIZE), device="cuda") * 2 - 1
    for family, q in models.items():
        shapes = _int8_gemm_bit_equal(q, x8)
        fold, forward = _int8_families()[family]
        model, _ = _load(str(paths[family]), torch.device("cuda"))
        sd = {k: v for k, v in model.state_dict().items()
              if v.is_floating_point()}
        with torch.inference_mode():
            got = q(x1)
            pack = fold(sd)
            want = forward(pack, x1, Convs(pack))
            err = (got - want).abs()
        cpu_q = copy.deepcopy(q).to("cpu")
        t0 = time.perf_counter()
        on_cpu, cpu_sites = _int8_inputs(cpu_q, small.cpu())
        cpu_s = time.perf_counter() - t0
        on_gpu, gpu_sites = _int8_inputs(q, small)
        cpu_err = (on_gpu - on_cpu).abs()
        del model, cpu_q
        check(err.max().item() < INT8_FLOAT_MAX[family]
              and err.mean().item() < INT8_FLOAT_MEAN[family],
              f"{family} int8 vs folded float max {err.max().item()}, mean "
              f"{err.mean().item()}")
        check(len(gpu_sites) == len(cpu_sites) > 0, f"{family} int8 sites")
        flips, first = [], None
        for i, (a, b) in enumerate(zip(gpu_sites, cpu_sites)):
            d = (a.int() - b.int()).abs()
            check(d.max().item() <= 1, f"{family} int8 site {i} input "
                                       f"off by {d.max().item()}")
            flips.append(d.float().mean().item())
            if first is None and flips[-1]:
                first = i
        check(max(flips) <= INT8_FLIP_SHARE and (
            first is None or flips[first] <= INT8_FIRST_FLIPS),
            f"{family} int8 inputs flipped: {flips}")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with torch.inference_mode():
            ms = event_ms(lambda: q(x8), reps=5, calls=1, warmup=2)
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        say("int8-serve",
            f"{family}: {shapes} int8_matmul shapes bit-equal to the plain "
            f"version; int8 vs BN-folded float forward (1 clip) max "
            f"{err.max().item():.3g}, mean {err.mean().item():.3g} (< "
            f"{INT8_FLOAT_MAX[family]}, {INT8_FLOAT_MEAN[family]}); CUDA vs "
            f"CPU (1 "
            f"clip at {INT8_CPU_SIZE}^2, the CPU {cpu_s:.1f} s): the int8 "
            f"inputs of {len(flips)} sites equal but for "
            f"{100 * max(flips):.3g}% of a site's elements one step apart "
            f"(<= {100 * INT8_FLIP_SHARE:g}%; the first at site {first}: "
            f"{100 * flips[first or 0]:.3g}%, <= "
            f"{100 * INT8_FIRST_FLIPS:g}%), the masks max "
            f"{cpu_err.max().item():.3g}, mean "
            f"{cpu_err.mean().item():.3g} apart; b{BATCH} forward int8 "
            f"{ms:.2f} ms (peak {peak:.0f} MiB above the inputs), float32 "
            f"{f32_ms[family]:.2f}, bf16 {bf16_ms[family]:.2f}")
    return {"int8 serve + infer": counts}


def phase_int8_disc(tmp: Path) -> dict:
    """MyGAN ``--int8_disc`` at the reference width, 4 steps and a
    one-batch sweep in float32 and on the default command line (bf16),
    each a main path; G's parameters after the float32 run against two
    plain float32 runs of the same seed and steps (within 4 x their
    spread: G's update has no D term, but cuDNN's atomics make card runs
    differ).  Returns the launch counts by run."""
    from vfd_gan_tpu_torch.models.layers import QConv3d

    runs, g = {}, {}
    for tag, dtype, extra in (("-int8disc", "float32", ("--int8_disc",)),
                              ("-int8disc", None, ("--int8_disc",)),
                              ("-plain1", "float32", ()),
                              ("-plain2", "float32", ())):
        gc.collect()
        torch.cuda.empty_cache()
        engine, counts, sweep, ms, peak = phase_train(
            tmp, dtype, steps=INT8_STEPS, sweep_batches=1, extra=extra,
            tag=tag)
        quant = [m for m in engine.netd.modules() if isinstance(m, QConv3d)]
        check(len(quant) == (18 if extra else 0),
              f"{tag}: {len(quant)} int8 discriminator convs")
        check((counts["int8_matmul"] > 0) == bool(extra),
              f"{tag}: int8 GEMM launches {counts['int8_matmul']}")
        if dtype == "float32":
            g[tag] = {k: v.detach().cpu().clone() for k, v in
                      engine.netg.state_dict().items()
                      if v.is_floating_point() and "running" not in k}
        if extra:
            label = dtype or "bfloat16 (default)"
            per_step = (counts["int8_matmul"]
                        - sweep["int8_matmul"]) / INT8_STEPS
            say("int8-disc", f"mygan --int8_disc {label}: step median "
                             f"{ms:.1f} ms, peak {peak:.0f} MiB, int8 GEMM "
                             f"launches {counts['int8_matmul']} "
                             f"({per_step:g} per step, "
                             f"{sweep['int8_matmul']} in the sweep)")
            runs[f"mygan --int8_disc {label}"] = counts
        del engine
    say("int8-disc", "G after 4 steps with --int8_disc against two plain "
                     "runs: " + _spread_close(
                         "G", g["-int8disc"], g["-plain1"], g["-plain2"]))
    return runs


# the dp phases: train steps per run
DP_STEPS = 3


def _dp_case(name: str, model: str, dp: int, **kw) -> dict:
    """A ``tools/dp_equivalence.py`` case on the card: ``DP_STEPS`` float32
    steps of ``model`` at the reference width, b8 global, no sweep;
    ``dp`` 1 is a plain run (outside any group)."""
    widths = ["--ngf", "32", "--ndf", "32", "--flow_scale", "0.5"] \
        if model == "mygan" else []
    argv = ["--model", model, "--batchsize", str(BATCH), "--nfr", str(NFR),
            "--isize", str(ISIZE), *widths, "--compute_dtype", "float32",
            "--synthetic_data", str(DP_STEPS), "--synthetic_test_batches",
            "1", "--ep", "1", "--freq", "1000"]
    return dict(kind="train", name=name, argv=argv, steps=DP_STEPS, dp=dp,
                device="cuda", **kw)


def _dp_close(what: str, got: dict, ref: dict, again: dict) -> str:
    """A dp run's parameters and running statistics against two runs of
    its reference: within ``parallel/verify.py``'s K (10) x their spread,
    plus 1e-5 (``_spread_close``).  Not 4 x: the dp path's kernels round
    otherwise than the reference's (the two-pass BatchNorm against
    cuDNN's; cuDNN's algorithms at 4 clips a rank against 8), and on
    MyGAN that lands 3.5-6.1 x the atomics' spread (PR 13's calls: 6.1e-5
    to 7.1e-5 against spreads of 1.0e-5 to 1.8e-5), which the 4 x rule
    fails whenever two plain runs happen to lie close."""
    from vfd_gan_tpu_torch.parallel.verify import K

    out = []
    for kind in ("params", "buffers"):
        keep = [k for k in ref[kind] if kind == "params" or "running" in k]
        out.append(_spread_close(
            f"{what} {kind}", {k: got[kind][k] for k in keep},
            {k: ref[kind][k] for k in keep},
            {k: again[kind][k] for k in keep}, factor=K))
    return "; ".join(out)


def _median_ms(result: dict) -> float:
    return statistics.median(result["step_ms"][1:])


def _collectives(result: dict) -> str:
    return ", ".join(f"{k} {ms:.2f} ms x{n:g}" for k, (ms, n) in sorted(
        result["collective_ms"].items()))


def phase_dp(tmp: Path) -> dict:
    """``--dp``: the trainer's ``--dp 0`` at the reference width on the
    default command line (bf16) resolves to dp 1; a one-rank NCCL group
    runs the dp code path (synced BatchNorms, the synced flow stretch,
    the sliced draws, the gradient all-reduce) for MyGAN and clstm, held
    against two plain runs of the same steps, and two gloo ranks on this
    one card run MyGAN and clstm at b8 (4 per rank), held against two
    dp-1 runs (``_dp_close``).  Returns the kernels' launches by run
    (rank 0's; rank 1's beside them)."""
    from vfd_gan_tpu_torch.cli import trainer
    from vfd_gan_tpu_torch.tools import dp_equivalence as eq

    t0 = time.perf_counter()
    argv = ["--model", "mygan", "--batchsize", str(BATCH), "--nfr", str(NFR),
            "--isize", str(ISIZE), "--ngf", "32", "--ndf", "32", "--dp", "0",
            "--synthetic_data", "2", "--synthetic_test_batches", "1", "--ep",
            "1", "--freq", "1000", "--device", "cuda", "--no-tensorboard",
            "--result_root", str(tmp / "dp0")]
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        engine = trainer.main(argv)
    check(engine is not None and engine.global_step == 2
          and f"--dp 0 -> dp {torch.cuda.device_count()}" in said.getvalue(),
          f"--dp 0 resolves to the visible cards and trains in this "
          f"process: {said.getvalue()[-300:]}")
    say("dp", f"trainer --dp 0 (bf16 default, b{BATCH} T{NFR} {ISIZE}^2): "
              + said.getvalue().split(" >> --dp 0")[1].split("\n")[0].strip())
    del engine

    # the plain runs in this process (no group: the plain path), the dp
    # runs in ranks of their own
    plain = {m: tuple(eq.run_train(_dp_case(f"{m}.plain{i}", m, 1),
                                   tmp / "dp_plain", solo=False)
                      for i in (1, 2)) for m in ("mygan", "clstm")}
    nccl, gloo = tmp / "dp_nccl", tmp / "dp_gloo"
    # dp 1 on the dp path, twice each (the second MyGAN run with its
    # all-reduces timed: the device synchronised around them, the same
    # arithmetic)
    eq.run([_dp_case("mygan.nccl1", "mygan", 2),
            _dp_case("mygan.nccl1.timed", "mygan", 2,
                     time_collectives=True),
            _dp_case("clstm.nccl1", "clstm", 2),
            _dp_case("clstm.nccl1.again", "clstm", 2)],
           nccl, world=1, backend="nccl", timeout=300)
    eq.run([_dp_case("mygan.gloo2", "mygan", 2),
            _dp_case("clstm.gloo2", "clstm", 2)],
           gloo, world=2, backend="gloo", timeout=300)

    def load(root, name):
        return torch.load(root / name, weights_only=False)

    dp1 = {"mygan": (load(nccl, "mygan.nccl1.rank0.pt"),
                     load(nccl, "mygan.nccl1.timed.rank0.pt")),
           "clstm": (load(nccl, "clstm.nccl1.rank0.pt"),
                     load(nccl, "clstm.nccl1.again.rank0.pt"))}
    # each run against its reference: the dp path at dp 1 against the
    # plain path, dp 2 against the dp path at dp 1
    runs = {"mygan nccl1": (dp1["mygan"][0], plain["mygan"]),
            "clstm nccl1": (dp1["clstm"][0], plain["clstm"]),
            "mygan gloo2": (load(gloo, "mygan.gloo2.rank0.pt"),
                            dp1["mygan"]),
            "clstm gloo2": (load(gloo, "clstm.gloo2.rank0.pt"),
                            dp1["clstm"])}
    rank1 = {"mygan gloo2": load(gloo, "mygan.gloo2.rank1.pt"),
             "clstm gloo2": load(gloo, "clstm.gloo2.rank1.pt")}
    launches = {}
    for what, (got, refs) in runs.items():
        model = what.split()[0]
        say("dp", _dp_close(what, got, *refs))
        for name, res in ((what, got), *(((f"{what} rank1", rank1[what]),)
                                         if what in rank1 else ())):
            counts = res["launches"]
            check(counts["augment_gather"] == DP_STEPS,
                  f"{name}: the augment kernel once per step: {counts}")
            check(model != "mygan" or counts["flow_fused"] == 3 * DP_STEPS,
                  f"{name}: the fused flow kernel 3 times per step: "
                  f"{counts}")
            check(model != "clstm" or counts["conv3x3"]
                  == DP_STEPS * CONV_LAUNCHES_PER_STEP,
                  f"{name}: the conv kernel per step as at dp 1: {counts}")
            launches[f"dp {name}"] = counts
        for r in (got, rank1.get(what)):
            if r is not None:
                check(all(np.isfinite(v) for step in r["losses"]
                          for v in step.values()), f"{what}: finite losses")
    for what in rank1:
        check(all(torch.equal(runs[what][0]["params"][k], v)
                  for k, v in rank1[what]["params"].items()),
              f"{what}: both ranks hold the same parameters bit for bit")
    timed = {"nccl1": load(nccl, "mygan.nccl1.timed.rank0.pt")}
    say("dp", "MyGAN float32 b8 step median ms (steps 2-3): plain "
              f"{_median_ms(plain['mygan'][0]):.1f} / "
              f"{_median_ms(plain['mygan'][1]):.1f}, dp path on one NCCL "
              f"rank {_median_ms(runs['mygan nccl1'][0]):.1f}, 2 gloo ranks "
              f"on one card {_median_ms(runs['mygan gloo2'][0]):.1f}; clstm "
              f"plain {_median_ms(plain['clstm'][0]):.1f}, one NCCL rank "
              f"{_median_ms(runs['clstm nccl1'][0]):.1f}, 2 gloo ranks "
              f"{_median_ms(runs['clstm gloo2'][0]):.1f}")
    for name, res in timed.items():
        say("dp", f"MyGAN {name}: all-reduce ms and count per step, by "
                  f"caller (device synchronised around each): "
                  f"{_collectives(res)}")
    say("dp", f"launches per rank under 2 gloo ranks: "
              f"{json.dumps({k: v for k, v in launches.items()})}; "
              f"{time.perf_counter() - t0:.1f} s")
    return launches


# the parallel phase: train steps per run, and its gloo ranks' join timeout
PAR_STEPS = 3
PAR_JOIN_S = 400
# its runs: model, the options on top of the reference width's b8 float32
PAR_RUNS = {"moe": ("xception", ["--moe_experts", str(MOE_EXPERTS)]),
            "int8_disc": ("mygan", ["--int8_disc"]),
            "pp": ("xception", ["--pp", "2", "--pp_micro", "2"]),
            "host_flow": ("mygan", ["--host_flow"])}


def _par_case(name: str, run: str, dp: int, **kw) -> dict:
    """A ``tools/dp_equivalence.py`` case of ``PAR_RUNS[run]`` on the card:
    ``PAR_STEPS`` float32 steps at the reference width, b8 global."""
    model, extra = PAR_RUNS[run]
    case = _dp_case(name, model, dp, **kw)
    case["argv"] += extra
    case["steps"] = PAR_STEPS
    return case


def _farthest(got: dict, want: dict, n: int = 4) -> str:
    """The ``n`` parameters and running statistics of ``got`` whose
    differences from ``want``'s are largest (L2), with their relative
    distances: where a whole-set distance comes from."""
    rows = []
    for kind in ("params", "buffers"):
        for k, w in want[kind].items():
            if kind == "params" or "running" in k:
                w = w.double()
                d = float((got[kind][k].double() - w).norm())
                rows.append((d, d / max(float(w.norm()), 1e-30), k))
    return ", ".join(f"{k} {d:.3g} ({r:.3g})"
                     for d, r, k in sorted(rows)[::-1][:n])


def _serve_replicas(paths: dict) -> None:
    """``serve --dp``'s replicas: the MyGAN generator served by two
    replicas on this one card against one replica, the same b8 batches;
    the scores within 1e-5, each server's b8 batch p50."""
    from vfd_gan_tpu_torch.cli.infer import _load
    from vfd_gan_tpu_torch.cli.serve import InferenceServer

    model, _ = _load(str(paths["mygan"]), torch.device("cuda"))
    kw = dict(isize=ISIZE, nfr=NFR, max_batch=BATCH, max_wait_ms=2.0)
    one = InferenceServer(model, "one", **kw)
    two = InferenceServer(model, "two", devices=["cuda:0", "cuda:0"], **kw)
    try:
        check(two.replicas[0] is model and two.replicas[1] is not model,
              "two replicas: the model and a copy")
        rng = np.random.default_rng(31)
        p50, worst = {}, 0.0
        for srv in (one, two, two, one):
            times = []
            for i in range(6):
                clips = rng.uniform(-1, 1, (BATCH, NFR, ISIZE, ISIZE, 3)
                                    ).astype(np.float32)
                t0 = time.perf_counter()
                got = srv.forward(clips)
                times.append(1e3 * (time.perf_counter() - t0))
                if srv is two:
                    want = one.forward(clips)
                    worst = max(worst, float(np.abs(
                        got[..., 0].reshape(BATCH, NFR, -1).mean(axis=2)
                        - want[..., 0].reshape(BATCH, NFR, -1).mean(axis=2)
                    ).max()))
            p50.setdefault(srv.name, []).append(
                statistics.median(times[1:]))
        check(worst <= 1e-5, f"serve --dp: two replicas' frame scores "
                             f"within 1e-5 of one replica's: {worst:.3g}")
        stats = two.stats()
        check(stats["replicas"] == 2, f"/stats counts 2 replicas: {stats}")
        say("parallel", f"serve MyGAN b{BATCH} float32, one replica vs two "
                        f"on cuda:0 (4 rows each): frame scores within "
                        f"{worst:.3g}; b8 forward p50 ms "
                        f"{json.dumps({k: [round(v, 3) for v in vs] for k, vs in p50.items()})}, "
                        f"replica forward ms {stats['replica_forward_ms']}")
    finally:
        one.close()
        two.close()


def phase_parallel(tmp: Path, paths: dict) -> dict:
    """``serve --dp`` with two replicas on this card; then two gloo ranks
    on this card at the reference width (b8 T16 128^2, float32, 4 clips a
    rank): xception ``--moe_experts 4 --dp 2``, MyGAN ``--int8_disc --dp
    2`` and xception ``--pp 2 --pp_micro 2``, each held within
    ``parallel/verify.py``'s K (10) x the spread of two one-process
    reference runs (``--pp``'s: the chain run per microbatch in this
    process) that differ by the BatchNorms' reduction order alone
    (``dp_equivalence.OneProcess``; two runs of one arithmetic on this
    card can be bit-equal, and a 3-step float32 Xception amplifies any
    reduction order's round-off); MyGAN ``--host_flow --dp 2`` where cv2
    imports (its flows of a b8 video bit-equal to the dp-1 flows, and a
    run).  Returns the kernels' launches by run (rank 0's and rank
    1's)."""
    from vfd_gan_tpu_torch.tools import dp_equivalence as eq

    t0 = time.perf_counter()
    _serve_replicas(paths)
    try:
        import cv2  # noqa: F401
        have_cv2 = True
    except ImportError:
        have_cv2 = False
    held = tuple(r for r in ("moe", "int8_disc", "pp") if r in PAR_RUNS)
    # the references in this process (--pp's: the chain per microbatch):
    # the plain run, and the same run with its BatchNorms in the dp path's
    # two-pass arithmetic, whose distance from it (the reduction order
    # alone) is the yardstick of the gate
    refs = {run: tuple(eq.run_train(_par_case(f"{run}.ref{i}", run, 1,
                                              **kw), tmp / "par_ref",
                                    solo=True)
                       for i, kw in ((1, {}), (2, {"arith": "dp"})))
            for run in held}
    gloo = tmp / "par_gloo"
    video = np.random.default_rng(5).uniform(
        -1, 1, (2 * BATCH, NFR, ISIZE, ISIZE, 3)).astype(np.float32)
    np.save(tmp / "par_video.npy", video)
    cases = [_par_case(f"{run}.gloo2", run, 2, time_collectives=True)
             for run in held]
    if have_cv2:
        cases += [_par_case("host_flow.gloo2", "host_flow", 2,
                            time_collectives=True),
                  dict(kind="flow", name="host_flow.flow", host=True,
                       video=str(tmp / "par_video.npy"), streams=2,
                       device="cuda")]
    eq.run(cases, gloo, world=2, backend="gloo", timeout=PAR_JOIN_S)

    def load(name, rank=0):
        return torch.load(gloo / f"{name}.rank{rank}.pt", weights_only=False)

    launches, lines = {}, []
    for run in held + (("host_flow",) if have_cv2 else ()):
        got, other = load(f"{run}.gloo2"), load(f"{run}.gloo2", 1)
        for kind in ("params", "buffers"):
            unequal = [k for k, v in got[kind].items()
                       if not torch.equal(v, other[kind][k])]
            check(not unequal, f"{run}: both ranks hold the same {kind} "
                               f"bit for bit: {unequal[:8]}")
        if run in refs:
            first = sorted(got["losses"][0])[0]
            say("parallel", f"{run}: {first} per step "
                            f"{[round(x[first], 6) for x in got['losses']]}"
                            f" (references "
                            f"{[round(x[first], 6) for x in refs[run][0]['losses']]}, "
                            f"{[round(x[first], 6) for x in refs[run][1]['losses']]});"
                            f" the tensors farthest from the reference: "
                            f"{_farthest(got, refs[run][0])}")
            say("parallel", _dp_close(f"{run} gloo2", got, *refs[run]))
        for r, res in enumerate((got, other)):
            check(all(np.isfinite(v) for step in res["losses"]
                      for v in step.values()), f"{run}: finite losses")
            counts = res["launches"]
            check(counts["augment_gather"] == PAR_STEPS,
                  f"{run}: the augment kernel once per step: {counts}")
            check(PAR_RUNS[run][0] != "mygan" or run == "host_flow"
                  or counts["flow_fused"] == 3 * PAR_STEPS,
                  f"{run}: the fused flow kernel 3 times per step: {counts}")
            launches[f"parallel {run}" + (" rank1" if r else "")] = counts
        if run == "moe":
            lines.append(f"moe: dropped fraction per step (global) "
                         f"{got['moe_dropped']}, one process "
                         f"{refs['moe'][0]['moe_dropped']}")
        ref = refs[run][0] if run in refs else {}
        ref_ms = _median_ms(ref) if ref else float("nan")
        lines.append(f"{run}: step median ms one process {ref_ms:.1f}, 2 "
                     f"gloo ranks {_median_ms(got):.1f}; peak MiB one "
                     f"process {ref.get('peak_mib', math.nan):.0f}, "
                     f"ranks {got.get('peak_mib', math.nan):.0f} / "
                     f"{other.get('peak_mib', math.nan):.0f}"
                     + (f"; parameters held between gathers per rank "
                        f"{got['held']} / {other['held']} of "
                        f"{sum(v.numel() for v in got['params'].values())}"
                        if "held" in got else "")
                     + f"; collectives per step {_collectives(got)}"
                     + (f"; hand-offs per step {got['hand_offs']}; stage "
                        f"1's waits in them (the bubble), per step: "
                        + ", ".join(f"{k} {ms:.2f} ms x{n:g}" for k, (ms, n)
                                    in sorted(other["collective_ms"].items())
                                    if "_hand" in k or k.startswith(
                                        "forward/"))
                        if "hand_offs" in got else ""))
    for line in lines:
        say("parallel", line)
    if have_cv2:
        parts = [load("host_flow.flow", r)["flow"].cpu().numpy()
                 for r in (0, 1)]
        both = np.concatenate([p.reshape(2, BATCH // 2, *p.shape[1:])
                               for p in parts], axis=1)
        alone = load("host_flow.flow")["flow_alone"].cpu().numpy()
        check(np.array_equal(both.reshape(alone.shape), alone),
              "--host_flow: the dp 2 flows bit-equal to the dp 1 flows")
        say("parallel", f"--host_flow dp 2 flows of a b{BATCH} x 2-stream "
                        f"video bit-equal to dp 1's")
    else:
        say("parallel", "cv2 does not import: --host_flow not run")
    say("parallel", f"{time.perf_counter() - t0:.1f} s")
    return launches


def _host_forms(plain: bool):
    """The dataset's host runtime: the library (``plain`` False) or the
    Python forms, for the block."""
    from vfd_gan_tpu_torch.data import native

    if not plain:
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    for name in ("pack_clips", "make_queue", "window_table"):
        saved = getattr(native, name)
        setattr(native, name, getattr(native, f"{name}_plain"))
        stack.callback(setattr, native, name, saved)
    return stack


def phase_native(tmp: Path) -> None:
    """The host runtime on real mp4 files: decode + pack ms per b8 batch,
    and the train loop's wait per batch with a consumer that holds each
    batch ~MyGAN's float32 step, with the library and with the Python
    forms, in turns."""
    from vfd_gan_tpu_torch.data import dataset, native
    from vfd_gan_tpu_torch.data.synthetic import make_dataset
    from vfd_gan_tpu_torch.ops.augment import staging_size

    t0 = time.perf_counter()
    train_list, _ = make_dataset(str(tmp / "mp4"), n_train=6, n_test=1,
                                 frames=64, size=160)
    say("native", f"library {native.build().name}; mp4 data written in "
                  f"{time.perf_counter() - t0:.1f} s")
    out = {}
    for plain in (False, True, True, False):
        with _host_forms(plain):
            ds = dataset.MdfVideoDataset(train_list, NFR,
                                         staging=staging_size(ISIZE))
            it = dataset.ClipBatchIterator(ds, BATCH, seed=0, workers=4)
            decode = []
            for b in range(len(it)):
                s0 = time.perf_counter()
                it._assemble(list(range(b * BATCH, (b + 1) * BATCH)))
                decode.append(1e3 * (time.perf_counter() - s0))
            waits, got = [], 0
            w0 = time.perf_counter()
            for _ in it:
                waits.append(1e3 * (time.perf_counter() - w0))
                got += 1
                time.sleep(0.15)            # the step holding the batch
                w0 = time.perf_counter()
        check(got == len(it) > 2, f"native: {got} batches of {len(it)}")
        key = "python" if plain else "library"
        out.setdefault(key, []).append((statistics.median(decode),
                                        statistics.median(waits[1:]),
                                        max(waits[1:])))
    say("native", f"b{BATCH} T{NFR} staged {staging_size(ISIZE)}^2 from "
                  f"{len(ds)} clips of 160^2 mp4 (4 decode threads): " +
                  "; ".join(f"{k}: decode + pack {d:.1f} ms per batch, wait "
                            f"median {w:.3f} ms (max {m:.3f})"
                            for k, runs in out.items()
                            for d, w, m in runs) +
                  f"; {time.perf_counter() - t0:.1f} s")


def run_dp_phases(tmp: Path, paths: dict) -> dict:
    """The --dp, host-runtime and parallel phases; returns the kernels'
    launches by run."""
    t0 = time.perf_counter()
    runs = phase_dp(tmp)
    phase_native(tmp)
    runs.update(phase_parallel(tmp, paths))
    say("dp-phases", f"--dp, native, parallel: "
                     f"{time.perf_counter() - t0:.1f} s")
    return runs


def run_slice_phases(tmp: Path, paths: dict, f32_ms: dict,
                     bf16_ms: dict) -> dict:
    """The MoE, int8-serve and int8-disc phases; returns the kernels'
    launch counts by run."""
    t0 = time.perf_counter()
    runs = phase_moe(tmp)
    runs.update(phase_int8_serve(tmp, paths, f32_ms, bf16_ms))
    runs.update(phase_int8_disc(tmp))
    say("slice-phases", f"--moe_experts, --quant int8, --int8_disc: "
                        f"{time.perf_counter() - t0:.1f} s")
    return runs


def run_new_phases(tmp: Path, device, paths: dict, base: dict) -> dict:
    """The --accum, --remat, evaluate and host-only phases; returns the
    kernels' launch counts by run."""
    t0 = time.perf_counter()
    runs = {f"accum {k}": v for k, v in phase_accum(tmp, device,
                                                     base).items()}
    runs.update({f"remat {k}": v for k, v in phase_remat(
        tmp, device, base).items()})
    runs.update({f"evaluate {k}": v for k, v in phase_evaluate(
        tmp, device, paths).items()})
    host = phase_host_only(tmp, device)
    if host:
        runs["mygan --host_flow"] = host
    say("new-phases", f"--accum, --remat, evaluate, host-only: "
                      f"{time.perf_counter() - t0:.1f} s")
    return runs


def slice_only(name: str) -> None:
    """``--slice-only``: the build and this slice's phase alone (serve
    --dp, --dp with the three options, --pp), for a short call while it
    is worked on; prints no result line."""
    with tempfile.TemporaryDirectory() as tmp:
        runs = phase_parallel(Path(tmp), make_checkpoints(Path(tmp)))
    say("slice-only", f"{name}: launches by run {json.dumps(runs)}; no "
                      "result line (the full run prints it)")


def main() -> None:
    start = time.perf_counter()
    name = phase_device()
    import_port()
    from vfd_gan_tpu_torch.utils.runtime import resolve_device

    device = torch.device("cuda")
    resolve_device("cuda")               # TF32 off, as the entry points do
    phase_build()
    if sys.argv[1:] == ["--slice-only"]:
        slice_only(name)
        return
    results = {"morphology_open": phase_kernel(device)}
    results.update(phase_flow_kernels(device))
    results["augment_gather"] = phase_augment_kernel(device)
    results["conv3x3"] = phase_conv_kernel(device)
    results["conv3x3_bf16"] = phase_conv_kernel_bf16(device)
    phase_flow_video(device)
    with tempfile.TemporaryDirectory() as tmp:
        from vfd_gan_tpu_torch.cli.infer import _load

        paths = make_checkpoints(Path(tmp))
        model = phase_generator(paths["mygan"], device)
        f32_forward_ms = {}
        _reset_counts()                          # the serving path starts
        phase_serve(paths["mygan"], model)
        f32_forward_ms["mygan"] = phase_infer("mygan", paths["mygan"], model)
        del model
        for family in ("clstm", "c2plus1d", "xception"):
            model, _ = _load(str(paths[family]), device)
            phase_serve_family(family, paths[family], model)
            f32_forward_ms[family] = phase_infer(family, paths[family], model)
            del model
        serve_counts = _counts()                 # ... and ends
        check(serve_counts["morphology_open"] == len(SERVED),
              f"serve + infer launched the opening kernel once per family: "
              f"{serve_counts}")
        check(serve_counts["conv3x3"] > 0,
              "serving clstm launched the conv3x3 kernel")
        say("serve", f"serve + infer path, four families: launches "
                     f"{json.dumps(serve_counts)}")
        bf16_forward_ms = phase_serve_bf16(paths, f32_forward_ms)
        phase_step_parity(Path(tmp))
        phase_supervised_parity(Path(tmp))
        for model in FAMILIES:
            phase_family_parity(Path(tmp), model)
        phase_step_parity(Path(tmp), dtype="bfloat16")
        phase_step_parity(Path(tmp), ae=True, dtype="bfloat16")
        phase_supervised_parity(Path(tmp), dtype="bfloat16")
        for model in FAMILIES:
            phase_family_parity(Path(tmp), model, dtype="bfloat16")
        engine, gan_counts, gan_sweep, gan_ms, gan_peak = phase_train(
            Path(tmp))
        gan_steps = engine.global_step
        gan_sweep_batches = engine.test_iter.n_batches
        two_counts = phase_two_kernel(engine)
        synthetic_ms = {"mygan": gan_ms}
        steps_ms = {"mygan": [gan_ms, gan_peak]}
        del engine
        for family in SUPERVISED_RUNS:
            # each family starts from an empty allocator: what the run
            # before left cached shifts clstm's host-bound step by a few ms
            gc.collect()
            torch.cuda.empty_cache()
            engine, counts, sweep, ms, peak = phase_supervised_train(
                Path(tmp), family)
            steps_ms[family] = [ms, peak]
            if family == "clstm":
                clstm_counts, clstm_sweep = counts, sweep
                clstm_steps = engine.global_step
                synthetic_ms["clstm"] = ms
            del engine
        # AnoGAN and GANomaly; their launches of the augment and opening
        # kernels, each run a path of its own
        family_counts = {}
        for model in FAMILIES:
            gc.collect()
            torch.cuda.empty_cache()
            engine, counts, sweep, ms, peak = phase_family_train(
                Path(tmp), model)
            steps_ms[model] = [ms, peak]
            family_counts[model] = counts
            del engine
        # the default command line: no --compute_dtype, bfloat16
        gc.collect()
        torch.cuda.empty_cache()
        engine, _, _, ms, peak = phase_train(Path(tmp), None,
                                             sweep_batches=1)
        steps_ms["mygan"] += [ms, peak]
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        engine, _, _, ms, peak = phase_train(Path(tmp), None, ae=True,
                                             steps=AE_STEPS, sweep_batches=1)
        steps_ms["mygan --ae"] = [float("nan"), float("nan"), ms, peak]
        del engine
        for family in SUPERVISED_RUNS:
            gc.collect()
            torch.cuda.empty_cache()
            engine, counts, sweep, ms, peak = phase_supervised_train(
                Path(tmp), family, None)
            steps_ms[family] += [ms, peak]
            if family == "clstm":
                bf16_counts, bf16_sweep = counts, sweep
                bf16_steps = engine.global_step
            del engine
        for model in FAMILIES:
            gc.collect()
            torch.cuda.empty_cache()
            engine, counts, sweep, ms, peak = phase_family_train(
                Path(tmp), model, None)
            steps_ms[model] += [ms, peak]
            family_counts[f"{model} bf16"] = counts
            del engine
        say("bf16-vs-f32", "b8 train step median ms and peak MiB, float32 "
                           "-> bfloat16 (the default): " + "; ".join(
                               f"{k} {a:.1f} ms {b:.0f} MiB -> {c:.1f} ms "
                               f"{d:.0f} MiB" for k, (a, b, c, d)
                               in steps_ms.items()))
        say("bf16-vs-f32", "b8 forward ms, float32 -> bfloat16: " + "; ".join(
            f"{k} {f32_forward_ms[k]:.3f} -> {bf16_forward_ms[k]:.3f}"
            for k in SERVED))
        gc.collect()
        torch.cuda.empty_cache()
        phase_device_scoring(Path(tmp))
        phase_data(Path(tmp), device, synthetic_ms)
        phase_resume(Path(tmp), device)
        phase_sweep_options(Path(tmp), device)
        phase_tensorboard(Path(tmp))
        gc.collect()
        torch.cuda.empty_cache()
        new_runs = run_new_phases(Path(tmp), device, paths, {
            f"{model}-{dtype}": steps_ms[model][i:i + 2]
            for model in ("mygan", "clstm")
            for dtype, i in (("f32", 0), ("bf16", 2))})
        gc.collect()
        torch.cuda.empty_cache()
        new_runs.update(run_slice_phases(Path(tmp), paths, f32_forward_ms,
                                         bf16_forward_ms))
        gc.collect()
        torch.cuda.empty_cache()
        new_runs.update(run_dp_phases(Path(tmp), paths))
    # launches: each kernel's count on the main path that runs it (MyGAN's
    # trainer for the fused and opening kernels, its --flow_impl
    # two_kernel step for warp and refine, the clstm trainer for the
    # augment and conv kernels); per step: the launches made outside the
    # test sweep over the train steps the engine counted (the opening: the
    # sweep's launches per sweep batch)
    launches = {"morphology_open": gan_counts, "flow_fused": gan_counts,
                "flow_warp": two_counts, "flow_refine": two_counts,
                "augment_gather": clstm_counts, "conv3x3": clstm_counts,
                "conv3x3_bf16": bf16_counts}
    per_step = {
        "morphology_open": gan_sweep["morphology_open"] / gan_sweep_batches,
        "flow_fused": (gan_counts["flow_fused"] - gan_sweep["flow_fused"])
        / gan_steps,
        "flow_warp": float(two_counts["flow_warp"]),
        "flow_refine": float(two_counts["flow_refine"]),
        "augment_gather": (clstm_counts["augment_gather"]
                           - clstm_sweep["augment_gather"]) / clstm_steps,
        "conv3x3": (clstm_counts["conv3x3"] - clstm_sweep["conv3x3"])
        / clstm_steps,
        "conv3x3_bf16": (bf16_counts["conv3x3_bf16"]
                         - bf16_sweep["conv3x3_bf16"]) / bf16_steps}
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
    say("done", f"all phases in {time.perf_counter() - start:.1f} s")
    # the kernels on the AnoGAN and GANomaly paths and on the --accum,
    # --remat and evaluate paths (each its own run, counts set to 0 before
    # it)
    for k in KERNELS:
        results[k]["launches_on"] = {
            run: counts[k] for run, counts in (
                *(family_counts.items() if k in ("augment_gather",
                                                 "morphology_open") else ()),
                *new_runs.items()) if counts[k]}
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
