#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on one NVIDIA card.

Run from the root of a checkout, with one card and no arguments::

    python3 chip_smoke.py

It builds the hand-written CUDA kernel from this checkout's sources and runs
the port (``vfd_gan_tpu_torch``, never jax) in phases, one line each:

1. device: the card's name and power limit (nvidia-smi);
2. build: the kernel library, timed;
3. kernel vs plain: the opening kernel against its plain PyTorch version
   at the infer shapes in both planes, k = 3 and 5, binary and float
   masks, and a 512 x 512 plane (the tiled branch): bit-equal, then timed
   with CUDA events (20 repetitions of 10 back-to-back calls);
4. generator: ``Generator(ngf=32)`` with random weights from a seed,
   written as a reference-format ``*_netG.pth`` and loaded back by the
   entry points' loader; its CUDA forward on a (1, 16, 128, 128, 3) clip
   against the CPU (max-abs <= 1e-4, TF32 off), and its b8 forward time;
5. serving: ``cli.serve.serve`` on port 0 at ``--max_batch 8 --nfr 16
   --isize 128 --device cuda``, answering HTTP requests (1 clip; 3 clips
   with ``?mask=1``; a 2-clip ``/predict_stream``; 8 concurrent clips;
   rounds of 8-clip requests for the b8 batch latency);
6. infer: ``cli.infer.predict_clips`` on two uint8 clips, which must go
   through the kernel and match the plain opening of the same prediction.

The kernel's launch count is set to 0 before phases 5-6 (the main path)
and read after them.  Then come one JSON line of kernel results and, last,
``{"ok": true, "device": {...}}``.  Any failure raises: the script exits
non-zero and prints no last line.  It does the same without a card, and
outside a checkout of the repo.
"""

from __future__ import annotations

import base64
import json
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
KERNEL_SOURCE = "vfd_gan_tpu_torch/ops/cuda/morphology_open.cu"
KERNEL_REPLACES = "vfd_gan_tpu/ops/pallas/morphology.py:24"


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def event_ms(fn, reps: int = 20, calls: int = 10, warmup: int = 5) -> float:
    """Median over ``reps`` of the time per call of ``fn``, in ms, from one
    CUDA event pair around ``calls`` back-to-back calls.  Back to back, the
    host enqueues the next launch while the card runs this one, so a call
    whose host side is shorter than its device side is timed by the card;
    one pair per call would also count the host's time before the launch."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) / calls for s, e in pairs)


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
    return {"max_abs_err": worst, "ms": times["th"][0],
            "plain_ms": times["th"][1]}


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


def main() -> None:
    name = phase_device()
    import_port()
    from vfd_gan_tpu_torch.ops.morphology import open_planes_cuda

    device = torch.device("cuda")
    phase_build()
    kernel = phase_kernel(device)
    with tempfile.TemporaryDirectory() as tmp:
        path = make_checkpoint(Path(tmp))
        model = phase_generator(path, device)
        open_planes_cuda.launches = 0            # the main path starts here
        phase_serve(path, model)
        phase_infer(model)
        launches = open_planes_cuda.launches
    check(launches > 0, "the main path launched the morphology kernel")
    print(json.dumps({"kernels": [{
        "name": "morphology_open", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches, **kernel}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
