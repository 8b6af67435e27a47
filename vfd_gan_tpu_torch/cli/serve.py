"""Batch-inference server for a mask model (port of
``vfd_gan_tpu.cli.serve``).

A long-lived process that loads one model once (the MyGAN generator, the
"c2plus1d" AutoEncoder, Xception-3D or the ConvLSTM, from a ``.pth`` by its
file name or from a port run's ``weights/latest.pt`` by its structure, as
``cli.infer`` does), keeps it in
eval mode on one device, and **micro-batches concurrent requests**: a
batcher thread drains a queue, packs up to ``--max_batch`` clips (padding
the tail with zero clips so every forward has the same shape), runs the
forward once and fans the results back out.  In eval mode BN uses its
running statistics, so padding rows cannot change the real rows.

Endpoints (stdlib ``http.server``), wire format as in the JAX server:

* ``POST /predict`` -- body: raw ``float32`` little-endian clips of shape
  ``(k, nfr, isize, isize, 3)`` in [-1, 1], ``X-Clip-Count: k`` (default
  1).  Response: JSON per-frame mean mask scores and, with ``?mask=1``,
  the mask video as base64 ``uint8``.
* ``POST /predict_stream`` -- ``k`` raw clips read incrementally, each
  submitted as its bytes arrive; NDJSON score lines stream back, with
  producer backpressure instead of 429s.
* ``POST /predict_video`` -- JSON ``{"video_path": ...}`` decoded
  server-side (cv2, imported on use) inside ``--video_root``.
* ``GET /healthz`` / ``GET /stats``.

Overload degrades to fast ``429`` responses once ``max_queued_clips``
admitted clips are waiting.  With ``--auth_token`` every endpoint but
``/healthz`` needs ``Authorization: Bearer <token>``.

Usage::

    python -m vfd_gan_tpu_torch.cli.serve --ckpt run_netG.pth \\
        [--dtype bfloat16] [--device cuda]

``--dtype bfloat16`` serves the model computing in bfloat16 from the
checkpoint's float32 parameters, its name tagged `` [bf16]``, as the JAX
server does; ``--quant int8 [--calib_plist | --calib_clips]`` serves the
family's int8 forward (``quant/``; ``--dtype`` ignored), tagged
`` [int8]``.  The wire format is unchanged.

``--dp N`` serves data-parallel in this one process (JAX: the variables
replicated over a 1-D ``dp`` mesh, the fixed batch sharded along its
rows): a copy of the served model (the int8 one under ``--quant int8``)
on each of ``cuda:0 .. cuda:N-1`` (``--device cpu``: N copies on the
CPU), each padded batch split into N equal row slices, every replica's
forward launched on its own card's stream before any is read back, the
results concatenated in row order.  ``--max_batch`` must divide by N, and
N may not pass the visible cards; ``/stats`` adds ``replicas`` and each
replica's median forward ms.  ``InferenceServer(..., devices=[...])``
takes the replicas' devices directly (two on one card, for instance).
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import copy
import hmac
import json
import os
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from vfd_gan_tpu_torch.cli.infer import add_quant_args
from vfd_gan_tpu_torch.models import DTYPES
from vfd_gan_tpu_torch.ops.image import to_channel_first, to_channel_last
from vfd_gan_tpu_torch.utils.runtime import module_device


def build_parser():
    p = argparse.ArgumentParser(description="mask-model inference server")
    p.add_argument("--ckpt", required=True,
                   help="reference-format .pth whose name holds netG, "
                        "ganbase, mygan, c2plus1d, xception or clstm, or "
                        "a port run's weights/latest.pt")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8790)
    p.add_argument("--isize", type=int, default=128)
    p.add_argument("--nfr", type=int, default=16)
    p.add_argument("--max_batch", type=int, default=8,
                   help="forward batch size; requests are packed up to this")
    p.add_argument("--max_wait_ms", type=float, default=5.0,
                   help="how long the batcher waits to fill a batch")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--dtype", choices=tuple(DTYPES), default="float32",
                   help="compute dtype (parameters stay float32; clips in "
                        "and masks out stay float32)")
    p.add_argument("--dp", type=int, default=1,
                   help="replicas, one per card (--device cpu: on the "
                        "CPU); --max_batch must divide by it")
    add_quant_args(p)
    p.add_argument("--max_queued_clips", type=int, default=256,
                   help="admission bound before shedding load with 429s")
    p.add_argument("--video_root", default="",
                   help="directory that /predict_video may read from; "
                        "unset disables the endpoint (it decodes "
                        "server-side filesystem paths)")
    p.add_argument("--auth_token", default="",
                   help="if set, require 'Authorization: Bearer <token>' "
                        "on every endpoint except /healthz")
    return p


class OverloadedError(RuntimeError):
    """Admission bound hit -- shed load instead of queueing unboundedly."""


class _Work:
    """One enqueued clip-batch and its completion event."""

    def __init__(self, clips: np.ndarray):
        self.clips = clips                    # (k, T, H, W, 3) float32
        self.done = threading.Event()
        self.pred: np.ndarray | None = None   # (k, T, H, W, 1)
        self.error: str | None = None


class InferenceServer:
    """Owns the model's replicas, their devices and the batcher thread."""

    def __init__(self, model: torch.nn.Module, name: str, *, isize: int,
                 nfr: int, max_batch: int, max_wait_ms: float,
                 max_queued_clips: int = 256, devices=None):
        self.model = model.eval()
        self.device = module_device(model)
        # one replica per device, the model itself on the first (JAX
        # cli/serve.py: the variables replicated over the dp mesh)
        devices = [self.device] if devices is None else [
            torch.device(d) for d in devices]
        if max_batch % len(devices):
            raise SystemExit(f"--max_batch {max_batch} must be divisible "
                             f"by dp={len(devices)}")
        self.replicas = [self.model if i == 0 and d == self.device
                         else copy.deepcopy(self.model).to(d).eval()
                         for i, d in enumerate(devices)]
        self.devices = devices
        # each replica's forward times (ms), the last 1000
        self.replica_ms: list[list[float]] = [[] for _ in devices]
        self.name = name
        self.isize, self.nfr = isize, nfr
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self.max_queued_clips = max_queued_clips
        self._queued = 0
        self.shed = 0
        self._q: "queue.Queue[_Work]" = queue.Queue()
        self._stats_lock = threading.Lock()
        self.requests = 0
        self.clips = 0
        self.batches = 0
        self.latencies_ms: list[float] = []

        # warm-up at the serving shape, so the first request does not pay
        # for cuDNN's first-call setup or a kernel library's build
        self.forward(np.zeros((max_batch, nfr, isize, isize, 3), np.float32))

        self._stop = threading.Event()
        self._batcher = threading.Thread(target=self._batch_loop, daemon=True)
        self._batcher.start()

    @torch.inference_mode()
    def forward(self, clips: np.ndarray) -> np.ndarray:
        """``(b, T, H, W, 3)`` float32 clips -> ``(b, T, H, W, 1)`` masks;
        with several replicas ``b`` splits into equal row slices, one a
        replica, all launched before any is read back."""
        x = torch.from_numpy(clips)
        if len(self.replicas) == 1:
            return to_channel_last(self.replicas[0](to_channel_first(
                x.to(self.device)))).cpu().numpy()
        launched = []
        for model, device, part in zip(self.replicas, self.devices,
                                       x.chunk(len(self.replicas))):
            timer = _ReplicaTimer(device)
            with timer:
                y = to_channel_last(model(to_channel_first(
                    part.to(device, non_blocking=True))))
            launched.append((y, timer))
        out = np.concatenate([y.cpu().numpy() for y, _ in launched])
        with self._stats_lock:
            for times, (_, timer) in zip(self.replica_ms, launched):
                times.append(timer.ms())
                del times[:-1000]
        return out

    # -- batcher ------------------------------------------------------------
    def _batch_loop(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            count = first.clips.shape[0]
            deadline = time.perf_counter() + self.max_wait_s
            while count < self.max_batch:
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=left)
                except queue.Empty:
                    break
                batch.append(nxt)
                count += nxt.clips.shape[0]

            t0 = time.perf_counter()
            try:
                clips = np.concatenate([w.clips for w in batch])
                preds = []
                for start in range(0, len(clips), self.max_batch):
                    chunk = clips[start:start + self.max_batch]
                    pad = self.max_batch - len(chunk)
                    if pad:
                        chunk = np.concatenate(
                            [chunk, np.zeros((pad,) + chunk.shape[1:],
                                             np.float32)])
                    preds.append(self.forward(chunk)[:len(chunk) - pad])
                clips_out = np.concatenate(preds)
            except Exception as e:          # noqa: BLE001
                # a poisoned request must not hang its batch peers until
                # timeout (or kill the batcher thread)
                for w in batch:
                    w.error = f"{type(e).__name__}: {e}"
                    w.done.set()
                continue
            ms = (time.perf_counter() - t0) * 1000

            i = 0
            for w in batch:
                k = w.clips.shape[0]
                w.pred = clips_out[i:i + k]
                i += k
                w.done.set()
            with self._stats_lock:
                self.batches += 1
                self.clips += len(clips)
                self.latencies_ms.append(ms)

    # -- public API ----------------------------------------------------------
    def submit(self, clips: np.ndarray) -> _Work:
        """Non-blocking: enqueue ``(k, T, H, W, 3)`` clips for the batcher.

        Returns the pending ``_Work``; redeem it with :meth:`collect`.
        Raises OverloadedError when the admission bound is hit (the clips
        are NOT enqueued).  Every successful submit must be collected --
        the admission count is released there.
        """
        k = int(clips.shape[0])
        with self._stats_lock:
            if self._queued + k > self.max_queued_clips:
                self.shed += 1
                raise OverloadedError(
                    f"{self._queued} clips queued (bound "
                    f"{self.max_queued_clips})")
            self._queued += k
        w = _Work(np.ascontiguousarray(clips, np.float32))
        self._q.put(w)
        return w

    def collect(self, w: _Work, timeout: float = 60.0) -> np.ndarray:
        """Blocking: wait for a submitted ``_Work`` and return its masks."""
        k = int(w.clips.shape[0])
        try:
            if not w.done.wait(timeout):
                raise TimeoutError("inference timed out")
        finally:
            with self._stats_lock:
                self._queued -= k
        if w.error is not None:
            raise RuntimeError(f"inference failed: {w.error}")
        with self._stats_lock:
            self.requests += 1
        return w.pred

    def predict(self, clips: np.ndarray, timeout: float = 60.0) -> np.ndarray:
        """Blocking: enqueue ``(k, T, H, W, 3)`` clips, wait for the batcher.

        Raises OverloadedError when the admission bound is hit.
        """
        return self.collect(self.submit(clips), timeout)

    def stats(self) -> dict:
        with self._stats_lock:
            lat = sorted(self.latencies_ms)
            pct = (lambda p: lat[min(len(lat) - 1, int(p * len(lat)))]
                   if lat else 0.0)
            med = [sorted(t)[len(t) // 2] if t else 0.0
                   for t in self.replica_ms]
            return {
                "model": self.name,
                "device": str(self.device),
                "replicas": len(self.replicas),
                "replica_forward_ms": med,
                "requests": self.requests,
                "clips": self.clips,
                "batches": self.batches,
                "mean_batch_occupancy": (self.clips / self.batches
                                         if self.batches else 0.0),
                "p50_batch_ms": pct(0.50),
                "p99_batch_ms": pct(0.99),
                "shed_requests": self.shed,
            }

    def close(self) -> None:
        self._stop.set()
        self._batcher.join(timeout=2)


class _ReplicaTimer:
    """A replica's forward, timed: its card made the current device for
    the block, CUDA events on that card's current stream (read once the
    output has been copied back); the host's clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.guard = torch.cuda.device(device) if self.cuda \
            else contextlib.nullcontext()

    def __enter__(self):
        self.guard.__enter__()
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.end.record()
        else:
            self.t1 = time.perf_counter()
        return self.guard.__exit__(*exc)

    def ms(self) -> float:
        if self.cuda:
            self.end.synchronize()
            return self.start.elapsed_time(self.end)
        return (self.t1 - self.t0) * 1e3


def make_handler(server: InferenceServer, video_root: str = "",
                 auth_token: str = ""):
    """``video_root`` confines /predict_video's server-side file reads
    (empty = endpoint disabled: it is otherwise an arbitrary-file-read
    primitive).  ``auth_token`` gates every endpoint except /healthz
    behind a bearer token."""
    resolved_root = os.path.realpath(video_root) if video_root else ""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):                      # quiet
            pass

        def _json(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _authorized(self) -> bool:
            if not auth_token:
                return True
            got = self.headers.get("Authorization", "")
            # constant-time compare: plain == leaks a timing side channel
            return hmac.compare_digest(got.encode(),
                                       f"Bearer {auth_token}".encode())

        def do_GET(self):
            if self.path.startswith("/healthz"):
                self._json(200, {"ok": True, "model": server.name,
                                 "nfr": server.nfr, "isize": server.isize})
            elif not self._authorized():
                self._json(401, {"error": "missing/invalid bearer token"})
            elif self.path.startswith("/stats"):
                self._json(200, server.stats())
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if not self._authorized():
                self._json(401, {"error": "missing/invalid bearer token"})
                return
            if self.path.startswith("/predict_video"):
                self._predict_video()
                return
            if self.path.startswith("/predict_stream"):
                self._predict_stream()
                return
            if not self.path.startswith("/predict"):
                self._json(404, {"error": "unknown path"})
                return
            try:
                k = int(self.headers.get("X-Clip-Count", "1"))
            except ValueError:
                k = 0
            t, s = server.nfr, server.isize
            want = k * t * s * s * 3 * 4
            n = int(self.headers.get("Content-Length", "0"))
            if k < 1 or n != want:
                self._json(400, {"error": f"body must be {want} bytes "
                                          f"({k}x{t}x{s}x{s}x3 f32 LE), "
                                          f"got {n}"})
                return
            raw = self.rfile.read(n)
            clips = np.frombuffer(raw, "<f4").reshape(k, t, s, s, 3)
            try:
                pred = server.predict(clips)
            except OverloadedError as e:
                self._json(429, {"error": f"overloaded: {e}"})
                return
            except TimeoutError:
                self._json(503, {"error": "inference timed out"})
                return
            scores = pred[..., 0].reshape(k, t, -1).mean(axis=2)
            out = {"clip_count": k,
                   "frame_scores": scores.tolist()}
            if "mask=1" in (self.path.split("?", 1) + [""])[1]:
                mask_u8 = (np.clip(pred[..., 0], 0, 1) * 255).astype(np.uint8)
                out["mask_u8_b64"] = base64.b64encode(
                    mask_u8.tobytes()).decode()
                out["mask_shape"] = list(mask_u8.shape)
            self._json(200, out)

        def _read_exact(self, n: int) -> bytes:
            buf = bytearray()
            while len(buf) < n:
                chunk = self.rfile.read(n - len(buf))
                if not chunk:
                    raise ConnectionError(
                        f"client closed mid-clip ({len(buf)}/{n} bytes)")
                buf += chunk
            return bytes(buf)

        def _predict_stream(self):
            """Streaming ingestion: the body is ``k`` raw
            ``(nfr, isize, isize, 3)`` f32-LE clips read incrementally --
            each clip is submitted the moment its bytes arrive, and its
            NDJSON score line is flushed back as soon as it completes.
            Memory is bounded by the admission window; when it is full the
            producer BLOCKS on the oldest in-flight clip (backpressure)
            instead of shedding 429s.
            """
            t, s = server.nfr, server.isize
            clip_bytes = t * s * s * 3 * 4
            n = int(self.headers.get("Content-Length", "0"))
            if n <= 0:
                # stdlib http.server does not decode chunked
                # transfer-encoding; clients must send Content-Length and
                # may still stream the body bytes gradually.
                self._json(411, {"error": "Content-Length required "
                                          "(chunked TE unsupported)"})
                return
            if n % clip_bytes:
                self._json(400, {"error": f"body must be a multiple of "
                                          f"{clip_bytes} bytes per "
                                          f"({t}x{s}x{s}x3 f32 LE) clip"})
                return
            k = n // clip_bytes
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("X-Clip-Count", str(k))
            self.end_headers()     # HTTP/1.0: stream until close

            def emit(i, w):
                try:
                    pred = server.collect(w)
                    scores = pred[..., 0].reshape(t, -1).mean(axis=1)
                    line = {"clip": i, "frame_scores": scores.tolist()}
                except (RuntimeError, TimeoutError) as e:
                    line = {"clip": i, "error": str(e)}
                self.wfile.write((json.dumps(line) + "\n").encode())
                self.wfile.flush()

            pending: list = []     # [(index, _Work)] in submit order
            try:
                for i in range(k):
                    raw = self._read_exact(clip_bytes)
                    clip = np.frombuffer(raw, "<f4").reshape(1, t, s, s, 3)
                    deadline = time.monotonic() + 60.0
                    while True:
                        try:
                            pending.append((i, server.submit(clip)))
                            break
                        except OverloadedError as e:
                            if pending:        # backpressure: drain oldest
                                emit(*pending.pop(0))
                            elif time.monotonic() > deadline:
                                # other clients held the bound for 60 s --
                                # report and stop rather than spin forever
                                self.wfile.write((json.dumps(
                                    {"clip": i, "error": f"overloaded: {e}"})
                                    + "\n").encode())
                                return
                            else:
                                time.sleep(0.02)
                    # opportunistic in-order drain keeps the response moving
                    while pending and pending[0][1].done.is_set():
                        emit(*pending.pop(0))
                while pending:
                    emit(*pending.pop(0))
            except (ConnectionError, BrokenPipeError):
                # client went away: redeem whatever was admitted so the
                # admission counter can't leak, then drop the connection
                for _, w in pending:
                    try:
                        server.collect(w)
                    except (RuntimeError, TimeoutError):
                        pass

        def _predict_video(self):
            """JSON {"video_path": ...}: decode server-side (cv2), window
            into nfr clips, batch through the forward, return per-frame
            scores."""
            if not resolved_root:
                self._json(403, {"error": "/predict_video disabled: start "
                                          "the server with --video_root"})
                return
            from vfd_gan_tpu_torch.data.video_io import count_frames, read_clip

            n = int(self.headers.get("Content-Length", "0"))
            try:
                req = json.loads(self.rfile.read(n))
                path = req["video_path"]
            except (ValueError, KeyError, TypeError):
                self._json(400, {"error": 'body must be JSON with '
                                          '"video_path"'})
                return
            # confine to the served root: resolve symlinks/.. BEFORE the
            # prefix check so traversal can't escape
            path = os.path.realpath(os.path.join(resolved_root, path))
            if not (path == resolved_root
                    or path.startswith(resolved_root + os.sep)):
                self._json(403, {"error": "path escapes --video_root"})
                return
            total = count_frames(path)      # <= 0 when unreadable/missing
            if total <= 0:
                self._json(404, {"error": f"cannot open video: {path}"})
                return
            t, s = server.nfr, server.isize
            n_clips = total // t
            if n_clips == 0:
                self._json(400, {"error": f"video too short: {total} < {t}"})
                return
            try:
                clips = np.stack([
                    read_clip(path, i * t, t, resize_to=(s, s))
                    for i in range(n_clips)])
            except Exception as e:          # noqa: BLE001
                self._json(500, {"error": f"decode failed: {e}"})
                return
            clips = clips.astype(np.float32) / 255.0 * 2.0 - 1.0
            try:
                pred = server.predict(clips)
            except OverloadedError as e:
                self._json(429, {"error": f"overloaded: {e}"})
                return
            except TimeoutError:
                self._json(503, {"error": "inference timed out"})
                return
            scores = pred[..., 0].reshape(n_clips, t, -1).mean(axis=2)
            self._json(200, {"clip_count": n_clips,
                             "frames": int(n_clips * t),
                             "frame_scores": scores.reshape(-1).tolist()})

    return Handler


def replica_devices(device: torch.device, dp: int) -> list:
    """``--dp``'s replica devices: ``cuda:0 .. cuda:dp-1`` (never fewer
    than asked: more than the visible cards exits), or ``dp`` times the
    CPU."""
    if dp < 1:
        raise SystemExit(f"--dp {dp}: must be >= 1")
    if device.type != "cuda":
        return [device] * dp
    cards = torch.cuda.device_count()
    if dp > cards:
        raise SystemExit(f"--dp {dp}: only {cards} CUDA device(s) visible")
    return [torch.device("cuda", i) for i in range(dp)]


def serve(args) -> ThreadingHTTPServer:
    """Build the server (used by main() and the tests)."""
    from vfd_gan_tpu_torch.cli.infer import load_for_serving
    from vfd_gan_tpu_torch.utils.runtime import resolve_device

    device = resolve_device(args.device)
    devices = replica_devices(device, args.dp)
    # --dtype bfloat16: the model rebuilt to compute in bfloat16 from the
    # checkpoint's float32 parameters (JAX cli/serve.py:539-544); --quant
    # int8: the family's int8 forward (JAX cli/serve.py:518-537)
    model, name = load_for_serving(args, device)
    inf = InferenceServer(model, name, isize=args.isize, nfr=args.nfr,
                          max_batch=args.max_batch,
                          max_wait_ms=args.max_wait_ms,
                          max_queued_clips=args.max_queued_clips,
                          devices=devices)
    httpd = ThreadingHTTPServer(
        (args.host, args.port),
        make_handler(inf, video_root=args.video_root,
                     auth_token=args.auth_token))
    httpd.inference = inf
    return httpd


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    httpd = serve(args)
    host, port = httpd.server_address
    print(f"serving {httpd.inference.name} on http://{host}:{port} "
          f"({', '.join(map(str, httpd.inference.devices))}, batch "
          f"{args.max_batch}, "
          f"wait {args.max_wait_ms} ms)")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.inference.close()
        httpd.server_close()


if __name__ == "__main__":
    main()
