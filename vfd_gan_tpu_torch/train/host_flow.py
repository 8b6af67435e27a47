"""``--host_flow``: the flow videos from OpenCV's Farneback on the host
(port of ``vfd_gan_tpu.train.host_flow``).

An audit path: the engine's flow (``MyGanEngine._flow``, in the train step
and the sweeps) becomes ``cv2.calcOpticalFlowFarneback`` on the host, with
the encoding of the device path (reference lib/utils.py:94-129):
grayscale of the per-time-slab min-max normalised video, a flow per
consecutive pair, hue = angle in degrees / 2, saturation 255, value = the
frame's min-max normalised magnitude, the last flow frame repeated, RGB in
[-1, 1].  ``--flow_scale`` does not apply.

Under ``--dp`` each rank holds its rows of each stream, and the
per-(stream, time-slab) min and max are the global stream's: the rank's
``2 x streams x T`` extrema are all-reduced (one MAX of the maxima and the
negated minima) over the ranks that hold its frames, then each rank
normalises and runs cv2 on its own clips.  Under ``--sp`` each rank holds
its frames of its rows, and the pair of its last frame takes the next
shard's first gray frame, exchanged once normalised.

cv2 is imported on use; ``require_cv2`` lets an engine refuse the option
when it is built, where cv2 does not import (a PyTorch-only install).
"""

from __future__ import annotations

import numpy as np
import torch


def require_cv2() -> None:
    """Exit, naming the flag, if cv2 does not import."""
    try:
        import cv2  # noqa: F401
    except ImportError as e:
        raise SystemExit(
            "--host_flow needs cv2 (OpenCV's calcOpticalFlowFarneback runs "
            f"on the host), which does not import here ({e}); drop "
            "--host_flow to compute the flow on the device") from e


def slab_extrema(video: np.ndarray, streams: int = 1):
    """``(lo, hi)``, each ``(streams, T)`` float32: the min and the max of
    every (stream, time slab) of ``(B, T, H, W, 3)`` over that stream's
    batch (lib/utils.py:96)."""
    b, t = video.shape[:2]
    if b % streams:
        raise ValueError(f"batch {b} does not split into {streams} streams")
    grouped = video.reshape(streams, b // streams, t, -1)
    return grouped.min(axis=(1, 3)), grouped.max(axis=(1, 3))


def host_gray(video: np.ndarray, streams: int = 1,
              extrema=None) -> np.ndarray:
    """The flow's input: uint8 ``(B, T, H, W)``, the luma times 255 of
    each (stream, time slab) of the numpy RGB video ``(B, T, H, W, 3)``
    min-max normalised (lib/utils.py:96-99) by ``extrema`` (the ``(lo,
    hi)`` of ``slab_extrema``), else by this video's own."""
    video = np.asarray(video, np.float32)
    b, t = video.shape[:2]
    lo, hi = slab_extrema(video, streams) if extrema is None else extrema
    g = b // streams
    # per-time-slab min-max over one stream's batch (lib/utils.py:96)
    norm = np.empty_like(video)
    for s in range(streams):
        for j in range(t):
            slab = video[s * g:(s + 1) * g, j]
            norm[s * g:(s + 1) * g, j] = (slab - lo[s, j]) / (
                hi[s, j] - lo[s, j] + 1e-5)
    gray = (norm[..., 0] * 0.299 + norm[..., 1] * 0.587
            + norm[..., 2] * 0.114) * 255.0
    return gray.astype(np.uint8)


def host_flow_of_gray(gray: np.ndarray, frames: int) -> np.ndarray:
    """The flow RGB video ``(B, frames, H, W, 3)`` in [-1, 1] of the uint8
    gray video ``(B, T', H, W)``: one flow per consecutive pair, the last
    flow frame repeated up to ``frames`` (``T'`` is ``frames``, or one more
    where the next shard's first frame follows, ``--sp``)."""
    import cv2

    b, t, h, w = gray.shape
    out = np.zeros((b, frames, h, w, 3), np.float32)
    for i in range(b):
        for j in range(1, t):
            flow = cv2.calcOpticalFlowFarneback(
                gray[i, j - 1], gray[i, j], None, 0.5, 3, 15, 3, 5, 1.2, 0)
            mag, ang = cv2.cartToPolar(flow[..., 0], flow[..., 1],
                                       angleInDegrees=True)
            hsv = np.zeros((h, w, 3), np.uint8)
            hsv[..., 0] = (ang / 2).astype(np.uint8)
            hsv[..., 1] = 255
            hsv[..., 2] = cv2.normalize(mag, None, 0, 255,
                                        cv2.NORM_MINMAX).astype(np.uint8)
            out[i, j - 1] = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB) / 255.0
        for j in range(t - 1, frames):         # the last flow frame again
            out[i, j] = out[i, t - 2]
    return out * 2.0 - 1.0


def host_video_to_flow_rgb(video: np.ndarray, streams: int = 1,
                           extrema=None) -> np.ndarray:
    """numpy RGB video ``(B, T, H, W, 3)`` in [-1, 1] -> its flow RGB video.

    ``streams``: the number of contiguous batch groups whose time slabs are
    min-max normalised apart (the reference calls its flow once per video
    stream, models/mygannet.py:281-282).  ``extrema``: the ``(lo, hi)`` of
    ``slab_extrema`` to normalise by (the global batch's under ``--dp``),
    else this video's own."""
    return host_flow_of_gray(host_gray(video, streams, extrema),
                             np.shape(video)[1])


def video_to_flow_rgb_host(video: torch.Tensor, streams: int = 1,
                           dp=None) -> torch.Tensor:
    """``host_video_to_flow_rgb`` of a tensor: copied to the host, the flow
    made there, copied back to the tensor's device as float32 (float64
    for a float64 tensor).  Under an active ``dp``
    (``parallel.mesh.DataParallel``) the tensor holds this rank's rows of
    each stream, and the slabs' extrema are the global batch's: the MAX
    over the ranks that hold these frames (``dp.stretch_group``: under
    ``--sp`` the dp peers of the rank's shard).  Under ``--sp`` (``dp.sp``
    on) the tensor holds this rank's frames: each shard's gray frames are
    made by its own slabs' extrema, and the pair of its last frame takes
    the next shard's first gray frame (a right halo of one, as the device
    flow's, ``ops/flow.py``); the last shard repeats its last flow
    frame."""
    host = video.detach().float().cpu().numpy()
    extrema = None
    if dp is not None and dp.synced("stretch"):
        lo, hi = slab_extrema(host, streams)
        both = torch.from_numpy(np.stack([hi, -lo])).to(dp.device)
        both = dp.all_reduce_max_(both, dp.stretch_group).cpu().numpy()
        extrema = (-both[1], both[0])
    gray = host_gray(host, streams, extrema)
    sp = getattr(dp, "sp", None)
    if sp is not None and sp.on:
        if gray.shape[1] < 2:
            raise ValueError(f"--sp: a shard of {gray.shape[1]} frame(s) "
                             "has no frame pair of its own (nfr / sp must "
                             "be >= 2)")
        # the gray values (whole numbers to 255) pass exactly as float32
        nxt = sp.halo(torch.from_numpy(gray).to(dp.device, torch.float32),
                      1, 1, left=False)
        if sp.index < sp.size - 1:
            gray = nxt.cpu().numpy().astype(np.uint8)
    out = torch.from_numpy(host_flow_of_gray(gray, host.shape[1]))
    # float64 in a float64 run (the equivalence checks; the values are
    # float32's)
    return out.to(video.device, torch.float64 if video.dtype == torch.float64
                  else torch.float32)
