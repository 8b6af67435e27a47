"""``--host_flow``: the flow videos from OpenCV's Farneback on the host
(port of ``vfd_gan_tpu.train.host_flow``).

An audit path: the engine's flow (``MyGanEngine._flow``, in the train step
and the sweeps) becomes ``cv2.calcOpticalFlowFarneback`` on the host, with
the encoding of the device path (reference lib/utils.py:94-129):
grayscale of the per-time-slab min-max normalised video, a flow per
consecutive pair, hue = angle in degrees / 2, saturation 255, value = the
frame's min-max normalised magnitude, the last flow frame repeated, RGB in
[-1, 1].  ``--flow_scale`` does not apply.

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


def host_video_to_flow_rgb(video: np.ndarray, streams: int = 1) -> np.ndarray:
    """numpy RGB video ``(B, T, H, W, 3)`` in [-1, 1] -> its flow RGB video.

    ``streams``: the number of contiguous batch groups whose time slabs are
    min-max normalised apart (the reference calls its flow once per video
    stream, models/mygannet.py:281-282)."""
    import cv2

    video = np.asarray(video, np.float32)
    b, t, h, w, _ = video.shape
    if b % streams:
        raise ValueError(f"batch {b} does not split into {streams} streams")
    g = b // streams
    # per-time-slab min-max over one stream's batch (lib/utils.py:96)
    norm = np.empty_like(video)
    for s in range(streams):
        for j in range(t):
            slab = video[s * g:(s + 1) * g, j]
            lo, hi = slab.min(), slab.max()
            norm[s * g:(s + 1) * g, j] = (slab - lo) / (hi - lo + 1e-5)
    gray = (norm[..., 0] * 0.299 + norm[..., 1] * 0.587
            + norm[..., 2] * 0.114) * 255.0
    gray = gray.astype(np.uint8)

    out = np.zeros((b, t, h, w, 3), np.float32)
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
        out[i, t - 1] = out[i, t - 2]          # the last flow frame again
    return out * 2.0 - 1.0


def video_to_flow_rgb_host(video: torch.Tensor,
                           streams: int = 1) -> torch.Tensor:
    """``host_video_to_flow_rgb`` of a tensor: copied to the host, the flow
    made there, copied back to the tensor's device as float32."""
    out = host_video_to_flow_rgb(video.detach().float().cpu().numpy(),
                                 streams)
    return torch.from_numpy(out).to(video.device)
