"""Host-side video decode and encode with cv2 and the ground-truth mask
preparation, for whatever takes or writes mp4 files (the dataset of
``data/dataset.py``, ``cli/infer.py``, the server's ``/predict_video``).

The port's own copy of ``vfd_gan_tpu/data/video_io.py`` (the same frames,
masks and counts from the same files).  cv2 is imported inside
the functions: a machine without it still imports this module, and a call
there raises an error that names cv2.
"""

from __future__ import annotations

import os

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError("video decode and encode need cv2 (the "
                          "opencv-python package), which is not installed "
                          "here") from e
    return cv2


def count_frames(path: str) -> int:
    """Number of frames by the container's metadata; <= 0 when the file is
    missing or unreadable."""
    cv2 = _cv2()
    cap = cv2.VideoCapture(path)
    try:
        return int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    finally:
        cap.release()


def mask_edge_frames(frames: np.ndarray) -> np.ndarray:
    """Ground-truth mask preparation: invert, then the ``Canny(100, 200)``
    edge map (reference lib/data.py:102-105: the gt is the forgery's
    boundary, not its filled region).  ``(T, H, W, 3)`` uint8 RGB in,
    ``(T, H, W, 1)`` uint8 in {0, 255} out."""
    cv2 = _cv2()
    out = np.empty(frames.shape[:3] + (1,), np.uint8)
    for i, f in enumerate(frames):
        out[i, :, :, 0] = cv2.Canny(cv2.bitwise_not(f), 100, 200)
    return out


def read_clip(path: str, first_frame: int, num_frames: int,
              resize_to: tuple[int, int] | None = None,
              mask: bool = False) -> np.ndarray:
    """Decode ``num_frames`` RGB frames starting at ``first_frame`` as uint8
    ``(T, H, W, 3)``, or with ``mask=True`` their invert + Canny edge maps
    ``(T, H, W, 1)``.  ``resize_to=(H, W)`` resizes each frame on the host
    (bilinear), an edge map after the Canny, as the reference does.  A
    clip that runs past the end repeats its last frame."""
    cv2 = _cv2()
    if not os.path.exists(path):
        raise FileNotFoundError(f"video not found: {path}")
    cap = cv2.VideoCapture(path)
    try:
        if first_frame > 0:
            cap.set(cv2.CAP_PROP_POS_FRAMES, first_frame)
        frames = []
        for _ in range(num_frames):
            ret, frame = cap.read()
            if not ret:
                if not frames:
                    raise IOError(f"failed to decode any frame from {path}")
                frames.append(frames[-1].copy())
                continue
            rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            if mask:
                rgb = cv2.Canny(cv2.bitwise_not(rgb), 100, 200)[..., None]
            if resize_to is not None:
                rgb = cv2.resize(rgb, (resize_to[1], resize_to[0]),
                                 interpolation=cv2.INTER_LINEAR)
                if rgb.ndim == 2:       # cv2 drops a single channel axis
                    rgb = rgb[..., None]
            frames.append(rgb)
        return np.stack(frames)
    finally:
        cap.release()


def write_video(path: str, frames: np.ndarray, fps: int = 10) -> None:
    """Encode uint8 RGB ``(T, H, W, 3)`` frames as mp4v."""
    cv2 = _cv2()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    h, w = frames.shape[1:3]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (w, h))
    if not writer.isOpened():
        raise IOError(f"cannot open video writer for {path}")
    try:
        for f in frames:
            writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    finally:
        writer.release()
