"""Synthetic forgery videos on disk, for tests and demos (port of
``vfd_gan_tpu.data.synthetic``).

Writes the reference's layout: per clip a directory ``<root>/<name>/`` with
``[Fake]<name>.mp4`` (a drifting background with a moving inpainted
square), ``[Original]<name>.mp4`` (the background alone) and
``[Mask]<name>.mp4`` (white, the forged region black, so that the
dataset's invert + Canny preparation finds the forgery's boundary), and
the train and test path lists.  The frames come from numpy's
``default_rng`` exactly as in the JAX package, so both write the same
frames for the same seed; encoding needs cv2.
"""

from __future__ import annotations

import os

import numpy as np

from vfd_gan_tpu_torch.data.video_io import write_video


def _background(t: int, size: int, rng) -> np.ndarray:
    """A smooth drifting gradient, ``(t, size, size, 3)`` uint8."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    phase = rng.uniform(0, 2 * np.pi)
    frames = []
    for i in range(t):
        g = 0.5 + 0.4 * np.sin(2 * np.pi * (xx + 0.03 * i) + phase) \
            * np.cos(2 * np.pi * (yy - 0.02 * i))
        rgbf = np.stack([g, np.roll(g, 3, 0), np.roll(g, 5, 1)], axis=-1)
        frames.append((rgbf * 255).clip(0, 255).astype(np.uint8))
    return np.stack(frames)


def clip_frames(frames: int = 32, size: int = 64,
                seed: int = 0) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The (fake, original, mask) frame stacks of one clip, before
    encoding: uint8 ``(frames, size, size, 3)`` each."""
    rng = np.random.default_rng(seed)
    orig = _background(frames, size, rng)
    fake = orig.copy()
    mask = np.full_like(orig, 255)
    side = max(4, size // 4)
    y0 = rng.integers(0, size - side)
    x0 = rng.integers(0, size - side)
    vy, vx = rng.integers(-2, 3, size=2)
    patch_color = rng.integers(0, 255, size=3, dtype=np.uint8)
    for i in range(frames):
        y = int(np.clip(y0 + vy * i, 0, size - side))
        x = int(np.clip(x0 + vx * i, 0, size - side))
        fake[i, y:y + side, x:x + side] = patch_color
        mask[i, y:y + side, x:x + side] = 0
    return fake, orig, mask


def make_clip_dir(root: str, name: str, *, frames: int = 32, size: int = 64,
                  seed: int = 0) -> str:
    """Write one [Fake]/[Original]/[Mask] triple; returns the fake path."""
    fake, orig, mask = clip_frames(frames, size, seed)
    d = os.path.join(root, name)
    write_video(os.path.join(d, f"[Fake]{name}.mp4"), fake)
    write_video(os.path.join(d, f"[Original]{name}.mp4"), orig)
    write_video(os.path.join(d, f"[Mask]{name}.mp4"), mask)
    return os.path.join(d, f"[Fake]{name}.mp4")


def make_dataset(root: str, *, n_train: int = 2, n_test: int = 1,
                 frames: int = 32, size: int = 64, seed: int = 0,
                 include_originals: bool = True) -> tuple[str, str]:
    """Build a dataset tree and its path lists; returns (train_list,
    test_list)."""
    os.makedirs(root, exist_ok=True)

    def build(split: str, n: int, seed0: int) -> str:
        lines = []
        for i in range(n):
            name = f"{split}{i:03d}"
            fake = make_clip_dir(root, name, frames=frames, size=size,
                                 seed=seed0 + i)
            lines.append(fake)
            if include_originals:
                lines.append(os.path.join(os.path.dirname(fake),
                                          f"[Original]{name}.mp4"))
        list_path = os.path.join(root, f"{split}_list.txt")
        with open(list_path, "w") as f:
            f.write("\n".join(lines) + "\n")
        return list_path

    return build("train", n_train, seed), build("test", n_test, seed + 1000)
