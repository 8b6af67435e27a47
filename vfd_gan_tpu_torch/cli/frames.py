"""Dump a dataset's mp4 clips as PNG frames (port of
``vfd_gan_tpu.cli.frames``, the reference's ``mp4_to_png.py`` without its
hardcoded paths).

Walks ``--src`` for ``<group>/<clip>/[Fake|Original|Mask]*.mp4`` and writes
every frame as ``%06d.png`` under ``--dst/<group>/<clip>/{inpaint,
original,mask}/``, the mask videos inverted (``cv2.bitwise_not``,
mp4_to_png.py:43-44).  cv2 is imported on use.

Usage::

    python -m vfd_gan_tpu_torch.cli.frames --src data/ --dst frames/
"""

from __future__ import annotations

import argparse
import glob
import os

KIND = {"Fake": ("inpaint", False), "Original": ("original", False),
        "Mask": ("mask", True)}


def dump_video(video_path: str, out_dir: str, invert: bool) -> int:
    """Write the frames of one video; returns their number."""
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    count = 0
    try:
        while True:
            ret, frame = cap.read()
            if not ret:
                break
            count += 1
            if invert:
                frame = cv2.bitwise_not(frame)
            cv2.imwrite(os.path.join(out_dir, "%06d.png" % count), frame)
    finally:
        cap.release()
    return count


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="mp4 -> png frame dump")
    p.add_argument("--src", required=True, help="dataset root to walk")
    p.add_argument("--dst", required=True, help="output root")
    args = p.parse_args(argv)

    for video in sorted(glob.glob(os.path.join(args.src, "**", "*.mp4"),
                                  recursive=True)):
        base = os.path.splitext(os.path.basename(video))[0]
        kind = next((v for k, v in KIND.items() if f"[{k}]" in base), None)
        if kind is None:
            continue
        subdir, invert = kind
        clip = base.rsplit("]", 1)[-1]
        rel = os.path.relpath(os.path.dirname(video), args.src)
        out_dir = os.path.join(args.dst, rel, clip, subdir)
        n = dump_video(video, out_dir, invert)
        print(f"{video} -> {out_dir} ({n} frames)")


if __name__ == "__main__":
    main()
