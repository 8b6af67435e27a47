"""The port's own cv2 video decode/encode (``vfd_gan_tpu_torch/data/
video_io.py``) against the JAX package's: a clip written by the port reads
back to equal arrays and frame counts through both packages."""

import builtins

import numpy as np
import pytest

from vfd_gan_tpu.data import video_io as jax_io
from vfd_gan_tpu_torch.data import video_io as port_io

T, H, W = 7, 24, 32


def _clip(seed=0):
    """Smooth frames: blocks of 8 x 8 pixels, so that mp4v keeps them close."""
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 256, (T, H // 8, W // 8, 3), dtype=np.uint8)
    return coarse.repeat(8, axis=1).repeat(8, axis=2)


@pytest.mark.parametrize("resize_to", [None, (16, 20)], ids=["native",
                                                             "resized"])
@pytest.mark.parametrize("first,count", [(0, T), (2, 4), (5, 4)],
                         ids=["whole", "window", "past_the_end"])
def test_clip_written_by_the_port_reads_back_equal_in_both(tmp_path, first,
                                                           count, resize_to):
    path = str(tmp_path / "sub" / "clip.mp4")
    frames = _clip()
    port_io.write_video(path, frames)
    assert port_io.count_frames(path) == jax_io.count_frames(path) == T
    got = port_io.read_clip(path, first, count, resize_to=resize_to)
    want = jax_io.read_clip(path, first, count, resize_to=resize_to)
    assert got.dtype == np.uint8
    assert got.shape == (count,) + (resize_to or (H, W)) + (3,)
    np.testing.assert_array_equal(got, want)
    if resize_to is None:
        # the codec is lossy; the block frames come back close
        real = min(count, T - first)
        err = np.abs(got[:real].astype(int) - frames[first:first + real])
        assert err.mean() < 8


def test_both_writers_make_the_same_file_content(tmp_path):
    frames = _clip(1)
    a, b = str(tmp_path / "a" / "v.mp4"), str(tmp_path / "b" / "v.mp4")
    port_io.write_video(a, frames, fps=5)
    jax_io.write_video(b, frames, fps=5)
    np.testing.assert_array_equal(port_io.read_clip(a, 0, T),
                                  port_io.read_clip(b, 0, T))


def test_missing_files_and_missing_cv2(tmp_path, monkeypatch):
    missing = str(tmp_path / "nope.mp4")
    assert port_io.count_frames(missing) <= 0
    with pytest.raises(FileNotFoundError):
        port_io.read_clip(missing, 0, 4)

    real_import = builtins.__import__

    def no_cv2(name, *args, **kwargs):
        if name == "cv2":
            raise ImportError("No module named 'cv2'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    with pytest.raises(ImportError, match="cv2"):
        port_io.count_frames(missing)
