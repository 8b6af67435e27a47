"""Morphological opening of mask videos (port of ``vfd_gan_tpu.ops.morphology``).

The reference post-processes predicted masks with a 5x5 cv2 opening
(reference lib/utils.py:139-147): a windowed min with a +inf border
(erode), then a windowed max with a -inf border (dilate).

Plane quirk: the reference hands cv2 a ``(T, H, W)`` array, which cv2 reads
as a T-row x H-column image with W *channels*, so the opening runs in the
**(T, H) plane, independently per W column**.  ``video_open`` keeps it as
``plane="th"`` (the default) and offers the per-frame opening as
``plane="hw"``.

The opening plane is moved to the trailing two axes and made contiguous,
then :func:`open_planes` runs over ``(N, P, Q)`` float32 planes: the
hand-written CUDA kernel (``ops/cuda/morphology_open.cu``) for a CUDA
tensor, the plain PyTorch version below for a CPU tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Opening planes of a channel-last (B, T, H, W, C) mask video.
VIDEO_PLANES = {"th": (1, 2), "hw": (2, 3)}


def open_planes_plain(x: torch.Tensor, k: int = 5) -> torch.Tensor:
    """Opening of ``(N, P, Q)`` planes in plain PyTorch.

    Max pooling pads with -inf, which is exactly the dilate's border; the
    erode is the same pool on the negated input (+inf border)."""
    r = k // 2
    planes = x[:, None]
    eroded = -F.max_pool2d(-planes, k, 1, r)
    return F.max_pool2d(eroded, k, 1, r)[:, 0]


def open_planes_cuda(x: torch.Tensor, k: int = 5) -> torch.Tensor:
    """Opening of contiguous float32 ``(N, P, Q)`` CUDA planes by the
    hand-written kernel.  Raises on anything the kernel does not take."""
    if x.device.type != "cuda":
        raise ValueError(f"open_planes_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"open_planes_cuda needs float32, got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"open_planes_cuda needs (N, P, Q), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("open_planes_cuda needs a contiguous tensor")
    if k < 1 or k % 2 == 0:
        raise ValueError(f"k must be a positive odd int, got {k}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    from vfd_gan_tpu_torch.ops import cuda

    n, p, q = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = cuda.library().vfd_morphology_open_f32(
            x.data_ptr(), out.data_ptr(), n, p, q, k, stream)
    if err != 0:
        raise RuntimeError(
            f"morphology_open kernel failed on {tuple(x.shape)} k={k}: "
            f"cudaError {err}")
    open_planes_cuda.launches += 1
    return out


# Kernel launches since the last reset; read by chip_smoke.py to show that
# the infer path went through the kernel.
open_planes_cuda.launches = 0


def open_planes(x: torch.Tensor, k: int = 5) -> torch.Tensor:
    """Opening of ``(N, P, Q)`` float32 planes on the tensor's device."""
    if x.device.type == "cuda":
        return open_planes_cuda(x, k)
    if x.device.type == "cpu":
        return open_planes_plain(x, k)
    raise ValueError(f"no opening for device {x.device}")


def morphology_open(video: torch.Tensor, k: int = 5,
                    spatial_axes: tuple[int, int] = (-3, -2)) -> torch.Tensor:
    """Opening (erode then dilate) in the plane spanned by ``spatial_axes``
    of a channel-last ``(B, T, H, W, C)`` video (H, W by default).

    Computes in float32 and returns the input dtype."""
    axes = tuple(ax % video.dim() for ax in spatial_axes)
    perm = tuple(i for i in range(video.dim()) if i not in axes) + axes
    # a copy: the kernel takes contiguous planes
    moved = video.permute(perm).to(torch.float32).contiguous()
    opened = open_planes(moved.reshape(-1, *moved.shape[-2:]), k)
    inv = tuple(perm.index(i) for i in range(video.dim()))
    return opened.reshape(moved.shape).permute(inv).to(video.dtype)


def video_open(video: torch.Tensor, plane: str = "th",
               k: int = 5) -> torch.Tensor:
    """Opening of a channel-last ``(B, T, H, W, C)`` mask video in
    ``plane`` (see the module docstring for the "th" quirk)."""
    return morphology_open(video, k, VIDEO_PLANES[plane])
