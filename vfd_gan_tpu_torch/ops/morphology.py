"""Morphological opening of mask videos (port of ``vfd_gan_tpu.ops.morphology``).

The reference post-processes predicted masks with a 5x5 cv2 opening
(reference lib/utils.py:139-147): a windowed min with a +inf border
(erode), then a windowed max with a -inf border (dilate).

Plane quirk: the reference hands cv2 a ``(T, H, W)`` array, which cv2 reads
as a T-row x H-column image with W *channels*, so the opening runs in the
**(T, H) plane, independently per W column**.  ``video_open`` keeps it as
``plane="th"`` (the default) and offers the per-frame opening as
``plane="hw"``.

On a CUDA tensor the video is opened where it lies: the hand-written
kernel (``ops/cuda/morphology_open.cu``) walks the two window axes, the
axes before them and the axes after them by their strides, and writes a
result that is contiguous in the video's own layout, so nothing is copied
before or after the launch.  On a CPU tensor the plain PyTorch version
below runs over ``(N, P, Q)`` planes moved to the trailing axes.
"""

from __future__ import annotations

import math

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


def _walk(shape, strides):
    """``(size, stride)`` that walks a run of axes as one axis, or None
    where no single stride does (axes of size 1 are skipped)."""
    dims = [(n, st) for n, st in zip(shape, strides) if n != 1]
    for (_, outer), (n, inner) in zip(dims, dims[1:]):
        if outer != n * inner:
            return None
    return math.prod(shape), dims[-1][1] if dims else 0


def _layout(x: torch.Tensor, axes: tuple[int, int]):
    """``x`` as the kernel's four axes (O, P, Q, L): sizes and element
    strides, or None where ``x`` cannot be walked so without a copy: the
    window axes are neighbours, and what lies before and after them each
    has one stride."""
    a, b = sorted(ax % x.dim() for ax in axes)
    if b != a + 1:
        return None
    shape, strides = x.shape, x.stride()
    outer = _walk(shape[:a], strides[:a])
    lanes = _walk(shape[b + 1:], strides[b + 1:])
    if outer is None or lanes is None:
        return None
    sizes = (outer[0], shape[a], shape[b], lanes[0])
    return sizes, (outer[1], strides[a], strides[b], lanes[1])


def open_planes_cuda(x: torch.Tensor, k: int = 5,
                     axes: tuple[int, int] = (-2, -1),
                     tile: tuple[int, int, int] = (0, 0, 0)) -> torch.Tensor:
    """Opening of a float32 CUDA tensor over its two ``axes`` (the trailing
    ones by default: ``(N, P, Q)`` planes) by the hand-written kernel, which
    reads ``x`` by its strides.  Returns a contiguous tensor of ``x``'s
    shape.  ``tile`` is one block's ``(tp, tq, tl)`` outputs along the
    window axes and the lanes; 0 leaves the choice to the kernel's entry
    point.  Raises on anything the kernel does not take."""
    if x.device.type != "cuda":
        raise ValueError(f"open_planes_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"open_planes_cuda needs float32, got {x.dtype}")
    if x.dim() < 2:
        raise ValueError(f"open_planes_cuda needs two window axes, got shape "
                         f"{tuple(x.shape)}")
    if k < 1 or k % 2 == 0:
        raise ValueError(f"k must be a positive odd int, got {k}")
    layout = _layout(x, axes)
    if layout is None:
        raise ValueError(
            f"open_planes_cuda cannot walk shape {tuple(x.shape)} with "
            f"strides {x.stride()} over axes {tuple(axes)} in place: the "
            "window axes must be neighbours, and the axes before and after "
            "them must each have one stride")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    from vfd_gan_tpu_torch.ops import cuda

    sizes, x_strides = layout
    _, out_strides = _layout(out, axes)
    cuda.launch("vfd_morphology_open_f32", x, x.data_ptr(), out.data_ptr(),
                *sizes, *x_strides, *out_strides, k, *tile)
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

    Computes in float32 and returns the input dtype, contiguous in the
    video's layout.  A CUDA video is opened in place by one kernel launch
    (a video whose layout the kernel cannot walk is made contiguous
    first; the default planes of a contiguous video never are)."""
    axes = tuple(ax % video.dim() for ax in spatial_axes)
    if video.device.type == "cuda" and abs(axes[0] - axes[1]) == 1:
        x = video.to(torch.float32)
        if _layout(x, axes) is None:
            x = x.contiguous()
        return open_planes_cuda(x, k, axes).to(video.dtype)
    perm = tuple(i for i in range(video.dim()) if i not in axes) + axes
    moved = video.permute(perm).to(torch.float32).contiguous()
    opened = open_planes(moved.reshape(-1, *moved.shape[-2:]), k)
    inv = tuple(perm.index(i) for i in range(video.dim()))
    return opened.reshape(moved.shape).permute(inv).to(
        video.dtype).contiguous()


def video_open(video: torch.Tensor, plane: str = "th",
               k: int = 5) -> torch.Tensor:
    """Opening of a channel-last ``(B, T, H, W, C)`` mask video in
    ``plane`` (see the module docstring for the "th" quirk)."""
    return morphology_open(video, k, VIDEO_PLANES[plane])
