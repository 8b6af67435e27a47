"""Dense optical flow (Farneback-equivalent) and its HSV encoding (port of
``vfd_gan_tpu.ops.flow``).

The reference computes cv2 Farneback flow on the host inside every train
and test step, for the gt and the predicted mask videos (lib/utils.py:
94-129).  The JAX package replaced it with the same algorithm family on
the device: a Gaussian pyramid (3 levels), quadratic polynomial expansion
(poly_n 5, sigma 1.2) through banded correlations, and per level 3 rounds
of {bilinear warp, winsize-15 box-blurred 2x2 solve}.  This module is that
function in PyTorch: the correlations are ``torch.matmul`` against the
banded matrices with the bfloat16-operand contract (``ops/corr.py``), and
the refinement loop of a level goes through the flow kernels.

The layout inside is channel-planar: polynomial planes ``(N, 5, H, W)``
and flow ``(N, 2, H, W)``, as the kernels take them.  The public functions
keep the JAX signatures and channel-last layouts.

``impl`` chooses how a level's refinement loop runs on a CUDA tensor
(JAX chose by environment variables; the port by argument):

* ``"fused"`` (default): one launch of the fused kernel per level
  (JAX's TPU default);
* ``"two_kernel"``: the warp kernel then the refine kernel, per iteration
  (JAX ``VFD_FLOW_REFINE=1``);
* ``"warp"``: the warp kernel inside the plain solve (JAX
  ``VFD_FLOW_FUSED=0``).

On a CPU tensor every ``impl`` is the plain body.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from vfd_gan_tpu_torch.ops.corr import box_taps, corr_h, corr_w, sep_corr
from vfd_gan_tpu_torch.ops.flow_fused import flow_refine_fused
from vfd_gan_tpu_torch.ops.flow_refine import (
    flow_refine_step,
    flow_refine_step_plain,
)
from vfd_gan_tpu_torch.ops.image import minmax_normalize
from vfd_gan_tpu_torch.ops.resize import _resize_axis, resize_bilinear
from vfd_gan_tpu_torch.ops.warp import bilinear_warp

IMPLS = ("fused", "two_kernel", "warp")


@lru_cache(maxsize=None)
def _poly_kernels(n: int, sigma: float):
    """1-D gaussian moment kernels (w, w*x, w*x^2) over [-n, n] and the
    inverse Gram matrix of the quadratic basis {1, x, y, x^2, y^2, xy}
    (flow.py:43-63)."""
    x = np.arange(-n, n + 1, dtype=np.float64)
    w = np.exp(-(x ** 2) / (2 * sigma ** 2))
    w /= w.sum()
    k0, k1, k2 = w, w * x, w * x * x

    def m(p):  # 1-D moment sum w * x^p
        return float((w * x ** p).sum())

    g = np.zeros((6, 6))
    basis_pows = [(0, 0), (1, 0), (0, 1), (2, 0), (0, 2), (1, 1)]
    for i, (pi, qi) in enumerate(basis_pows):
        for j, (pj, qj) in enumerate(basis_pows):
            g[i, j] = m(pi + pj) * m(qi + qj)
    ginv = np.linalg.inv(g)
    return (k0.astype(np.float32), k1.astype(np.float32),
            k2.astype(np.float32), ginv.astype(np.float32))


@lru_cache(maxsize=None)
def _ginv_on(n: int, sigma: float, device: torch.device) -> torch.Tensor:
    """The inverse Gram matrix on ``device``, copied there once (as this
    module's other constants are): a copy from pageable host memory would
    wait for all work queued on the card."""
    return torch.from_numpy(_poly_kernels(n, sigma)[3]).to(device)


def _poly_planes(img: torch.Tensor, n: int = 5,
                 sigma: float = 1.2) -> torch.Tensor:
    """Polynomial expansion of ``(N, H, W)`` images as planes
    ``(N, 5, H, W)`` = (bx, by, axx, ayy, axy)."""
    k0, k1, k2, _ = _poly_kernels(n, sigma)
    x0 = corr_w(img, k0)
    x1 = corr_w(img, k1)
    x2 = corr_w(img, k2)
    c = torch.stack([
        corr_h(x0, k0),   # w
        corr_h(x1, k0),   # w*x
        corr_h(x0, k1),   # w*y
        corr_h(x2, k0),   # w*x^2
        corr_h(x0, k2),   # w*y^2
        corr_h(x1, k1),   # w*x*y
    ], dim=-1)                                    # (N, H, W, 6)
    coeff = torch.matmul(c, _ginv_on(n, sigma, c.device).T)
    return coeff[..., 1:6].permute(0, 3, 1, 2).contiguous()


def poly_expansion(img: torch.Tensor, n: int = 5,
                   sigma: float = 1.2) -> torch.Tensor:
    """Quadratic polynomial expansion of ``(N, H, W)`` images (a trailing
    singleton channel is accepted) -> ``(N, H, W, 5)`` (bx, by, axx, ayy,
    axy) for the local model f(dx) ~ dx^T A dx + b^T dx + c."""
    if img.dim() == 4 and img.shape[-1] == 1:
        img = img[..., 0]
    return _poly_planes(img, n, sigma).permute(0, 2, 3, 1)


def _gauss_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    r = max(1, int(3 * sigma + 0.5))
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x ** 2) / (2 * sigma ** 2))
    taps = (k / k.sum()).astype(np.float32)
    return sep_corr(img, taps, taps)


def _box_blur_stack(stack: torch.Tensor, k: int) -> torch.Tensor:
    """``(N, H, W, C)`` box filter over H, W (flow.py:193-198)."""
    taps = box_taps(k)
    return sep_corr(stack.movedim(-1, 1), taps, taps).movedim(1, -1)


def _flow_level_planar(p1: torch.Tensor, p2: torch.Tensor,
                       flow: torch.Tensor, winsize: int, iterations: int,
                       impl: str = "fused") -> torch.Tensor:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "fused":
        return flow_refine_fused(p1, p2, flow, winsize, iterations)
    solve = flow_refine_step if impl == "two_kernel" \
        else flow_refine_step_plain
    for _ in range(iterations):
        flow = solve(p1, bilinear_warp(p2, flow), flow, winsize)
    return flow


def _flow_level(p1: torch.Tensor, p2: torch.Tensor, flow: torch.Tensor,
                winsize: int, iterations: int,
                impl: str = "fused") -> torch.Tensor:
    """Iterative displacement refinement at one pyramid level.

    p1/p2: polynomial expansions ``(N, H, W, 5)``; flow ``(N, H, W, 2)``
    in (x, y) order.  Returns the refined ``(N, H, W, 2)`` flow.
    ``winsize``: CUDA: 15 only; CPU plain version: any odd value."""
    planar = [t.permute(0, 3, 1, 2).contiguous() for t in (p1, p2, flow)]
    return _flow_level_planar(*planar, winsize, iterations,
                              impl).permute(0, 2, 3, 1)


def _resize_planes(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """``resize_bilinear`` of ``(N, C, H, W)`` planes: H, then W."""
    x = _resize_axis(x, x.dim() - 2, size[0], False)
    return _resize_axis(x, x.dim() - 1, size[1], False)


def farneback_flow(prev: torch.Tensor, cur: torch.Tensor, *,
                   pyr_scale: float = 0.5, levels: int = 3,
                   winsize: int = 15, iterations: int = 3, poly_n: int = 5,
                   poly_sigma: float = 1.2,
                   impl: str = "fused") -> torch.Tensor:
    """Dense flow for grayscale batches ``(N, H, W)`` -> ``(N, H, W, 2)``
    in (x, y) displacement order (cv2 convention).

    ``winsize``: CUDA: 15 only (the ``fused`` and ``two_kernel`` solver
    kernels are built for it and raise for another value; ``impl="warp"``
    solves in plain PyTorch and takes any odd value); CPU plain version:
    any odd value."""
    prev = prev.to(torch.float32)
    cur = cur.to(torch.float32)
    # prev and cur ride one batch through the blur + resize chain
    pyramid = [(prev, cur)]
    both = torch.cat([prev, cur], dim=0)
    for _ in range(1, levels):
        nh = max(2, both.shape[-2] // 2)
        nw = max(2, both.shape[-1] // 2)
        both = resize_bilinear(_gauss_blur(both, 1.0)[..., None],
                               (nh, nw))[..., 0]
        pyramid.append(tuple(both.chunk(2, dim=0)))

    coarse = pyramid[-1][0]
    flow = torch.zeros((coarse.shape[0], 2) + tuple(coarse.shape[-2:]),
                       dtype=torch.float32, device=coarse.device)
    for li in range(levels - 1, -1, -1):
        p, c = pyramid[li]
        if li != levels - 1:
            flow = _resize_planes(flow, tuple(p.shape[-2:])) / pyr_scale
        planes = _poly_planes(torch.cat([p, c], dim=0), poly_n, poly_sigma)
        p1, p2 = planes.chunk(2, dim=0)
        flow = _flow_level_planar(p1.contiguous(), p2.contiguous(),
                                  flow.contiguous(), winsize, iterations,
                                  impl)
    return flow.permute(0, 2, 3, 1)


# (r, g, b) pick (v, q, p, t)[table[sector]] for hue sectors 0..5
_HSV_PICK = torch.tensor([[0, 3, 2], [1, 0, 2], [2, 0, 3],
                          [2, 1, 0], [3, 2, 0], [0, 2, 1]])


@lru_cache(maxsize=None)
def _hsv_pick_on(device: torch.device) -> torch.Tensor:
    return _HSV_PICK.to(device)


def _hsv_to_rgb(h_deg_half: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """OpenCV uint8-style HSV->RGB with S=1: hue in [0, 180), value [0, 1]."""
    h6 = h_deg_half * 2.0 / 60.0
    i = torch.floor(h6)
    f = h6 - i
    p = torch.zeros_like(v)
    q = v * (1.0 - f)
    t = v * f
    sector = torch.remainder(i.to(torch.int64), 6)
    cands = torch.stack([v, q, p, t], dim=-1)
    pick = _hsv_pick_on(v.device)[sector]             # (..., 3)
    return cands.gather(-1, pick)


def flow_to_rgb(flow: torch.Tensor) -> torch.Tensor:
    """HSV-encode flow ``(..., H, W, 2)`` the reference way
    (lib/utils.py:116-120): hue = angle_deg/2, full saturation, value =
    per-frame min-max-normalised magnitude; RGB in [0, 1]."""
    fx, fy = flow[..., 0], flow[..., 1]
    mag = torch.sqrt(fx * fx + fy * fy)
    ang = torch.remainder(torch.rad2deg(torch.atan2(fy, fx)), 360.0)
    v = minmax_normalize(mag, dims=(-2, -1))
    return _hsv_to_rgb(ang * 0.5, v)


def minmax_stretch(video: torch.Tensor, streams: int = 1,
                   dp=None) -> torch.Tensor:
    """RGB video ``(B, T, H, W, 3)`` with each (stream, time slab) min-max
    normalised to [0, 1) over that stream's (B/s, H, W, C).  Under an
    active ``dp`` (``parallel.mesh.DataParallel``) the batch is this
    rank's slice of each stream and the min and the max are the global
    batch's, one all-reduced MAX of ``(max, -min)`` over the ranks that
    hold these frames (under ``--sp`` the dp peers of the rank's shard:
    ``DataParallel.stretch_group``); the same arithmetic otherwise."""
    b, t, h, w, _ = video.shape
    if b % streams:
        raise ValueError(f"batch {b} is not divisible by streams {streams}")
    grouped = video.reshape(streams, b // streams, t, h, w, 3)
    # per (stream, time slab): min and max over that stream's (B/s, H, W, C)
    lo = grouped.amin(dim=(1, 3, 4, 5), keepdim=True)
    hi = grouped.amax(dim=(1, 3, 4, 5), keepdim=True)
    if dp is not None and dp.synced("stretch"):
        both = dp.all_reduce_max_(torch.cat([hi, -lo]), dp.stretch_group)
        hi, lo = both[:streams], -both[streams:]
    return ((grouped - lo) / (hi - lo + 1e-5)).reshape(b, t, h, w, 3)


def stretch_gray(video: torch.Tensor, streams: int = 1,
                 dp=None) -> torch.Tensor:
    """The flow's input: ``minmax_stretch``, then luma times 255,
    ``(B, T, H, W)``."""
    norm = minmax_stretch(video, streams, dp)
    return (0.299 * norm[..., 0] + 0.587 * norm[..., 1]
            + 0.114 * norm[..., 2]) * 255.0


def video_to_flow_rgb(video: torch.Tensor, scale: float = 1.0,
                      streams: int = 1, impl: str = "fused",
                      dp=None) -> torch.Tensor:
    """The reference ``video_to_flow`` on the device.

    RGB video ``(B, T, H, W, 3)`` in [-1, 1] -> flow video of the same
    shape in [-1, 1]: per-time-slab min-max to [0, 1] across the batch
    (``minmax_stretch``), grayscale, Farneback flow over consecutive frames,
    HSV encoding, the last flow frame duplicated to keep T frames.

    ``streams > 1``: the batch is ``streams`` equal contiguous groups (gt
    and predicted masks in one call) and each group's time slabs are
    min-max normalised on their own, as the reference's one call per
    stream does (models/mygannet.py:281-282).  ``scale < 1`` computes the
    flow at ``max(8, int(scale * size))`` and upsamples the RGB.  ``dp``:
    the batch is this rank's slice and the stretch is global (JAX's GSPMD
    min-max, ops/flow.py:414-420 of the JAX package); the rest of the
    flow is per field.  Under ``--sp`` (``dp.sp`` on) ``video`` is this
    rank's frames: the pair of its last frame takes the next shard's
    first gray frame (a right halo of one), and the last shard duplicates
    its own last flow frame."""
    b, t, h, w, _ = video.shape
    gray = stretch_gray(video, streams, dp)

    fh, fw = h, w
    if scale < 1.0:
        fh, fw = max(8, int(h * scale)), max(8, int(w * scale))
        gray = resize_bilinear(gray[..., None], (fh, fw))[..., 0]

    sp = getattr(dp, "sp", None)
    if sp is not None and sp.on:
        if t < 2:
            raise ValueError(f"--sp: a shard of {t} frame(s) has no frame "
                             "pair of its own (nfr / sp must be >= 2)")
        nxt = sp.halo(gray, 1, 1, left=False)
        if sp.index < sp.size - 1:
            gray = nxt
    n = gray.shape[1] - 1
    prev = gray[:, :-1].reshape(b * n, fh, fw)
    cur = gray[:, 1:].reshape(b * n, fh, fw)
    flow = farneback_flow(prev, cur, impl=impl).reshape(b, n, fh, fw, 2)
    rgb = flow_to_rgb(flow)
    if (fh, fw) != (h, w):
        rgb = resize_bilinear(rgb, (h, w))
    if n < t:
        rgb = torch.cat([rgb, rgb[:, -1:]], dim=1)
    return rgb * 2.0 - 1.0
