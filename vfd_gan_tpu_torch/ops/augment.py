"""Clip augmentation on the device (port of ``vfd_gan_tpu.ops.augment``).

The reference's host pipeline (lib/data.py:123-135) is Resize(1.1*isize)
-> RandomRotation(10) -> RandomCrop(isize) -> RandomHorizontalFlip.  The
host stages clips at S = int(1.1*isize); rotation, crop and flip compose
into one nearest gather per output pixel, with one draw per clip applied
to every frame of the (data, real, mask) triple.  The rotation is
``PIL.Image.rotate``'s (counter-clockwise, nearest, zero fill, centre
(S/2, S/2)): ``src = floor(R(-theta) @ (p + .5 - c) + c)``.

The gather is plain PyTorch indexing, as the JAX default is the XLA gather
(``vfd_gan_tpu/ops/augment.py:112-116``); the opt-in TPU kernel for it is
not on this path.  The draws are arguments of :func:`augment_clips`, so a
test can hand both frameworks the same ones.
"""

from __future__ import annotations

import math

import torch


def staging_size(isize: int) -> int:
    """Host staging resolution: int(isize * 1.1) (lib/data.py:124)."""
    return int(isize * 1.1)


def sample_clip_params(generator: torch.Generator, batch: int, stage: int,
                       isize: int, degrees: float = 10.0,
                       device=None) -> tuple[torch.Tensor, ...]:
    """Per-clip ``(angle_rad, crop_y, crop_x, flip)`` draws from
    ``generator`` (on ``generator``'s device, moved to ``device``)."""
    gdev = generator.device
    angle = (torch.rand(batch, generator=generator, device=gdev)
             * (2 * degrees) - degrees) * (math.pi / 180.0)
    hi = stage - isize + 1       # the reference's randint is inclusive
    crop_y = torch.randint(0, hi, (batch,), generator=generator, device=gdev)
    crop_x = torch.randint(0, hi, (batch,), generator=generator, device=gdev)
    flip = torch.rand(batch, generator=generator, device=gdev) < 0.5
    return tuple(t.to(device) for t in (angle, crop_y, crop_x, flip))


def _src_coords(angle, crop_y, crop_x, flip, s: int, isize: int):
    """Floored float32 ``(src_x, src_y)`` maps ``(B, isize, isize)`` for
    per-clip draws ``(B,)`` (the same float32 arithmetic, in the same
    order, as the JAX function)."""
    dev = angle.device
    cx = cy = s / 2.0
    out = torch.arange(isize, dtype=torch.float32, device=dev)
    # the flip acts on the cropped result: mirror the output column
    out_x = torch.where(flip[:, None], isize - 1.0 - out, out)   # (B, isize)
    cxf = crop_x.to(torch.float32)[:, None]
    cyf = crop_y.to(torch.float32)[:, None]
    x = (out_x + cxf + 0.5 - cx)[:, None, :]                    # (B, 1, isize)
    y = (out[None, :] + cyf + 0.5 - cy)[:, :, None]             # (B, isize, 1)
    a = angle.to(torch.float32)
    cos, sin = torch.cos(a)[:, None, None], torch.sin(a)[:, None, None]
    src_x = torch.floor(cos * x - sin * y + cx)
    src_y = torch.floor(sin * x + cos * y + cy)
    shape = (angle.shape[0], isize, isize)
    return src_x.expand(shape), src_y.expand(shape)


def warp_clips(frames: torch.Tensor, params, isize: int) -> torch.Tensor:
    """Rotate+crop+flip ``(B, T, S, S, C)`` clips by per-clip ``params``
    through one gather; zero outside the source."""
    b, t, s, _, c = frames.shape
    src_x, src_y = _src_coords(*params, s, isize)
    src_x = src_x.to(torch.int64)
    src_y = src_y.to(torch.int64)
    valid = (src_x >= 0) & (src_x < s) & (src_y >= 0) & (src_y < s)
    flat = (src_y.clamp(0, s - 1) * s + src_x.clamp(0, s - 1)).reshape(b, -1)
    bidx = torch.arange(b, device=frames.device)[:, None]
    # advanced indices on dims 0 and 2 -> (B, isize*isize, T, C)
    out = frames.reshape(b, t, s * s, c)[bidx, :, flat]
    out = out.permute(0, 2, 1, 3).reshape(b, t, isize, isize, c)
    return torch.where(valid[:, None, :, :, None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def normalize_clips(data: torch.Tensor, real: torch.Tensor,
                    mask: torch.Tensor):
    """uint8 -> float32: data and real to [-1, 1], the mask to [0, 1]
    (lib/data.py:68,78)."""
    d = data.to(torch.float32) / 255.0 * 2.0 - 1.0
    r = real.to(torch.float32) / 255.0 * 2.0 - 1.0
    m = mask.to(torch.float32) / 255.0
    return d, r, m


def augment_clips(params, data: torch.Tensor, real: torch.Tensor,
                  mask: torch.Tensor, isize: int):
    """Jointly augment a staged uint8 batch ``(B, T, S, S, C)`` by the
    draws ``params = (angle, crop_y, crop_x, flip)`` (see
    :func:`sample_clip_params`); returns float32 ``(data, real, mask)`` of
    ``(B, T, isize, isize, C)``, data and real in [-1, 1], mask in [0, 1]."""
    cd, cr = data.shape[-1], real.shape[-1]
    joint = warp_clips(torch.cat([data, real, mask], dim=-1), params, isize)
    return normalize_clips(joint[..., :cd], joint[..., cd:cd + cr],
                           joint[..., cd + cr:])
