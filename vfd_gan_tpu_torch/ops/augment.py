"""Clip augmentation on the device (port of ``vfd_gan_tpu.ops.augment`` and
of the TPU kernel ``vfd_gan_tpu/ops/pallas/augment.py``).

The reference's host pipeline (lib/data.py:123-135) is Resize(1.1*isize)
-> RandomRotation(10) -> RandomCrop(isize) -> RandomHorizontalFlip.  The
host stages clips at S = int(1.1*isize); rotation, crop and flip compose
into one nearest gather per output pixel, with one draw per clip applied
to every frame of the (data, real, mask) triple.  The rotation is
``PIL.Image.rotate``'s (counter-clockwise, nearest, zero fill, centre
(S/2, S/2)): ``src = floor(R(-theta) @ (p + .5 - c) + c)``.

The floored source coordinates are computed here in PyTorch
(:func:`_src_coords`, the JAX float32 arithmetic in its order) and handed
to :func:`augment_gather`, which gathers the three uint8 streams and
scales them to float32 (video to [-1, 1], the mask to [0, 1]): the
hand-written CUDA kernel (``ops/cuda/augment_gather.cu``) for CUDA
tensors, the plain PyTorch version below for CPU tensors.  The kernel
scales through 256-entry tables computed with the plain version's own
expression, so the two are bit-equal.  The draws are arguments of
:func:`augment_clips`, so a test can hand both frameworks the same ones.
"""

from __future__ import annotations

import math
from functools import lru_cache

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


def warp_clips(frames: torch.Tensor, src_x: torch.Tensor,
               src_y: torch.Tensor) -> torch.Tensor:
    """Nearest gather of ``(B, T, S, S, C)`` clips at the floored source
    coordinates ``(B, isize, isize)``; zero outside the source."""
    b, t, s, _, c = frames.shape
    isize = src_x.shape[-1]
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


def scale_video(x: torch.Tensor) -> torch.Tensor:
    """uint8 video -> float32 in [-1, 1] (lib/data.py:68)."""
    return x.to(torch.float32) / 255.0 * 2.0 - 1.0


def scale_mask(x: torch.Tensor) -> torch.Tensor:
    """uint8 mask -> float32 in [0, 1] (lib/data.py:78)."""
    return x.to(torch.float32) / 255.0


def normalize_clips(data: torch.Tensor, real: torch.Tensor,
                    mask: torch.Tensor):
    """uint8 -> float32: data and real to [-1, 1], the mask to [0, 1]."""
    return scale_video(data), scale_video(real), scale_mask(mask)


def augment_gather_plain(data: torch.Tensor, real: torch.Tensor,
                         mask: torch.Tensor, src_x: torch.Tensor,
                         src_y: torch.Tensor):
    """The gather and the scaling in plain PyTorch."""
    return normalize_clips(*(warp_clips(v, src_x, src_y)
                             for v in (data, real, mask)))


@lru_cache(maxsize=None)
def _tables(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The 256 scaled values of each stream kind, computed on ``device`` by
    the plain version's own expressions (so the kernel rounds as it does),
    once per device."""
    v = torch.arange(256, dtype=torch.uint8, device=device)
    return scale_video(v).contiguous(), scale_mask(v).contiguous()


def augment_gather_cuda(data: torch.Tensor, real: torch.Tensor,
                        mask: torch.Tensor, src_x: torch.Tensor,
                        src_y: torch.Tensor):
    """The gather and the scaling by the hand-written kernel: contiguous
    uint8 ``(B, T, S, S, C*)`` streams and float32 ``(B, isize, isize)``
    coordinates on one CUDA device.  Raises on anything it does not take."""
    from vfd_gan_tpu_torch.ops import cuda

    name = "augment_gather_cuda"
    streams = {"data": data, "real": real, "mask": mask}
    coords = {"src_x": src_x, "src_y": src_y}
    devices = {t.device for t in (*streams.values(), *coords.values())}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors on one device, got "
                         f"{sorted(map(str, devices))}")
    b, t, s = data.shape[:3]
    for key, v in streams.items():
        if v.dtype != torch.uint8:
            raise TypeError(f"{name}: {key} must be uint8, got {v.dtype}")
        if v.dim() != 5 or tuple(v.shape[:4]) != (b, t, s, s):
            raise ValueError(f"{name}: {key} has shape {tuple(v.shape)}, "
                             f"expected ({b}, {t}, {s}, {s}, C)")
    isize = src_x.shape[-1]
    for key, v in coords.items():
        if v.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {v.dtype}")
        if tuple(v.shape) != (b, isize, isize):
            raise ValueError(f"{name}: {key} has shape {tuple(v.shape)}, "
                             f"expected ({b}, {isize}, {isize})")
    for key, v in (*streams.items(), *coords.items()):
        if not v.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    outs = tuple(torch.empty((b, t, isize, isize, v.shape[-1]),
                             dtype=torch.float32, device=v.device)
                 for v in streams.values())
    if not outs[0].numel():
        return outs
    video_table, mask_table = _tables(data.device)
    cuda.launch("vfd_augment_gather_u8", data, data.data_ptr(),
                real.data_ptr(), mask.data_ptr(), src_x.data_ptr(),
                src_y.data_ptr(), video_table.data_ptr(),
                mask_table.data_ptr(), *(o.data_ptr() for o in outs), b, t, s,
                isize, data.shape[-1], real.shape[-1], mask.shape[-1])
    augment_gather_cuda.launches += 1
    return outs


# Kernel launches since the last reset; read by chip_smoke.py to show that
# a training path went through the kernel.
augment_gather_cuda.launches = 0


def augment_gather(data: torch.Tensor, real: torch.Tensor,
                   mask: torch.Tensor, src_x: torch.Tensor,
                   src_y: torch.Tensor):
    """Gather the uint8 ``(B, T, S, S, C*)`` streams at the floored source
    coordinates ``(B, isize, isize)`` and scale them to float32 ``(B, T,
    isize, isize, C*)``, on the tensors' device."""
    if data.device.type == "cuda":
        return augment_gather_cuda(data, real, mask, src_x, src_y)
    if data.device.type == "cpu":
        return augment_gather_plain(data, real, mask, src_x, src_y)
    raise ValueError(f"no augment gather for device {data.device}")


def augment_clips(params, data: torch.Tensor, real: torch.Tensor,
                  mask: torch.Tensor, isize: int):
    """Jointly augment a staged uint8 batch ``(B, T, S, S, C)`` by the
    draws ``params = (angle, crop_y, crop_x, flip)`` (see
    :func:`sample_clip_params`); returns float32 ``(data, real, mask)`` of
    ``(B, T, isize, isize, C)``, data and real in [-1, 1], mask in [0, 1]."""
    src_x, src_y = _src_coords(*params, data.shape[2], isize)
    return augment_gather(data.contiguous(), real.contiguous(),
                          mask.contiguous(), src_x.contiguous(),
                          src_y.contiguous())
