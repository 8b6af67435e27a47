"""Bilinear flow warp (port of ``vfd_gan_tpu.ops.flow._bilinear_warp`` and
of the TPU kernel ``vfd_gan_tpu/ops/pallas/warp.py``).

Samples channel-planar fields ``(N, C, H, W)`` at ``(x + fx, y + fy)``,
the sample point clamped to the image, bilinearly: x first, then y
(flow.py:172-190).  The TPU kernel's variants v2-v5 are one function in
four TPU formulations; v5 also clamps ``|fy|`` to a band that only made
the TPU's one-hot matmul cheap (PARITY.md "TPU warp band clamp").  The
port implements the XLA body's function, unclamped and in float32.

:func:`bilinear_warp` takes the plain PyTorch version for a CPU tensor
and the hand-written CUDA kernel (``ops/cuda/flow_warp.cu``) for a CUDA
tensor.  The flow feeds only the detached discriminator inputs, so the
warp is forward-only: inputs that require grad are refused.
"""

from __future__ import annotations

import torch


def bilinear_warp_plain(fields: torch.Tensor,
                        flow: torch.Tensor) -> torch.Tensor:
    """``fields (N, C, H, W)`` sampled at the pixel grid plus
    ``flow (N, 2, H, W)`` ((x, y) order), in plain PyTorch."""
    n, c, h, w = fields.shape
    dev = fields.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None] \
        + flow[:, 1]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :] \
        + flow[:, 0]
    ys = ys.clamp(0.0, h - 1.0)
    xs = xs.clamp(0.0, w - 1.0)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = (ys - y0)[:, None]
    wx = (xs - x0)[:, None]
    y0 = y0.to(torch.int64)
    x0 = x0.to(torch.int64)
    y1 = (y0 + 1).clamp(max=h - 1)
    x1 = (x0 + 1).clamp(max=w - 1)
    flat = fields.reshape(n, c, h * w)

    def at(yy, xx):
        idx = (yy * w + xx).reshape(n, 1, h * w).expand(n, c, h * w)
        return flat.gather(2, idx).reshape(n, c, h, w)

    top = at(y0, x0) * (1 - wx) + at(y0, x1) * wx
    bot = at(y1, x0) * (1 - wx) + at(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def _check(name: str, tensors: dict, shapes: dict) -> None:
    """Raise unless every tensor is contiguous float32 on one CUDA device,
    with the given shape."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors on one device, got "
                         f"{sorted(map(str, devices))}")
    for key, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if tuple(t.shape) != tuple(shapes[key]):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shapes[key])}")


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """The flow kernels have no backward (the JAX ones have no VJP)."""
    if any(t.requires_grad for t in tensors):
        raise ValueError(f"{name} is forward-only: pass detached tensors")


def bilinear_warp_cuda(fields: torch.Tensor,
                       flow: torch.Tensor) -> torch.Tensor:
    """The warp by the hand-written kernel; raises on anything it does not
    take."""
    from vfd_gan_tpu_torch.ops import cuda

    n, c, h, w = fields.shape
    _check("bilinear_warp_cuda", {"fields": fields, "flow": flow},
           {"fields": (n, c, h, w), "flow": (n, 2, h, w)})
    out = torch.empty_like(fields)
    if fields.numel():
        cuda.launch("vfd_flow_warp_f32", fields, fields.data_ptr(),
                    flow.data_ptr(), out.data_ptr(), n, c, h, w)
        bilinear_warp_cuda.launches += 1
    return out


# Kernel launches since the last reset; read by chip_smoke.py to show that
# a path went through the kernel.
bilinear_warp_cuda.launches = 0


def bilinear_warp(fields: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp ``fields (N, C, H, W)`` by ``flow (N, 2, H, W)`` on the
    tensors' device."""
    refuse_grad("bilinear_warp", fields, flow)
    if fields.device.type == "cuda":
        return bilinear_warp_cuda(fields, flow)
    if fields.device.type == "cpu":
        return bilinear_warp_plain(fields, flow)
    raise ValueError(f"no warp for device {fields.device}")
