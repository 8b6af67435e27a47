"""3x3 stride-1 SAME convolution of channel-last frames (port of
``vfd_gan_tpu/ops/pallas/spatial_conv.py``).

``conv3x3(x, w)`` convolves ``x (N, H, W, Cin)`` by ``w (3, 3, Cin,
Cout)`` with one pixel of zero padding, float32, any H and W: the function
of ``lax.conv_general_dilated(x, w, (1, 1), SAME, NHWC/HWIO)``, which the
JAX ConvLSTM runs for every gate conv.  It is a
:class:`torch.autograd.Function` with the TPU kernel's custom VJP:

* forward: :func:`conv3x3_forward`, the hand-written CUDA kernel
  (``ops/cuda/conv3x3.cu``: an implicit GEMM on the tensor cores with a
  float32-faithful 3xTF32 split) for CUDA tensors, ``F.conv2d`` for CPU
  tensors;
* dx: the same forward applied to ``dy`` with the spatially flipped,
  in/out-transposed weights (spatial_conv.py:111-115); the kernel reads
  the forward's weights through that index map (``flip``), so no flipped
  copy is made;
* dw: the nine tap products ``x_shifted (N*H*W, Cin)^T @ dy (N*H*W,
  Cout)`` as matrix products (spatial_conv.py:116-123).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The convolution in plain PyTorch (``F.conv2d``, padding 1)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1)


def flipped_weight_index(tap: int, ci: int, co: int, cin: int,
                         cout: int) -> int:
    """Where the dx kernel finds the weight of its tap ``tap`` (``3 * ky +
    kx``), input channel ``ci`` and output channel ``co``, as a flat index
    into the forward's contiguous ``w (3, 3, cout, cin)``: element ``[2 -
    ky][2 - kx][co][ci]``, which is ``w.flip(0, 1).transpose(2, 3)[ky, kx,
    ci, co]``.  ``cin`` and ``cout`` are the dx launch's own (the forward's
    Cout and Cin).  ``ops/cuda/conv3x3.cu::weight_at`` computes the same."""
    return ((8 - tap) * cout + co) * cin + ci


def conv3x3_cuda(x: torch.Tensor, w: torch.Tensor,
                 flip: bool = False) -> torch.Tensor:
    """The convolution by the hand-written kernel: contiguous float32 ``x
    (N, H, W, Cin)`` and ``w (3, 3, Cin, Cout)`` on one CUDA device.  With
    ``flip`` it convolves by ``w.flip(0, 1).transpose(2, 3)`` instead (the
    input gradient of a convolution by ``w (3, 3, Cout, Cin)``), reading
    ``w`` in place.  Raises on anything it does not take."""
    from vfd_gan_tpu_torch.ops import cuda

    name = "conv3x3_cuda"
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"{name} needs CUDA tensors on one device, got "
                         f"{x.device} and {w.device}")
    for key, t in (("x", x), ("w", w)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    cin_axis, cout_axis = (3, 2) if flip else (2, 3)
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3) or (
            w.shape[cin_axis] != x.shape[-1]):
        raise ValueError(f"{name}: x {tuple(x.shape)} and w {tuple(w.shape)}"
                         " are not (N, H, W, Cin) and (3, 3, Cin, Cout)"
                         + (" transposed" if flip else ""))
    n, h, wd, cin = x.shape
    cout = w.shape[cout_axis]
    if n > 65535:
        raise ValueError(f"{name}: at most 65535 frames per call, got {n}")
    out = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    if out.numel():
        cuda.launch("vfd_conv3x3_f32", x, x.data_ptr(), w.data_ptr(),
                    out.data_ptr(), n, h, wd, cin, cout, int(flip))
        conv3x3_cuda.launches += 1
    return out


# Kernel launches (forward and dx) since the last reset; read by
# chip_smoke.py to show that the ConvLSTM went through the kernel.
conv3x3_cuda.launches = 0


def conv3x3_forward(x: torch.Tensor, w: torch.Tensor,
                    flip: bool = False) -> torch.Tensor:
    """The convolution on the tensors' device, without autograd; with
    ``flip`` by ``w.flip(0, 1).transpose(2, 3)`` (see :func:`conv3x3_cuda`)."""
    if x.device.type == "cuda":
        return conv3x3_cuda(x, w, flip)
    if x.device.type == "cpu":
        return conv3x3_plain(x, w.flip(0, 1).transpose(2, 3) if flip else w)
    raise ValueError(f"no conv3x3 for device {x.device}")


def conv3x3_weight_grad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """``dw (3, 3, Cin, Cout)``: per tap, the shifted input's
    ``(N*H*W, Cin)^T @ dy (N*H*W, Cout)``."""
    n, h, wd, cin = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    dy2 = dy.reshape(-1, dy.shape[-1])
    taps = [xp[:, i:i + h, j:j + wd].reshape(-1, cin).t() @ dy2
            for i in range(3) for j in range(3)]
    return torch.stack(taps).reshape(3, 3, cin, dy.shape[-1])


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return conv3x3_forward(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3_forward(dy, w, flip=True)
        if ctx.needs_input_grad[1]:
            dw = conv3x3_weight_grad(x, dy)
        return dx, dw


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME convolution of ``x (N, H, W, Cin)`` by ``w (3, 3,
    Cin, Cout)``, differentiable in both."""
    return _Conv3x3.apply(x.contiguous(), w.contiguous())
