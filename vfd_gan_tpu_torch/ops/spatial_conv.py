"""3x3 stride-1 SAME convolution of channel-last frames (port of
``vfd_gan_tpu/ops/pallas/spatial_conv.py``).

``conv3x3(x, w)`` convolves ``x (N, H, W, Cin)`` by ``w (3, 3, Cin,
Cout)`` with one pixel of zero padding, any H and W: the function of
``lax.conv_general_dilated(x, w, (1, 1), SAME, NHWC/HWIO)``, which the
JAX ConvLSTM runs for every gate conv.  ``x`` is float32 or bfloat16; ``w``
is cast to ``x``'s dtype, as ``conv3x3_pallas`` casts it, and sums are
float32 (``preferred_element_type``) rounded once to ``x``'s dtype.  It is
a :class:`torch.autograd.Function` with the TPU kernel's custom VJP:

* forward: :func:`conv3x3_forward`, the hand-written CUDA kernel
  (``ops/cuda/conv3x3.cu``: an implicit GEMM on the tensor cores, float32
  with a float32-faithful 3xTF32 split, bfloat16 in one pass) for CUDA
  tensors, :func:`conv3x3_plain` for CPU tensors;
* dx: the same forward applied to ``dy`` (in ``x``'s dtype) with the
  spatially flipped, in/out-transposed weights (spatial_conv.py:110-115);
  the kernel reads the forward's weights through that index map
  (``flip``), so no flipped copy is made;
* dw: the nine tap products ``x_shifted (N*H*W, Cin)^T @ dy (N*H*W,
  Cout)`` as matrix products in float32, also from bfloat16 operands
  (spatial_conv.py:116-123), returned in ``w``'s dtype as the TPU
  kernel's VJP returns it: a float32 weight gets an unrounded float32
  gradient, a weight its caller cast to bfloat16 a rounded one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The convolution in plain PyTorch (``F.conv2d``, padding 1); in
    bfloat16: float32 products and sums of the bfloat16 operands, rounded
    once to bfloat16."""
    if x.dtype == torch.bfloat16:
        return conv3x3_plain(x.float(), w.float()).to(torch.bfloat16)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1)


def bf16_ulps(got: torch.Tensor, want: torch.Tensor,
              slack: torch.Tensor | float = 0.0) -> torch.Tensor:
    """``|got - want|`` beyond ``slack``, in bfloat16 ulps (8 significant
    bits) of the larger of the two: how a bfloat16 result of the kernel is
    held against its plain version."""
    g, w = got.double(), want.double()
    big = torch.maximum(g.abs(), w.abs()).clamp_min(1e-30)
    return ((g - w).abs() - slack).clamp_min(0) / torch.exp2(
        torch.floor(torch.log2(big)) - 7)


def conv_sum_slack(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """What two float32 sums of the K = 9 Cin products of ``conv3x3(x, w)``
    may differ by in any two orders, one of them truncating (the tensor
    cores' return): K 2^-22 sum |x w|.  Where the products cancel, that is
    many bfloat16 ulps of the result."""
    mag = conv3x3_plain(x.float().abs(), w.float().abs())
    return 9 * x.shape[-1] * 2.0 ** -22 * mag


def flipped_weight_index(tap: int, ci: int, co: int, cin: int,
                         cout: int) -> int:
    """Where the dx kernel finds the weight of its tap ``tap`` (``3 * ky +
    kx``), input channel ``ci`` and output channel ``co``, as a flat index
    into the forward's contiguous ``w (3, 3, cout, cin)``: element ``[2 -
    ky][2 - kx][co][ci]``, which is ``w.flip(0, 1).transpose(2, 3)[ky, kx,
    ci, co]``.  ``cin`` and ``cout`` are the dx launch's own (the forward's
    Cout and Cin).  ``ops/cuda/conv3x3.cu::weight_at`` computes the same."""
    return ((8 - tap) * cout + co) * cin + ci


# the C entry of each dtype the kernel takes
_ENTRIES = {torch.float32: "vfd_conv3x3_f32",
            torch.bfloat16: "vfd_conv3x3_bf16"}


def conv3x3_cuda(x: torch.Tensor, w: torch.Tensor,
                 flip: bool = False) -> torch.Tensor:
    """The convolution by the hand-written kernel: contiguous ``x (N, H, W,
    Cin)`` and ``w (3, 3, Cin, Cout)`` of one dtype, float32 or bfloat16,
    on one CUDA device.  With ``flip`` it convolves by ``w.flip(0,
    1).transpose(2, 3)`` instead (the input gradient of a convolution by
    ``w (3, 3, Cout, Cin)``), reading ``w`` in place.  Raises on anything it
    does not take."""
    from vfd_gan_tpu_torch.ops import cuda

    name = "conv3x3_cuda"
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"{name} needs CUDA tensors on one device, got "
                         f"{x.device} and {w.device}")
    if x.dtype not in _ENTRIES or w.dtype != x.dtype:
        raise TypeError(f"{name}: x and w must both be float32 or both "
                        f"bfloat16, got {x.dtype} and {w.dtype}")
    for key, t in (("x", x), ("w", w)):
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
        cuda.launch(_ENTRIES[x.dtype], x, x.data_ptr(), w.data_ptr(),
                    out.data_ptr(), n, h, wd, cin, cout, int(flip))
        if x.dtype == torch.float32:
            conv3x3_cuda.launches += 1
        else:
            conv3x3_cuda.launches_bf16 += 1
    return out


# Kernel launches (forward and dx) since the last reset, float32 and
# bfloat16 apart; read by chip_smoke.py to show that the ConvLSTM went
# through the kernel of its dtype.
conv3x3_cuda.launches = 0
conv3x3_cuda.launches_bf16 = 0


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
    """``dw (3, 3, Cin, Cout)`` in float32: per tap, the shifted input's
    ``(N*H*W, Cin)^T @ dy (N*H*W, Cout)``; bfloat16 operands are widened
    first, so each product is exact and the sums are float32 (TF32 is off
    on the card)."""
    if x.dtype == torch.bfloat16:
        x, dy = x.float(), dy.float()
    n, h, wd, cin = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    dy2 = dy.reshape(-1, dy.shape[-1])
    taps = [xp[:, i:i + h, j:j + wd].reshape(-1, cin).t() @ dy2
            for i in range(3) for j in range(3)]
    return torch.stack(taps).reshape(3, 3, cin, dy.shape[-1])


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        wc = w.to(x.dtype).contiguous()
        ctx.save_for_backward(x, wc)
        ctx.w_dtype = w.dtype
        return conv3x3_forward(x, wc)

    @staticmethod
    def backward(ctx, dy):
        x, wc = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3_forward(dy, wc, flip=True)
        if ctx.needs_input_grad[1]:
            dw = conv3x3_weight_grad(x, dy).to(ctx.w_dtype)
        return dx, dw


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME convolution of ``x (N, H, W, Cin)`` by ``w (3, 3,
    Cin, Cout)``, differentiable in both; ``w`` is cast to ``x``'s dtype
    for the products and its gradient comes back in ``w``'s dtype."""
    return _Conv3x3.apply(x.contiguous(), w)
