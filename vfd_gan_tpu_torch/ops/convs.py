"""Video convolution and pooling (port of ``vfd_gan_tpu.ops.convs``).

The semantics of the JAX functions, on ``F.conv3d`` / ``F.avg_pool3d``.
Signatures, layouts and kernel shapes are the JAX package's: channel-last
``(B, T, H, W, C)`` video, spatial kernels ``(kh, kw, Cin, Cout)``, temporal
``(kt, Cin, Cout)``, full ``(kt, kh, kw, Cin, Cout)``.  The TPU lowerings
(tap-GEMM head, factored conv3d, shifted temporal GEMMs, block pool) are
not carried over: on the card these are cuDNN convolutions.  The modules
(``models/layers.py``) hold torch-layout weights in ``nn.Conv3d`` and call
the same convolutions directly in NCDHW.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vfd_gan_tpu_torch.ops.image import to_channel_first, to_channel_last


def _same_pad_1d(size: int, k: int, stride: int, mode: str) -> tuple[int, int]:
    """lax-style SAME/VALID padding amounts for one dimension."""
    if mode.upper() == "VALID":
        return 0, 0
    out = -(-size // stride)                     # ceil
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pairs(padding, sizes, ksizes, strides) -> list[tuple[int, int]]:
    """``padding`` as an int, a lax padding string or (lo, hi) pairs ->
    one (lo, hi) pair per convolved axis."""
    if isinstance(padding, str):
        return [_same_pad_1d(n, k, s, padding)
                for n, k, s in zip(sizes, ksizes, strides)]
    if isinstance(padding, int):
        return [(padding, padding)] * len(sizes)
    return [(int(lo), int(hi)) for lo, hi in padding]


def _conv_ncdhw(x: torch.Tensor, weight: torch.Tensor, stride,
                pairs: list[tuple[int, int]]) -> torch.Tensor:
    """``F.conv3d`` with per-side padding (asymmetric pads go through F.pad)."""
    if all(lo == hi for lo, hi in pairs):
        return F.conv3d(x, weight, stride=tuple(stride),
                        padding=tuple(lo for lo, _ in pairs))
    flat = [v for lo, hi in reversed(pairs) for v in (lo, hi)]
    return F.conv3d(F.pad(x, flat), weight, stride=tuple(stride))


def spatial_conv(x: torch.Tensor, kernel: torch.Tensor, *, stride: int = 1,
                 padding: int | str = "SAME") -> torch.Tensor:
    """Per-frame 2-D convolution of ``(B, T, H, W, C)`` by a
    ``(kh, kw, Cin, Cout)`` kernel."""
    kh, kw = kernel.shape[:2]
    pairs = _pairs(padding, x.shape[2:4], (kh, kw), (stride, stride))
    weight = kernel.to(x.dtype).permute(3, 2, 0, 1)[:, :, None]
    y = _conv_ncdhw(to_channel_first(x), weight, (1, stride, stride),
                    [(0, 0), *pairs])
    return to_channel_last(y)


def temporal_conv(x: torch.Tensor, kernel: torch.Tensor, *, stride: int = 1,
                  padding: int | str = "SAME") -> torch.Tensor:
    """Per-pixel 1-D convolution along the frame axis of ``(B, T, H, W, C)``
    by a ``(kt, Cin, Cout)`` kernel."""
    pairs = _pairs(padding, x.shape[1:2], kernel.shape[:1], (stride,))
    weight = kernel.to(x.dtype).permute(2, 1, 0)[:, :, :, None, None]
    y = _conv_ncdhw(to_channel_first(x), weight, (stride, 1, 1),
                    [*pairs, (0, 0), (0, 0)])
    return to_channel_last(y)


def conv3d(x: torch.Tensor, kernel: torch.Tensor, *,
           stride: tuple[int, int, int] = (1, 1, 1),
           padding=((1, 1), (1, 1), (1, 1))) -> torch.Tensor:
    """Full 3-D convolution of ``(B, T, H, W, C)`` by a
    ``(kt, kh, kw, Cin, Cout)`` kernel."""
    pairs = _pairs(padding, x.shape[1:4], kernel.shape[:3], stride)
    weight = kernel.to(x.dtype).permute(4, 3, 0, 1, 2)
    return to_channel_last(_conv_ncdhw(to_channel_first(x), weight, stride,
                                       pairs))


def avg_pool3d(x: torch.Tensor, window: tuple[int, int, int],
               stride: tuple[int, int, int] | None = None) -> torch.Tensor:
    """``nn.AvgPool3d`` with VALID padding over (T, H, W) of a
    ``(B, T, H, W, C)`` video."""
    y = F.avg_pool3d(to_channel_first(x), tuple(window),
                     tuple(stride or window))
    return to_channel_last(y)


def avg_pool_ncdhw(x: torch.Tensor, window, stride=None) -> torch.Tensor:
    """``F.avg_pool3d`` of an NCDHW video in its dtype: float32 sums, one
    rounding, as the JAX package's reshape-mean computes it
    (ops/convs.py:430-432).  Torch's CPU kernel has no bfloat16, so there it
    averages a float32 copy and rounds; the CUDA kernel sums bfloat16 in
    float32 itself."""
    if x.dtype == torch.bfloat16 and x.device.type == "cpu":
        return F.avg_pool3d(x.float(), window, stride).to(x.dtype)
    return F.avg_pool3d(x, window, stride)


def max_pool3d(x: torch.Tensor, window: tuple[int, int, int],
               stride: tuple[int, int, int],
               padding: tuple[int, int, int] = (0, 0, 0)) -> torch.Tensor:
    """``nn.MaxPool3d`` with -inf padding over (T, H, W) of a ``(B, T, H,
    W, C)`` video (Xception, xception.py:59).  A tie in a window sends the
    whole gradient to one input here, where the JAX chain of maxima splits
    it."""
    y = F.max_pool3d(to_channel_first(x), tuple(window), tuple(stride),
                     tuple(padding))
    return to_channel_last(y)


def r2plus1d_mid_channels(kt: int, kh: int, kw: int, cin: int, cout: int) -> int:
    """Intermediate width M of a factored (2+1)D conv, from the R(2+1)D paper
    formula the reference uses (models/spatiotempconv.py:44-45)."""
    return int((kt * kh * kw * cin * cout) // (kh * kw * cin + kt * cout))
