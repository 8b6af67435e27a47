"""Int8 products with int32 sums, the port's counterpart of the JAX
package's ``preferred_element_type=jnp.int32`` convolutions and einsums
(``vfd_gan_tpu/quant/``).

``int8_matmul(a (M, K), b (K, N)) -> int32 (M, N)``:

* on a CUDA tensor, ``torch._int_mm``: cuBLASLt's int8 tensor-core GEMM.
  It takes M > 16 and K, N multiples of 8, so K is padded with zero
  columns of ``a`` and rows of ``b`` (exact: a zero term adds nothing), N
  with zero columns of ``b`` and M with zero rows of ``a``, and the result
  is sliced back.  N is padded to a multiple of 16: from M = 65536 rows
  on, cuBLASLt (CUDA 12.8, H100) has no int8 kernel for N = 8 (mod 16) at
  N >= 40 when K is a multiple of 16 below 128 (``CUBLAS_STATUS_NOT_
  SUPPORTED``), and every N that is a multiple of 16 runs.  ``b`` goes in
  column-major (a transposed view of an ``(N, K)`` tensor);
* on a CPU tensor, the plain version: a float64 matmul of the int8
  values, cast to int32.  It is exact: every partial sum is an integer
  of magnitude at most 127^2 K < 2^31 <= 2^53 for the K of the port's
  convolutions (at most 9 x 2048).

``conv3d_i8`` is a convolution of a channel-last int8 video as one
``int8_matmul`` per kernel tap, summed in int32 (the lowering of the JAX
package's shifted temporal GEMMs, ``quant/qmygan.py::_temporal_conv_i8``,
applied to every tap): no im2col buffer, so the peak is one tap's rows
beside the int32 sum.  int32 sums are exact in any order, so the result
equals an XLA int8 convolution's bit for bit.

``int8_matmul.launches`` counts the ``_int_mm`` calls.
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F


def _ceil(n: int, m: int = 8) -> int:
    return -(-n // m) * m


def int8_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The exact int32 product of int8 ``a (M, K)`` and ``b (K, N)``."""
    return (a.double() @ b.double()).to(torch.int32)


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int32 ``a @ b`` of int8 ``a (M, K)`` and ``b (K, N)``: cuBLASLt's
    int8 GEMM on a CUDA tensor, the plain version on a CPU tensor."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8_matmul takes int8 operands, got {a.dtype} "
                        f"and {b.dtype}")
    if a.device.type == "cpu":
        return int8_matmul_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"int8_matmul: no path for {a.device}")
    (m, k), n = a.shape, b.shape[1]
    mp, kp, np_ = max(m, 17), _ceil(k), _ceil(n, 16)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    bt = b.t()                                        # (N, K)
    if (np_, kp) != (n, k):
        bt = F.pad(bt, (0, kp - k, 0, np_ - n))
    out = torch._int_mm(a.contiguous(), bt.contiguous().t())
    int8_matmul.launches += 1
    return out if (mp, np_) == (m, n) else out[:m, :n]


# _int_mm calls since the last reset; read by chip_smoke.py to show that a
# path ran its products on the card's int8 GEMM
int8_matmul.launches = 0


def conv3d_i8(xq: torch.Tensor, w_taps: torch.Tensor,
              kernel: tuple[int, int, int],
              stride: tuple[int, int, int] = (1, 1, 1),
              padding: tuple[int, int, int] = (0, 0, 0)) -> torch.Tensor:
    """int32 convolution of a channel-last int8 video ``xq (B, T, H, W,
    Cin)`` by int8 taps ``w_taps (kt*kh*kw, Cout, Cin)`` (row-major over
    ``(kt, kh, kw)``), with symmetric zero ``padding`` per axis; returns
    ``(B, To, Ho, Wo, Cout)``."""
    b, t, h, w, cin = xq.shape
    cout = w_taps.shape[1]
    (kt, kh, kw), (st, sh, sw), (pt, ph, pw) = kernel, stride, padding
    cp = _ceil(cin) if xq.device.type == "cuda" else cin
    if (pt, ph, pw) != (0, 0, 0) or cp != cin:
        # the zero channels align K for the card's GEMM once, not per tap
        xq = F.pad(xq, (0, cp - cin, pw, pw, ph, ph, pt, pt))
        w_taps = F.pad(w_taps, (0, cp - cin))
    to = (t + 2 * pt - kt) // st + 1
    ho = (h + 2 * ph - kh) // sh + 1
    wo = (w + 2 * pw - kw) // sw + 1
    acc = None
    for i, (dt, dh, dw) in enumerate(itertools.product(
            range(kt), range(kh), range(kw))):
        rows = xq[:, dt:dt + st * (to - 1) + 1:st,
                  dh:dh + sh * (ho - 1) + 1:sh,
                  dw:dw + sw * (wo - 1) + 1:sw].reshape(-1, cp)
        term = int8_matmul(rows, w_taps[i].t())
        acc = term if acc is None else acc.add_(term)
    return acc.reshape(b, to, ho, wo, cout)
