"""Banded correlations of the flow pipeline (port of the correlation helpers
of ``vfd_gan_tpu.ops.flow``).

A 1-D correlation with replicate ("edge") border is a dense ``(n, n)``
banded matrix (``_corr_matrix``, vfd_gan_tpu/ops/flow.py:66-85).  The JAX
package multiplies by it with bfloat16 operands and float32 accumulation
(``CORR_DTYPE``, flow.py:88-111): the input and the matrix are each rounded
to bfloat16, and the products are summed in float32.  The port keeps that
contract by rounding both operands to bfloat16 and multiplying the rounded
values in float32 (a bfloat16 x bfloat16 product is exact in float32), so
that the plain PyTorch versions and the CUDA kernels compute the JAX
function.  Both passes of a separable correlation round their input: the W
pass's float32 result is rounded again before the H pass.

``band_table`` gives a kernel the same weights without the zeros: row ``i``
holds the matrix entries of columns ``i - r .. i + r``, 0 outside the
plane.  At the border the clamped taps pile up in one entry, which is
therefore ``bf16(j/k)`` and not ``j * bf16(1/k)``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def _corr_matrix(n: int, taps: tuple, mode: str = "edge") -> np.ndarray:
    """Dense ``(n, n)`` correlation matrix for a 1-D kernel:
    ``out[i] = sum_d taps[d] * in[clamp(i + d - r)]`` (float32; the JAX
    function's loop, so the piled-up border entries round alike)."""
    k = len(taps)
    r = k // 2
    m = np.zeros((n, n), np.float32)
    for i in range(n):
        for d, t in enumerate(taps):
            j = i + d - r
            j = min(max(j, 0), n - 1) if mode == "edge" else j
            if 0 <= j < n:
                m[i, j] += t
    return m


def _key(taps) -> tuple:
    return tuple(np.asarray(taps, np.float32).tolist())


def box_taps(k: int) -> tuple:
    """The ``k``-tap box filter of the flow solve (winsize)."""
    return _key(np.full((k,), 1.0 / k, np.float32))


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to the nearest bfloat16 (ties to even), kept as
    float32."""
    return x.to(torch.bfloat16).to(torch.float32)


# Both tables are made once per (size, taps, device): a copy from pageable
# host memory would wait for all work queued on the card.
@lru_cache(maxsize=None)
def corr_matrix(n: int, taps: tuple, device) -> torch.Tensor:
    """The bfloat16-rounded ``(n, n)`` matrix as float32 on ``device``."""
    return bf16_round(torch.from_numpy(_corr_matrix(n, taps))).to(device)


@lru_cache(maxsize=None)
def band_table(n: int, taps: tuple, device) -> torch.Tensor:
    """``(n, k)`` float32: ``[i, d]`` = the bfloat16-rounded matrix entry
    of column ``i + d - r``, 0 where that column is outside ``[0, n)``."""
    k = len(taps)
    r = k // 2
    m = bf16_round(torch.from_numpy(_corr_matrix(n, taps))).numpy()
    band = np.zeros((n, k), np.float32)
    for i in range(n):
        for d in range(k):
            j = i + d - r
            if 0 <= j < n:
                band[i, d] = m[i, j]
    return torch.from_numpy(band).to(device)


def corr_w(x: torch.Tensor, taps) -> torch.Tensor:
    """Correlation along the last (W) axis of ``(..., H, W)``."""
    m = corr_matrix(x.shape[-1], _key(taps), x.device)
    return torch.matmul(bf16_round(x), m.T)


def corr_h(x: torch.Tensor, taps) -> torch.Tensor:
    """Correlation along the second-to-last (H) axis of ``(..., H, W)``."""
    m = corr_matrix(x.shape[-2], _key(taps), x.device)
    return torch.matmul(m, bf16_round(x))


def sep_corr(x: torch.Tensor, taps_w, taps_h) -> torch.Tensor:
    return corr_h(corr_w(x, taps_w), taps_h)
