"""One Farneback refinement solve (port of the XLA body of
``vfd_gan_tpu.ops.flow._flow_level`` and of the TPU kernel
``vfd_gan_tpu/ops/pallas/flow_refine.py``).

From frame 1's polynomial planes ``p1`` and frame 2's planes already
warped by the current flow, ``w2`` (both ``(N, 5, H, W)``: bx, by, axx,
ayy, axy), and that flow ``(N, 2, H, W)``: average the quadratic terms,
build the five normal-equation quantities, box-blur them (winsize, with
the bfloat16-operand contract of ``ops/corr.py``) and solve the 2x2 system
in closed form with ``|det|`` clamped at 1e-9 (flow.py:216-241).

:func:`flow_refine_step` takes the plain PyTorch version for a CPU tensor
and the hand-written CUDA kernel (``ops/cuda/flow_refine.cu``) for a CUDA
tensor.  Forward-only.
"""

from __future__ import annotations

import torch

from vfd_gan_tpu_torch.ops.corr import band_table, box_taps, sep_corr
from vfd_gan_tpu_torch.ops.warp import _check, refuse_grad


def normal_quantities(p1: torch.Tensor, w2: torch.Tensor,
                      flow: torch.Tensor) -> torch.Tensor:
    """The five quantities ``(N, 5, H, W)`` whose blurs give G = A^T A
    and h = A^T db (flow.py:216-233)."""
    b1x, b1y, a1xx, a1yy, a1xy = p1.unbind(1)
    w2bx, w2by, w2xx, w2yy, w2xy = w2.unbind(1)
    fx, fy = flow[:, 0], flow[:, 1]
    axx = (a1xx + w2xx) * 0.5
    ayy = (a1yy + w2yy) * 0.5
    axy = ((a1xy + w2xy) * 0.5) * 0.5          # off-diagonal of A
    dbx = -0.5 * (w2bx - b1x) + axx * fx + axy * fy
    dby = -0.5 * (w2by - b1y) + axy * fx + ayy * fy
    return torch.stack([
        axx * axx + axy * axy,
        axy * (axx + ayy),
        ayy * ayy + axy * axy,
        axx * dbx + axy * dby,
        axy * dbx + ayy * dby,
    ], dim=1)


def solve(blurred: torch.Tensor) -> torch.Tensor:
    """Closed-form 2x2 solve of the blurred quantities -> ``(N, 2, H, W)``."""
    g11, g12, g22, h1, h2 = blurred.unbind(1)
    det = g11 * g22 - g12 * g12
    det = torch.where(det.abs() < 1e-9, torch.full_like(det, 1e-9), det)
    return torch.stack([(g22 * h1 - g12 * h2) / det,
                        (g11 * h2 - g12 * h1) / det], dim=1)


def flow_refine_step_plain(p1: torch.Tensor, w2: torch.Tensor,
                           flow: torch.Tensor,
                           winsize: int) -> torch.Tensor:
    """One refinement solve in plain PyTorch."""
    taps = box_taps(winsize)
    return solve(sep_corr(normal_quantities(p1, w2, flow), taps, taps))


def _launch_solver(name: str, entry: str, p1, p2, flow, winsize: int,
                   *extra) -> torch.Tensor:
    """Launch one of the two solver kernels (refine or fused): they take
    the same operands, the band tables of both axes and, for planes whose
    scratch does not fit in shared memory, a global workspace."""
    from vfd_gan_tpu_torch.ops import cuda

    n, _, h, w = p1.shape
    _check(name, {"p1": p1, "p2": p2, "flow": flow},
           {"p1": (n, 5, h, w), "p2": (n, 5, h, w), "flow": (n, 2, h, w)})
    if winsize < 1 or winsize % 2 == 0:
        raise ValueError(f"{name}: winsize must be a positive odd int, "
                         f"got {winsize}")
    out = torch.empty_like(flow)
    if not n:
        return out
    taps = box_taps(winsize)
    band_h = band_table(h, taps, p1.device)
    band_w = band_table(w, taps, p1.device)
    per_field = cuda.library().vfd_flow_workspace_bytes(h, w, winsize)
    if per_field < 0:
        raise RuntimeError(f"{name}: planes of {h}x{w} are not supported "
                           f"(cudaError {-per_field})")
    workspace = torch.empty(n * per_field, dtype=torch.uint8,
                            device=p1.device)
    cuda.launch(entry, p1, p1.data_ptr(), p2.data_ptr(), flow.data_ptr(),
                band_h.data_ptr(), band_w.data_ptr(), out.data_ptr(),
                workspace.data_ptr() if per_field else None, n, h, w,
                winsize, *extra)
    return out


def flow_refine_step_cuda(p1: torch.Tensor, w2: torch.Tensor,
                          flow: torch.Tensor, winsize: int) -> torch.Tensor:
    """The solve by the hand-written kernel; raises on anything it does not
    take."""
    out = _launch_solver("flow_refine_step_cuda", "vfd_flow_refine_f32",
                         p1, w2, flow, winsize)
    if p1.shape[0]:
        flow_refine_step_cuda.launches += 1
    return out


flow_refine_step_cuda.launches = 0


def flow_refine_step(p1: torch.Tensor, w2: torch.Tensor, flow: torch.Tensor,
                     winsize: int) -> torch.Tensor:
    """One refinement solve on the tensors' device."""
    refuse_grad("flow_refine_step", p1, w2, flow)
    if p1.device.type == "cuda":
        return flow_refine_step_cuda(p1, w2, flow, winsize)
    if p1.device.type == "cpu":
        return flow_refine_step_plain(p1, w2, flow, winsize)
    raise ValueError(f"no refinement solve for device {p1.device}")
