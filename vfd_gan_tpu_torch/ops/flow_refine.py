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

from collections import Counter

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


# -- how the solver kernels tile a field (ops/cuda/flow_common.cuh) -----------
#
# The kernels cannot run without a card, so the index maps of their tiling
# are restated here, where the CPU tests hold them to the function.

WINSIZE = 15       # the taps the kernels are built for
RADIUS = WINSIZE // 2
RUN = 8            # outputs of a W-pass run: 16 bytes of bfloat16
MAX_ROWS = 4       # most output rows of an H-pass item
THREADS = 256      # most threads of a field's block


def scratch_layout(h: int, w: int) -> tuple[int, int, int]:
    """``(pitch, q_elems, t_elems)`` of one field's bfloat16 scratch.

    Q holds the 5 x H rows of the quantity maps one after the other, each
    row's data ``RUN`` elements in and zeros up to the next row's data; T
    holds ``RADIUS`` zero rows, then per plane H rows of the W-pass map and
    ``RADIUS`` zero rows, then ``MAX_ROWS - 1`` spare rows."""
    pitch = -(-w // RUN) * RUN + RUN
    return (pitch, 5 * h * pitch + RUN,
            (5 * (h + RADIUS) + RADIUS + MAX_ROWS - 1) * pitch)


def q_index(c: int, y: int, x: int, h: int, pitch: int) -> int:
    """Where Q keeps quantity ``c`` of pixel ``(y, x)``."""
    return (c * h + y) * pitch + RUN + x


def t_index(c: int, y: int, x: int, h: int, pitch: int) -> int:
    """Where T keeps the W-pass value of quantity ``c`` at ``(y, x)``."""
    return (c * (h + RADIUS) + RADIUS + y) * pitch + x


def w_run(run: int, row: int, pitch: int) -> tuple[int, range, range]:
    """W-pass item ``run`` of Q row ``row`` (= ``c * h + y``): the first
    output column ``x0``, the Q elements it loads (three 16-byte words:
    columns ``x0 - 8 .. x0 + 15``; tap ``d`` of output ``x0 + o`` is the
    ``o + d + 1``-th of them) and the output columns ``x0 .. x0 + 7`` it
    stores to T as one 16-byte word."""
    x0 = run * RUN
    first = row * pitch + x0
    return x0, range(first, first + 3 * RUN), range(x0, x0 + RUN)


def h_item(group: int, rows: int) -> tuple[range, range]:
    """H-pass item ``group`` of a column: its output rows ``group * rows
    ..`` and the ``rows + 14`` T rows of plane 0 it loads from that column
    (plane ``c``'s lie ``c * (h + RADIUS)`` rows on; tap ``d`` of output
    row ``o`` is the ``o + d``-th of them)."""
    y0 = group * rows
    return range(y0, y0 + rows), range(y0, y0 + rows + WINSIZE - 1)


def interior(first: int, count: int, size: int) -> bool:
    """Whether outputs ``first .. first + count - 1`` of an axis of
    ``size`` all lie at least ``RADIUS`` from both borders: their band
    rows then hold one weight 15 times, which the kernels keep in a
    register."""
    return first >= RADIUS and first + count - 1 + RADIUS < size


def plan_block(h: int, w: int, in_shared: bool = True) -> tuple[int, int]:
    """``(rows, threads)`` of a field's block: ``rows`` is the height of
    an H-pass item, the largest of 4, 2, 1 that still gives half of the
    threads an item each (planes whose scratch lies in the global workspace
    take 4); ``threads`` covers the items of the richer pass."""
    rows = next((r for r in (4, 2)
                 if not in_shared or 2 * w * -(-h // r) >= THREADS), 1)
    pitch = scratch_layout(h, w)[0]
    items = max(w * -(-h // rows), (pitch // RUN - 1) * 5 * h)
    return rows, min(THREADS, 32 * -(-items // 32))


def _launch_solver(wrapper, entry: str, p1, p2, flow, winsize: int,
                   *extra) -> torch.Tensor:
    """Launch one of the two solver kernels (refine or fused) for
    ``wrapper`` and count the launch: they take the same operands, the
    band tables of both axes and, for planes whose scratch does not fit in
    shared memory, a global workspace."""
    from vfd_gan_tpu_torch.ops import cuda

    name = wrapper.__name__
    n, _, h, w = p1.shape
    _check(name, {"p1": p1, "p2": p2, "flow": flow},
           {"p1": (n, 5, h, w), "p2": (n, 5, h, w), "flow": (n, 2, h, w)})
    if winsize != WINSIZE:
        raise ValueError(f"{name}: the kernel is built for winsize "
                         f"{WINSIZE}, got {winsize}")
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
    wrapper.launches += 1
    wrapper.launches_by_plane[(h, w)] += 1
    return out


def flow_refine_step_cuda(p1: torch.Tensor, w2: torch.Tensor,
                          flow: torch.Tensor, winsize: int) -> torch.Tensor:
    """The solve by the hand-written kernel; raises on anything it does not
    take."""
    return _launch_solver(flow_refine_step_cuda, "vfd_flow_refine_f32",
                          p1, w2, flow, winsize)


# Kernel launches since the last reset, in all and by plane size (h, w).
flow_refine_step_cuda.launches = 0
flow_refine_step_cuda.launches_by_plane = Counter()


def flow_refine_step(p1: torch.Tensor, w2: torch.Tensor, flow: torch.Tensor,
                     winsize: int) -> torch.Tensor:
    """One refinement solve on the tensors' device."""
    refuse_grad("flow_refine_step", p1, w2, flow)
    if p1.device.type == "cuda":
        return flow_refine_step_cuda(p1, w2, flow, winsize)
    if p1.device.type == "cpu":
        return flow_refine_step_plain(p1, w2, flow, winsize)
    raise ValueError(f"no refinement solve for device {p1.device}")
