"""The whole refinement loop of one pyramid level (port of the XLA
``fori_loop`` of ``vfd_gan_tpu.ops.flow._flow_level`` and of the TPU kernel
``vfd_gan_tpu/ops/pallas/flow_fused.py``).

``iterations`` rounds of {warp frame 2's planes by the flow carry
(``ops/warp.py``), refinement solve (``ops/flow_refine.py``)}.  The TPU
kernel also clamps ``|fy|`` to its warp band; the port does not (the
XLA body does not).

:func:`flow_refine_fused` takes the plain PyTorch loop for a CPU tensor
and the hand-written CUDA kernel (``ops/cuda/flow_fused.cu``, all rounds
in one launch) for a CUDA tensor.  Forward-only.
"""

from __future__ import annotations

from collections import Counter

import torch

from vfd_gan_tpu_torch.ops.flow_refine import (
    _launch_solver,
    flow_refine_step_plain,
)
from vfd_gan_tpu_torch.ops.warp import bilinear_warp_plain, refuse_grad


def flow_refine_fused_plain(p1: torch.Tensor, p2: torch.Tensor,
                            flow: torch.Tensor, winsize: int,
                            iterations: int) -> torch.Tensor:
    """``iterations`` rounds of warp + solve in plain PyTorch."""
    for _ in range(iterations):
        flow = flow_refine_step_plain(p1, bilinear_warp_plain(p2, flow),
                                      flow, winsize)
    return flow


def flow_refine_fused_cuda(p1: torch.Tensor, p2: torch.Tensor,
                           flow: torch.Tensor, winsize: int,
                           iterations: int) -> torch.Tensor:
    """All rounds by the hand-written kernel in one launch; raises on
    anything it does not take.  ``winsize``: CUDA: 15 only; CPU plain
    version: any odd value."""
    if iterations < 0:
        raise ValueError(f"iterations must be >= 0, got {iterations}")
    if iterations == 0:
        return flow.clone()
    return _launch_solver(flow_refine_fused_cuda, "vfd_flow_fused_f32",
                          p1, p2, flow, winsize, iterations)


# Kernel launches since the last reset, in all and by plane size (h, w),
# and the flow fields they solved.
flow_refine_fused_cuda.launches = 0
flow_refine_fused_cuda.launches_by_plane = Counter()
flow_refine_fused_cuda.fields = 0


def flow_refine_fused(p1: torch.Tensor, p2: torch.Tensor, flow: torch.Tensor,
                      winsize: int, iterations: int) -> torch.Tensor:
    """The refinement loop of one level on the tensors' device.
    ``winsize``: CUDA: 15 only (the kernel raises for another value); CPU
    plain version: any odd value."""
    refuse_grad("flow_refine_fused", p1, p2, flow)
    if p1.device.type == "cuda":
        return flow_refine_fused_cuda(p1, p2, flow, winsize, iterations)
    if p1.device.type == "cpu":
        return flow_refine_fused_plain(p1, p2, flow, winsize, iterations)
    raise ValueError(f"no refinement loop for device {p1.device}")
