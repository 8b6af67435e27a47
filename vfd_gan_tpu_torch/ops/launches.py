"""The kernels' launch counters, read and reset together.

Each kernel's wrapper adds one to its ``launches`` where it launches its
kernel (the solver kernels also count by plane size, the conv kernel its
bfloat16 launches apart); ``chip_smoke.py`` and the ranks of
``tools/dp_equivalence.py`` set them to 0 before a run and read them
after it.
"""

from __future__ import annotations


def wrappers() -> dict:
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from vfd_gan_tpu_torch.ops import (
        augment,
        flow_fused,
        flow_refine,
        spatial_conv,
        warp,
    )
    from vfd_gan_tpu_torch.ops.int8 import int8_matmul
    from vfd_gan_tpu_torch.ops.morphology import open_planes_cuda

    # int8_matmul is cuBLASLt's int8 GEMM (quant/), no kernel of the port:
    # counted beside the kernels, not on chip_smoke.py's kernels line
    return {"morphology_open": open_planes_cuda,
            "flow_fused": flow_fused.flow_refine_fused_cuda,
            "flow_warp": warp.bilinear_warp_cuda,
            "flow_refine": flow_refine.flow_refine_step_cuda,
            "augment_gather": augment.augment_gather_cuda,
            "conv3x3": spatial_conv.conv3x3_cuda,
            "int8_matmul": int8_matmul}


def reset() -> None:
    for fn in wrappers().values():
        fn.launches = 0
        if hasattr(fn, "launches_by_plane"):
            fn.launches_by_plane.clear()
            fn.fields = 0
    wrappers()["conv3x3"].launches_bf16 = 0


def counts() -> dict:
    """Launches per kernel, and for the solver kernels, which count them by
    plane as well, per ``"kernel@HxW"``."""
    found = {k: fn.launches for k, fn in wrappers().items()}
    # the conv wrapper counts its bfloat16 launches apart
    found["conv3x3_bf16"] = wrappers()["conv3x3"].launches_bf16
    for k, fn in wrappers().items():
        for (h, w), n in getattr(fn, "launches_by_plane", {}).items():
            found[f"{k}@{h}x{w}"] = n
    return found
