"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    """The device an entry point runs on.  ``cuda`` without a card raises:
    nothing drops to the CPU on its own.

    On CUDA, TF32 is switched off for convolutions and matmuls, so the
    card's float32 forward is the same function as the CPU reference
    (cuDNN convolutions default to TF32)."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {name}: CUDA is not available "
                             "(use --device cpu explicitly)")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    elif device.type != "cpu":
        raise SystemExit(f"--device {name}: only cuda and cpu are supported")
    return device
