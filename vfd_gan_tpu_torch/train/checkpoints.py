"""Reference-format ``.pth`` checkpoints of the training engine (port of the
naming of ``vfd_gan_tpu.train.checkpoints``).

The reference saves ``{head}_ep{epoch:04d}_netG.pth`` / ``_netD.pth``
pairs, each ``torch.save({'epoch', 'state_dict'})``, when the test sweep's
ROC or PR improves (lib/train_gan.py:52-57).  The port writes the same
files: the reference's ``test.py``, the JAX package's ``.pth`` import and
the port's own loader (``utils/checkpoint.load_state_dict``) read them.
Full train state (Adam moments, RNG, loop cursor) for exact resume is not
ported yet.
"""

from __future__ import annotations

import os

import torch
import torch.nn as nn


def best_ckpt_name(head: str, epoch: int, net: str | None = None) -> str:
    """Reference-style checkpoint names."""
    if net is None:
        return f"{head}_ep{epoch:04d}"
    return f"{head}_ep{epoch:04d}_{net}"


def save_pth(path: str, module: nn.Module, epoch: int) -> None:
    """Write ``{'epoch', 'state_dict'}`` with the tensors on the CPU,
    through a temporary name, so a reader never sees half a file."""
    sd = {k: v.detach().cpu() for k, v in module.state_dict().items()}
    tmp = f"{path}.tmp"
    torch.save({"epoch": int(epoch), "state_dict": sd}, tmp)
    os.replace(tmp, path)
