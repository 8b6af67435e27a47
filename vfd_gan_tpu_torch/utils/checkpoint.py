"""Reference-format ``.pth`` checkpoints into the port's modules.

A reference checkpoint is ``torch.save({'epoch', 'state_dict'})``
(lib/train_gan.py:52-57); ``vfd_gan_tpu.cli.export_torch`` writes the same
format from an Orbax run directory.  DataParallel checkpoints carry a
``module.`` prefix, which is stripped (reference lib/utils.py:15-22).
"""

from __future__ import annotations

import torch


def strip_module_prefix(state_dict: dict) -> dict:
    return {(k[7:] if k.startswith("module.") else k): v
            for k, v in state_dict.items()}


def load_state_dict(path: str) -> dict:
    """The ``state_dict`` of a ``.pth`` file, loaded as plain tensors
    (``weights_only=True``: no pickled code runs)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    return strip_module_prefix(blob.get("state_dict", blob))


def has_module(sd: dict, name: str) -> bool:
    """Does ``state_dict`` ``sd`` hold the top-level submodule ``name``?"""
    return any(k.startswith(name + ".") for k in sd)
