"""The port's models; ``build_mask_model`` picks a supervised mask predictor
(port of ``vfd_gan_tpu.models.build_mask_model``)."""

from __future__ import annotations

import torch

from vfd_gan_tpu_torch.models.convlstm import ConvLSTMModel
from vfd_gan_tpu_torch.models.stcnn import AutoEncoder
from vfd_gan_tpu_torch.models.xception3d import Xception3D

SUPERVISED = ("c2plus1d", "xception", "clstm")


def build_mask_model(name: str, cfg, *, device=None,
                     generator: torch.Generator | None = None):
    """The ``--model`` mask predictor (reference dispatch:
    lib/train_stcnn.py:52-66), with the reference init drawn from
    ``generator``.  As in JAX, only Xception reads ``--ich`` and
    ``--xwidth`` (the others take the 3-channel clips)."""
    kw = {"device": device, "generator": generator}
    if name == "c2plus1d":
        return AutoEncoder(**kw)
    if name == "xception":
        return Xception3D(cfg.ich, cfg.xwidth, **kw)
    if name == "clstm":
        return ConvLSTMModel(**kw)
    raise ValueError(f"unknown supervised model {name!r}; expected one of "
                     f"{SUPERVISED}")
