"""Training state of one network (port of ``vfd_gan_tpu.train.state``).

The JAX package keeps parameters, BatchNorm running statistics and Adam
state in an explicit pytree (``NetState``); here the module holds the
first two and the optimizer the third.  ``NetState`` pairs them.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn


def make_adam(params, lr: float, beta1: float = 0.5) -> torch.optim.Adam:
    """Adam with the reference's hyperparameters: betas (beta1, 0.999),
    eps 1e-8 (models/mygannet.py:270-273)."""
    return torch.optim.Adam(params, lr=lr, betas=(beta1, 0.999), eps=1e-8)


@dataclasses.dataclass
class NetState:
    """A network and its optimizer."""

    module: nn.Module
    optimizer: torch.optim.Optimizer

    @classmethod
    def create(cls, module: nn.Module, lr: float,
               beta1: float = 0.5) -> "NetState":
        return cls(module, make_adam(module.parameters(), lr, beta1))
