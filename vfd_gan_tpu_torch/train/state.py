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

    def first_moments(self) -> dict[str, torch.Tensor]:
        """Adam's first moment of each parameter, by ``state_dict`` name:
        ``(1 - beta1) g`` after the first step, the gradient as the
        optimizer saw it."""
        return {k: self.optimizer.state[p]["exp_avg"].detach()
                for k, p in self.module.named_parameters()}


def relative_distances(got: dict, want: dict) -> tuple[float, float]:
    """How far one net's tensors (gradients, first moments, running
    statistics) are from another's of the same names in ``want``: the
    median tensor's relative L2 distance and the whole set's."""
    diffs = {k: (got[k].double().cpu() - want[k].double().cpu()).flatten()
             for k in want}
    refs = {k: want[k].double().cpu().flatten() for k in want}
    rel = torch.stack([diffs[k].norm() / refs[k].norm().clamp_min(1e-30)
                       for k in want])
    whole = torch.cat(list(diffs.values())).norm() / torch.cat(
        list(refs.values())).norm()
    return float(rel.median()), float(whole)

