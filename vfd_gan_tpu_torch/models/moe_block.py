"""Residual token-MoE block (port of ``vfd_gan_tpu.models.moe_block``).

No reference equivalent: the JAX package's opt-in ``--moe_experts N``
variant of Xception-3D puts this block after the eight middle blocks.
Every spatio-temporal position of the trunk is a token, routed top-1 to
one of N expert MLPs (C -> C -> C, ReLU) by ``parallel/moe.py``, and the
block adds the result to its input.

Parameters keep the JAX names and layouts: ``router (C, E)`` and the
stacked ``experts_w1 (E, C, C)``, ``experts_b1 (E, C)``, ``experts_w2``,
``experts_b2``, applied as ``h @ w + b``; weights ~ N(0, 0.02) from the
passed ``torch.Generator``, biases zero.  Tokens are the NCDHW input read
in channel-last order ``(B, T, H, W)`` (the order in which JAX's
``x.reshape(-1, C)`` lists them, which sets who is dropped past the
capacity), cast to ``dtype``; the router stays float32.

``forward`` leaves the layer's ``aux`` (the load-balancing loss and the
dropped fraction) on ``self.aux``: the supervised engine adds
``--moe_aux_w`` times the loss to a train-mode objective, as the JAX
engine sums the ``moe_aux`` collection.  ``choice``, when set, routes the
next forwards by those expert indices instead of the router's argmax
(``parallel.moe.moe_apply``).  Bound to a ``parallel.mesh.DataParallel``
(``dp``, ``--dp``) and active, a forward routes over the global token
axis (the test sweep runs with ``dp`` inactive: every rank runs it
whole).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from vfd_gan_tpu_torch.parallel.moe import moe_apply
from vfd_gan_tpu_torch.utils.init import dcgan_normal_


class MoEMlp(nn.Module):
    """Top-1 token MoE over NCDHW features with a residual add."""

    # a parallel.mesh.DataParallel: the routing's global token axis
    dp = None

    def __init__(self, channels: int, n_experts: int, *,
                 capacity_factor: float = 2.0,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        c, e = channels, n_experts
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.router = nn.Parameter(torch.empty(c, e, device=device))
        self.experts_w1 = nn.Parameter(torch.empty(e, c, c, device=device))
        self.experts_b1 = nn.Parameter(torch.zeros(e, c, device=device))
        self.experts_w2 = nn.Parameter(torch.empty(e, c, c, device=device))
        self.experts_b2 = nn.Parameter(torch.zeros(e, c, device=device))
        if generator is not None:
            for w in (self.router, self.experts_w1, self.experts_w2):
                dcgan_normal_(w, generator)
        self.aux: dict | None = None
        self.choice: torch.Tensor | None = None

    def _experts(self, h: torch.Tensor) -> torch.Tensor:
        d = h.dtype
        h = F.relu(torch.matmul(h, self.experts_w1.to(d))
                   + self.experts_b1.to(d)[:, None])
        return torch.matmul(h, self.experts_w2.to(d)) \
            + self.experts_b2.to(d)[:, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[1]
        tokens = x.permute(0, 2, 3, 4, 1).reshape(-1, c).to(self.dtype)
        y, self.aux = moe_apply(self._experts, self.router, tokens,
                                capacity_factor=self.capacity_factor,
                                choice=self.choice,
                                dp=self.dp)
        y = y.to(x.dtype).view(x.shape[0], *x.shape[2:], c)
        return x + y.permute(0, 4, 1, 2, 3)
