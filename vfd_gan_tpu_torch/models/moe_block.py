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
capacity), cast to ``dtype`` (a float64 input stays float64); the router
stays float32.

``forward`` leaves the layer's ``aux`` (the load-balancing loss and the
dropped fraction) on ``self.aux``: the supervised engine adds
``--moe_aux_w`` times the loss to a train-mode objective, as the JAX
engine sums the ``moe_aux`` collection.  ``choice``, when set, routes the
next forwards by those expert indices instead of the router's argmax
(``parallel.moe.moe_apply``).  Bound to a ``parallel.mesh.DataParallel``
(``dp``, ``--dp``) and active, a forward routes over the global token
axis; under ``--sp`` its input is the rank's frames of its rows, and in
the ``--sp`` test sweep (``dp`` inactive, each rank of a row its frames
of the whole batch) it routes over the row.  ``routing`` keeps the last
forward's slots and kept flags.

Under ``--moe_shards N`` the block holds the rank's experts alone:
``experts_w1/b1/w2/b2`` are ``(E/N, ...)``, rows ``[j E/N, (j+1) E/N)``
of the canonical tensors, the router whole.  The initialiser draws the
whole ``(E, ...)`` tensors from the passed generator and the engine keeps
the slice (``parallel/tensor.StateShards``), so the weights do not depend
on N; its ``whole`` gathers them for a checkpoint.

Under ``--tp N`` (a ``parallel.mesh.TensorParallel`` bound as ``tp``)
each leaf holds the rank's slice of its last axis where N divides it, as
JAX's ``param_spec`` shards it (``parallel/tensor.StateShards``): the
router's logits are computed on the rank's columns and gathered, so the
routing, the capacity and the load-balancing loss run on the whole
logits; the experts' hidden slice is gathered before ``experts_w2`` and
their output slice after it, each product behind a ``copy_in``.  Under
tp x ep the experts are the ep axis's (``expert_tensors``), whole on every
tp rank of an ep rank, and the router alone is split.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from vfd_gan_tpu_torch.parallel.moe import moe_apply, router_logits
from vfd_gan_tpu_torch.parallel.tensor import column
from vfd_gan_tpu_torch.utils.init import dcgan_normal_


class MoEMlp(nn.Module):
    """Top-1 token MoE over NCDHW features with a residual add."""

    # a parallel.mesh.DataParallel: the routing's global token axis
    dp = None
    tp = None

    def __init__(self, channels: int, n_experts: int, *,
                 capacity_factor: float = 2.0,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        c, e = channels, n_experts
        self.channels, self.n_experts = c, e
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
        # the last forward's routing: each token's slot and kept flag,
        # (B, T, H, W)
        self.routing: dict = {}

    def expert_params(self) -> list:
        """The expert-stacked parameters (leading axis: the experts this
        block holds), split over ``--moe_shards``."""
        return [self.experts_w1, self.experts_b1, self.experts_w2,
                self.experts_b2]

    def _experts(self, h: torch.Tensor) -> torch.Tensor:
        d = h.dtype
        # under --tp the rank's hidden, then output, channels (not under
        # tp x ep: the ep axis holds the experts whole)
        ep = self.dp.expert if self.dp is not None else None
        tp = self.tp if ep is None else None
        h = column(tp, self.channels, h, lambda h: F.relu(
            torch.matmul(h, self.experts_w1.to(d))
            + self.experts_b1.to(d)[:, None]), dim=-1)
        return column(tp, self.channels, h, lambda h: torch.matmul(
            h, self.experts_w2.to(d)) + self.experts_b2.to(d)[:, None],
            dim=-1)

    def _logits(self, tokens: torch.Tensor) -> torch.Tensor:
        """The router's ``(T, E)`` logits, float32 (the tokens promoted);
        under ``--tp`` the rank's columns, gathered."""
        return column(self.tp, self.n_experts, tokens,
                      router_logits(self.router))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[1]
        # (a float64 net, the equivalence checks' precision, stays float64)
        dtype = x.dtype if x.dtype == torch.float64 else self.dtype
        tokens = x.permute(0, 2, 3, 4, 1).reshape(-1, c).to(dtype)
        record = {}
        y, self.aux = moe_apply(self._experts, self._logits, tokens,
                                capacity_factor=self.capacity_factor,
                                choice=self.choice, dp=self.dp,
                                rows=x.shape[0], record=record)
        # each token's routing in the tokens' (B, T, H, W) layout
        self.routing = {k: v.view(x.shape[0], *x.shape[2:])
                        for k, v in record.items()}
        y = y.to(x.dtype).view(x.shape[0], *x.shape[2:], c)
        return x + y.permute(0, 4, 1, 2, 3)
