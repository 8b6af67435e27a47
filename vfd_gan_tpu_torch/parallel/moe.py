"""Top-1 Mixture-of-Experts layer on one device (port of
``vfd_gan_tpu.parallel.moe``'s ``capacity`` and ``moe_apply`` without a
mesh).

The reference has no MoE; the JAX package adds it as a GShard/Switch
layer: a linear router scores each token over E experts, each token goes
to its argmax expert (``torch.argmax`` takes the first maximal index, as
``jnp.argmax`` does), each expert takes at most C = max(1, ceil(cf T /
E)) tokens in arrival order, tokens past C are dropped (they contribute
zero), every expert runs its own parameters on its (C, D) buffer, and the
outputs come back to token order multiplied by the router's gate.  The
Switch load-balancing loss E * sum_e f_e p_e and the dropped fraction
come back beside the output.

The JAX layer dispatches with one-hot ``(T, E, C)`` tensors and two
einsums.  Each token has one nonzero term in them, so a gather and a
scatter by slot compute the same function bit for bit (and the same
gradients), without the ``2 T^2`` elements of the one-hot tensors at
cf = 2: here the buffers are ``(E, C, D)``.  Several devices (the
``ep`` mesh axis, ``--moe_shards > 1``) are not ported.
"""

from __future__ import annotations

import math

import torch


def capacity(n_tokens: int, n_experts: int, capacity_factor: float) -> int:
    """Static per-expert buffer size C = ceil(cf * T / E), at least 1."""
    return max(1, math.ceil(capacity_factor * n_tokens / n_experts))


def route(logits: torch.Tensor, c: int, choice=None):
    """Top-1 routing of ``(T, E)`` logits with capacity ``c``: ``(probs
    (T, E) float32, choice (T,), slot (T,), kept (T,) bool)``.  A token's
    slot is its arrival index among the tokens that chose its expert;
    ``choice`` replaces the argmax where given."""
    probs = torch.softmax(logits.float(), dim=-1)
    if choice is None:
        choice = torch.argmax(probs, dim=-1)
    onehot = torch.nn.functional.one_hot(choice, probs.shape[-1])
    slot = (torch.cumsum(onehot, dim=0) * onehot - 1).amax(dim=-1)
    return probs, choice, slot, slot < c


def moe_apply(expert_fn, router_w: torch.Tensor, x: torch.Tensor, *,
              capacity_factor: float = 1.25, choice=None):
    """Top-1 MoE layer over tokens ``x (T, D)``.

    ``expert_fn(h (E, C, D)) -> (E, C, D_out)`` runs every expert on its
    buffer (empty slots are zero rows); ``router_w (D, E)``.  A bfloat16
    ``x`` meets the float32 router in float32, as ``jnp`` promotes the
    product.  ``choice`` (T,), when given, replaces the router's argmax
    (to hold the layer on one device against another device's routing);
    the gate is still read from this device's probabilities.

    Returns ``(y (T, D_out), aux)`` with ``aux = {"load_balance_loss",
    "dropped_frac"}``, both float32 scalars."""
    t, d = x.shape
    e = router_w.shape[-1]
    c = capacity(t, e, capacity_factor)
    logits = x.to(torch.promote_types(x.dtype, router_w.dtype)) @ router_w
    probs, choice, slot, kept = route(logits, c, choice)
    gate = probs.gather(1, choice[:, None])[:, 0]

    # the flat buffer row of each kept token; a dropped token reads the
    # last slot of its expert and is multiplied by zero, as its all-zero
    # row of the JAX dispatch tensor gives it
    row = choice * c + slot.clamp(0, c - 1)
    h = x.new_zeros((e * c, d)).index_copy(0, row[kept], x[kept])
    y_e = expert_fn(h.view(e, c, d))
    y = y_e.reshape(e * c, -1)[row] * kept[:, None].to(x.dtype)
    y = y * gate[:, None].to(x.dtype)

    frac = torch.nn.functional.one_hot(choice, e).float().mean(dim=0)
    aux = {"load_balance_loss": e * torch.sum(frac * probs.mean(dim=0)),
           "dropped_frac": 1.0 - kept.float().mean()}
    return y, aux
