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

Under ``--dp`` (an active ``parallel.mesh.DataParallel``) each rank holds
one contiguous block of the global token axis (its rows of the batch,
batch-major), and the layer is the global one, as GSPMD makes JAX's: C
counts the global tokens; a token's slot is its arrival index among all
ranks' tokens that chose its expert, so rank r offsets its own count by
the per-expert counts of ranks < r (one all-reduced ``(world, E)``
table); the load-balancing fractions and mean probabilities and the
dropped fraction are global means (the probabilities' sum over the ranks
differentiable, ``DataParallel.all_reduce_sum``).  The experts run per
row, so each rank runs its own kept tokens.
"""

from __future__ import annotations

import math

import torch


def capacity(n_tokens: int, n_experts: int, capacity_factor: float) -> int:
    """Static per-expert buffer size C = ceil(cf * T / E), at least 1."""
    return max(1, math.ceil(capacity_factor * n_tokens / n_experts))


def _synced(dp) -> bool:
    return dp is not None and dp.synced("moe")


def route(logits: torch.Tensor, c: int, choice=None, dp=None):
    """Top-1 routing of ``(T, E)`` logits with capacity ``c``: ``(probs
    (T, E) float32 (float64 in a float64 run), choice (T,), slot (T,), kept (T,) bool, before (E,),
    counts (E,))``.  A token's slot is its arrival index among the tokens
    that chose its expert: under an active ``dp``, among every rank's
    tokens, the ranks in order, so ``before`` holds the earlier ranks'
    tokens per expert (else zeros); ``counts``: the tokens that chose
    each expert, over the ranks.  ``choice`` replaces the argmax where
    given."""
    probs = torch.softmax(logits if logits.dtype == torch.float64
                          else logits.float(), dim=-1)
    if choice is None:
        choice = torch.argmax(probs, dim=-1)
    onehot = torch.nn.functional.one_hot(choice, probs.shape[-1])
    arrival = torch.cumsum(onehot, dim=0)
    counts = arrival[-1]
    before = torch.zeros_like(counts)
    if _synced(dp):
        # every rank's counts in its row of a (world, E) table, summed
        table = counts.new_zeros((dp.world, counts.shape[0]))
        table[dp.rank] = counts
        table = dp.all_reduce_sum(table)
        before, counts = table[:dp.rank].sum(dim=0), table.sum(dim=0)
        arrival = arrival + before
    slot = (arrival * onehot - 1).amax(dim=-1)
    return probs, choice, slot, slot < c, before, counts


def moe_apply(expert_fn, router_w: torch.Tensor, x: torch.Tensor, *,
              capacity_factor: float = 1.25, choice=None, dp=None):
    """Top-1 MoE layer over tokens ``x (T, D)``.

    ``expert_fn(h (E, C, D)) -> (E, C, D_out)`` runs every expert on its
    buffer (empty slots are zero rows); ``router_w (D, E)``.  A bfloat16
    ``x`` meets the float32 router in float32, as ``jnp`` promotes the
    product.  ``choice`` (T,), when given, replaces the router's argmax
    (to hold the layer on one device against another device's routing);
    the gate is still read from this device's probabilities.  ``dp``: a
    ``parallel.mesh.DataParallel``; when active, ``x`` is this rank's
    block of the global token axis and the layer is the global one.

    Returns ``(y (T, D_out), aux)`` with ``aux = {"load_balance_loss",
    "dropped_frac"}``, both float32 scalars."""
    t, d = x.shape
    e = router_w.shape[-1]
    synced = _synced(dp)
    n = t * dp.world if synced else t          # the global token count
    c = capacity(n, e, capacity_factor)
    logits = x.to(torch.promote_types(x.dtype, router_w.dtype)) @ router_w
    probs, choice, slot, kept, before, counts = route(logits, c, choice, dp)
    gate = probs.gather(1, choice[:, None])[:, 0]

    # this rank's buffer holds its own kept tokens, each at its arrival
    # index among this rank's tokens (below its global slot, so below c;
    # below t as well): (E, min(c, t), D) under dp, (E, c, D) alone.  A
    # dropped token reads the last row of its expert and is multiplied by
    # zero, as its all-zero row of the JAX dispatch tensor gives it
    rows = min(c, t) if synced else c
    local = slot - before[choice]
    row = choice * rows + local.clamp(0, rows - 1)
    h = x.new_zeros((e * rows, d)).index_copy(0, row[kept], x[kept])
    y_e = expert_fn(h.view(e, rows, d))
    y = y_e.reshape(e * rows, -1)[row] * kept[:, None].to(x.dtype)
    y = y * gate[:, None].to(x.dtype)

    if not synced:
        frac = torch.nn.functional.one_hot(choice, e).float().mean(dim=0)
        aux = {"load_balance_loss": e * torch.sum(frac * probs.mean(dim=0)),
               "dropped_frac": 1.0 - kept.float().mean()}
        return y, aux
    # the global means: the probabilities' sums and the kept count summed
    # over the ranks in one all-reduce (differentiable)
    sums = dp.all_reduce_sum(torch.cat([probs.sum(dim=0),
                                        kept.float().sum()[None]]))
    frac = counts.float() / n
    aux = {"load_balance_loss": e * torch.sum(frac * (sums[:e] / n)),
           "dropped_frac": 1.0 - sums[e] / n}
    return y, aux
