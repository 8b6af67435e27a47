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
cf = 2: here the buffers are ``(E, C, D)``.

Under ``--dp`` and ``--sp`` (an active ``parallel.mesh.DataParallel``,
and its ``SeqParallel``) the layer is the global one, as GSPMD makes
JAX's.  JAX lists the tokens by ``x.reshape(-1, C)`` over ``(B, T, H,
W)``: a rank holds, for each of its rows, the frames of its shard, so its
tokens are one block of each of its rows' (the whole row without
``--sp``).  C counts the global tokens; a token's slot is its arrival
index among all the tokens that chose its expert, so each of the rank's
rows offsets its own count by the tokens of the rows before it (every
shard's) and of its row on the shards before this one: one all-reduced
``(rows, shards, E)`` count table over the grid.  The load-balancing
fractions and mean probabilities and the dropped fraction are global means
(the probabilities' sum over the ranks differentiable,
``DataParallel.all_reduce_sum``).  The experts run per token, so each
rank runs its own kept tokens.  In the ``--sp`` test sweep (every rank the
whole batch, the row's ranks each their frames, ``dp`` not active) the
table is the row's, summed over the row's shards (``SeqParallel.sum``).

Under ``--moe_shards N`` (the ``ep`` axis: ``DataParallel.expert``, an
``ExpertParallel``) the N replicas of a ``(d, k)`` hold the same tokens
and rank j experts ``[j E/N, (j+1) E/N)`` alone (JAX's ``P("ep")`` on the
stacked expert leaves and the dispatched ``(E, C, D)`` blocks).  The
count table and the global sums run over the rank's replica
(``DataParallel.group``), so that each token counts once.  The routing is
decided once per ep group: its first rank's choice is broadcast (each
rank still reads its gate from its own probabilities), so that a
near-tie that two replicas' trunks break apart cannot send a token to two
experts or to none.  Each rank runs its experts on its own kept tokens,
which pass ``_EpDispatch`` (the identity, whose backward sums the
gradient over the ep group: each token's expert-path gradient lives on
one rank; the router's input does not pass it, its gradient being every
replica's already), and writes their outputs into a zero ``(E, rows,
D_out)`` buffer that ``_EpCombine`` sums over the ep group (the other
terms are exact zeros, so the forward is ep 1's bit for bit; its backward
is the identity: every replica's loss is the replicated loss).  The test
sweep (``DataParallel.local``) keeps the experts sharded and the combine
on: a rank never runs its experts alone.  The engines keep the rank's
experts and their Adam moments (``parallel/tensor.StateShards``).
"""

from __future__ import annotations

import functools
import math

import torch
import torch.distributed as dist

from vfd_gan_tpu_torch.parallel.mesh import _AllReduceSum


def capacity(n_tokens: int, n_experts: int, capacity_factor: float) -> int:
    """Static per-expert buffer size C = ceil(cf * T / E), at least 1."""
    return max(1, math.ceil(capacity_factor * n_tokens / n_experts))


class _Place:
    """Where a rank's tokens lie in the global token axis: its rows'
    indices among ``n_rows`` global rows, its shard ``shard`` of
    ``shards`` of each row's frames, and ``total``, the sum over the
    ranks that hold the rest (differentiable)."""

    def __init__(self, rows, n_rows: int, shard: int, shards: int, total,
                 count=None):
        self.rows, self.n_rows = rows, n_rows
        self.shard, self.shards = shard, shards
        self.total = total
        # the count table's sum (``total``'s but for the "ep_table"
        # control)
        self.count = total if count is None else count


def _place(dp, n_local_rows: int) -> _Place | None:
    """This rank's ``_Place`` under ``dp``, or None when it routes alone
    (no group, or the ``"moe"`` control: each rank's slots counted
    alone)."""
    if dp is None or "moe" in dp.local_ops:
        return None
    sp = dp.sp if dp.sp is not None and dp.sp.sharded else None
    shard, shards = (sp.index, sp.size) if sp is not None else (0, 1)
    if dp.active:
        n = n_local_rows * dp.world
        count = None
        if "ep_table" in dp.local_ops:
            # the control: the table over the whole world, each token
            # counted once per replica
            count = functools.partial(dp.all_reduce_sum, group=None)
        return _Place(dp.rows(n, dp.forward_micro), n, shard, shards,
                      dp.all_reduce_sum, count)
    if sp is not None:
        # the sweep: every rank holds every row, the row's shards split
        # its frames
        return _Place(torch.arange(n_local_rows), n_local_rows, shard,
                      shards, sp.sum)
    return None


def route(logits: torch.Tensor, c: int, choice=None,
          place: _Place | None = None, ep=None):
    """Top-1 routing of ``(T, E)`` logits with capacity ``c``: ``(probs
    (T, E) float32 (float64 in a float64 run), choice (T,), slot (T,),
    kept (T,) bool, local (T,), counts (E,))``.  A token's slot is its
    arrival index among the tokens that chose its expert: under ``place``
    among every rank's tokens in the global order (the rank's ``T`` tokens
    are ``len(place.rows)`` rows of equal blocks); ``local``: its arrival
    index among this rank's tokens; ``counts``: the tokens that chose each
    expert, over the ranks.  ``choice`` replaces the argmax where given;
    else under ``ep`` (an ``ExpertParallel``) the argmax of the ep
    group's first rank is every replica's."""
    probs = torch.softmax(logits if logits.dtype == torch.float64
                          else logits.float(), dim=-1)
    if choice is None:
        choice = torch.argmax(probs, dim=-1)
        if ep is not None:
            with ep.count("route"):
                dist.broadcast(choice, ep.ranks[0], group=ep.group)
    e = probs.shape[-1]
    onehot = torch.nn.functional.one_hot(choice, e)
    arrival = torch.cumsum(onehot, dim=0)
    local = (arrival * onehot - 1).amax(dim=-1)
    counts = arrival[-1]
    if place is None:
        return probs, choice, local, local < c, local, counts
    # each local row's tokens per expert, in the (rows, shards, E) table
    per_row = onehot.view(len(place.rows), -1, e)
    arrival = torch.cumsum(per_row, dim=1)
    table = counts.new_zeros((place.n_rows, place.shards, e))
    table[place.rows.to(table.device), place.shard] = arrival[:, -1]
    table = place.count(table)
    # the tokens before each row (every shard's) and, in its row, before
    # this shard
    row_sums = table.sum(dim=1)
    rows_before = torch.cumsum(row_sums, dim=0) - row_sums
    before = rows_before + table[:, :place.shard].sum(dim=1)
    arrival = arrival + before[place.rows.to(table.device)][:, None]
    slot = (arrival.view(-1, e) * onehot - 1).amax(dim=-1)
    return probs, choice, slot, slot < c, local, row_sums.sum(dim=0)


class _EpDispatch(torch.autograd.Function):
    """The identity on the tokens a rank dispatches to its experts; its
    backward sums the gradient over the ep group, where each token's
    expert-path gradient lives on the rank that holds its expert."""

    @staticmethod
    def forward(ctx, x, ep):
        ctx.ep = ep
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = grad.detach().contiguous().clone()
        with ctx.ep.count("dispatch"):
            dist.all_reduce(g, group=ctx.ep.group)
        return g, None


class _EpCombine(torch.autograd.Function):
    """The sum over the ep group of the ranks' expert outputs, each in
    its own experts' rows of a zero buffer; its backward is the identity
    (every replica's loss reads the same sum, and a rank's experts are
    differentiated by its own)."""

    @staticmethod
    def forward(ctx, y, ep):
        out = y.detach().contiguous().clone()
        with ep.count("combine"):
            dist.all_reduce(out, group=ep.group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _expert_shard(expert_fn, x, choice, kept, local, rows: int, e: int,
                  ep, local_ops) -> torch.Tensor:
    """``(E, rows, D_out)``: the rank's experts (``ep.experts(e)``) run on
    its kept tokens of theirs, every other expert's outputs from the ep
    group's other ranks (``_EpCombine``); the controls ``"ep_dispatch"``
    (no sum in the dispatch's backward) and ``"ep_combine"`` (the
    combine's backward summed over the ep group)."""
    mine = ep.experts(e)
    n = mine.stop - mine.start
    own = kept & (choice >= mine.start) & (choice < mine.stop)
    tokens = x if "ep_dispatch" in local_ops \
        else _EpDispatch.apply(x, ep)
    row = (choice - mine.start) * rows + local.clamp(0, rows - 1)
    h = x.new_zeros((n * rows, x.shape[1])).index_copy(0, row[own],
                                                       tokens[own])
    y_mine = expert_fn(h.view(n, rows, -1))
    pad = y_mine.new_zeros((1, *y_mine.shape[1:]))
    y = torch.cat([pad.expand(mine.start, -1, -1), y_mine,
                   pad.expand(e - mine.stop, -1, -1)])
    if "ep_combine" in local_ops:
        return _AllReduceSum.apply(y, ep.group)
    return _EpCombine.apply(y, ep)


def router_logits(router_w: torch.Tensor):
    """The function of tokens ``x (T, D)`` that gives their ``(T, E)``
    logits under the router ``router_w (D, E)``: a bfloat16 ``x`` meets
    the float32 router in float32, as ``jnp`` promotes the product."""
    return lambda x: x.to(torch.promote_types(x.dtype, router_w.dtype)) \
        @ router_w


def moe_apply(expert_fn, router, x: torch.Tensor, *,
              capacity_factor: float = 1.25, choice=None, dp=None,
              rows: int = 1, record: dict | None = None):
    """Top-1 MoE layer over tokens ``x (T, D)``.

    ``expert_fn(h (E, C, D)) -> (E, C, D_out)`` runs every expert on its
    buffer (empty slots are zero rows); ``router``: the router's weight
    ``(D, E)`` (``router_logits``) or a function of the tokens that gives
    their ``(T, E)`` logits (under ``--tp`` the rank's columns of the
    router, gathered: ``models/moe_block.MoEMlp``).  ``choice`` (T,), when given, replaces the router's argmax
    (to hold the layer on one device against another device's routing);
    the gate is still read from this device's probabilities.  ``dp``: a
    ``parallel.mesh.DataParallel``; when active (or under ``--sp`` in the
    sweep), ``x`` is this rank's part of the global token axis: ``rows``
    batch rows of ``T / rows`` tokens each (each row's tokens of the
    rank's frames), and the layer is the global one.  With
    ``dp.expert`` (``--moe_shards``) ``expert_fn`` runs the rank's
    experts alone, ``(E/N, C, D) -> (E/N, C, D_out)``, and the outputs are
    combined over the ep group.
    ``record``: a dict that gets the tokens' ``slot`` and ``kept``.

    Returns ``(y (T, D_out), aux)`` with ``aux = {"load_balance_loss",
    "dropped_frac"}``, both float32 scalars."""
    t, d = x.shape
    place = _place(dp, rows)
    ep = dp.expert if dp is not None else None
    n = t                                       # the global token count
    if place is not None:
        n = t // len(place.rows) * place.n_rows * place.shards
    routed = x
    if ep is not None and "ep_router" in dp.local_ops:
        # the control: the router's input summed over the ep group too
        routed = _EpDispatch.apply(x, ep)
    logits = (router if callable(router) else router_logits(router))(routed)
    e = logits.shape[-1]
    c = capacity(n, e, capacity_factor)
    probs, choice, slot, kept, local, counts = route(logits, c, choice,
                                                     place, ep)
    if record is not None:
        record.update(slot=slot.detach(), kept=kept.detach())
    gate = probs.gather(1, choice[:, None])[:, 0]

    # this rank's buffer holds its own kept tokens, each at its arrival
    # index among this rank's tokens (at most its global slot, so below
    # c; below t as well): (E, min(c, t), D) with a group, (E, c, D)
    # alone.  A dropped token reads the last row of its expert and is
    # multiplied by zero, as its all-zero row of the JAX dispatch tensor
    # gives it
    rows = min(c, t) if place is not None else c
    row = choice * rows + local.clamp(0, rows - 1)
    if ep is None:
        h = x.new_zeros((e * rows, d)).index_copy(0, row[kept], x[kept])
        y_e = expert_fn(h.view(e, rows, d))
    else:
        y_e = _expert_shard(expert_fn, x, choice, kept, local, rows, e,
                            ep, dp.local_ops)
    y = y_e.reshape(e * rows, -1)[row] * kept[:, None].to(x.dtype)
    y = y * gate[:, None].to(x.dtype)

    if place is None:
        frac = torch.nn.functional.one_hot(choice, e).float().mean(dim=0)
        aux = {"load_balance_loss": e * torch.sum(frac * probs.mean(dim=0)),
               "dropped_frac": 1.0 - kept.float().mean()}
        return y, aux
    # the global means: the probabilities' sums and the kept count summed
    # over the ranks in one all-reduce (differentiable)
    sums = place.total(torch.cat([probs.sum(dim=0),
                                  kept.float().sum()[None]]))
    frac = counts.float() / n
    aux = {"load_balance_loss": e * torch.sum(frac * (sums[:e] / n)),
           "dropped_frac": 1.0 - sums[e] / n}
    return y, aux
