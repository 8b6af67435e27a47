"""Data parallelism across processes (port of the ``dp`` axis of
``vfd_gan_tpu.parallel.mesh``).

The JAX package runs dp as one process over a 1-D ``"dp"`` mesh: GSPMD
makes every reduction over the batch global, so its dp-N step is its dp-1
step.  The port runs one process per rank on ``torch.distributed`` (NCCL
on CUDA, gloo on the CPU) and adds each of those global reductions by
hand:

* BatchNorm statistics (``models/layers.py``): the mean, then
  ``mean((x - mu)^2)``, each summed over the ranks by ``all_reduce_sum``,
  whose backward sums the gradient over the ranks as well;
* the flow's per-(stream, time-slab) min-max stretch (``ops/flow.py``,
  and ``train/host_flow.py`` under ``--host_flow``);
* the MoE layer's capacity, slots and load-balancing means over the
  global token axis (``parallel/moe.py``), and ``--int8_disc``'s
  per-tensor absmax (``quant/qdisc.py``);
* the gradients, one flattened all-reduce-mean per net before its Adam
  step (``mean_grads``), and the logged metrics (``mean_metrics``);
* the random draws: every rank draws the global batch's numbers from the
  one engine generator and keeps its own rows (``rand``, ``take``), so the
  generator's state is the same on every rank and does not depend on dp.

Rank ``r`` holds rows ``[r B/dp, (r+1) B/dp)`` of the global batch; under
``--accum k`` its rows of each of the k microbatches (JAX
``accum_regroup``: dp divides the microbatch).  The collectives are
``all_reduce`` (SUM and MAX) alone, which gloo also runs on CUDA tensors
(several ranks on one card).  Under ``--pp`` (``parallel/pipeline.py``)
the group of a rank's dp peers is a subgroup of the world (``group``).

``DataParallel`` is one process's place in the group; an engine makes one
from the process group it finds (``DataParallel.current``) and binds it to
its nets' BatchNorm and dropout modules.  ``launch`` starts the ranks of
one command, ``rank_group`` joins a started rank to its group.

Under ``--sp N`` (``vfd_gan_tpu.parallel.mesh.make_mesh``'s ``(dp, sp)``
mesh, its batch sharded ``P("dp", "sp")``) the ranks form a ``SpGrid``:
dp outer, sp inner, rank ``d sp + k`` holding rows ``[d B/dp, (d+1)
B/dp)`` and frames ``[k T/sp, (k+1) T/sp)``.  Its ``DataParallel`` keeps
the rows' place (``rank`` d of ``world`` dp) and reduces over the whole
grid (BatchNorm statistics, gradients, metrics: ``size`` dp sp ranks);
its ``SeqParallel`` (``sp``) is the rank's place in its row, with the
groups of the frame axis (``parallel/temporal.py``).

Under ``--moe_shards N`` (``make_mesh``'s ``ep`` axis, innermost: the
``(dp, sp, ep)`` grid, rank ``(d sp + k) N + j``) the N ranks of one
``(d, k)`` are replicas: the same rows and frames, the same draws, the
same replicated parameters; rank ``j`` holds experts ``[j E/N, (j+1)
E/N)`` of the MoE block and their Adam state (``ExpertParallel``,
``parallel/moe.py``).  Its ``DataParallel`` reduces over ``group``, the
``dp sp`` ranks of replica ``j`` (each element once: BatchNorm
statistics, the MoE counts, metrics, the expert gradients), and averages
the replicated gradients over the whole world (``mean_grads``).

Under ``--tp N`` (``make_mesh``'s ``tp`` axis, between sp and ep: the
``(dp, sp, tp, ep)`` grid, rank ``((d sp + k) N + t) ep + j``) the N
ranks of one ``(d, k, j)`` hold the same rows and frames and make the
same draws; rank ``t`` holds channel slice ``t`` of every leaf that
``parallel/tensor.py`` splits (JAX ``param_spec``), and the nets gather
each split conv's output over the tp group (``TensorParallel``).  Its
``DataParallel`` reduces over ``group``, the ``dp sp`` ranks of slice
``t`` (BatchNorm sums, metrics, the split leaves' gradients: a reduction
over the whole grid would add slice t's sums to slice t''s), and
averages the whole leaves' gradients over the world, as under ``ep``.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import signal
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from vfd_gan_tpu_torch.parallel import temporal

# what ``launch`` tells each rank: its rendezvous and the backend
ENV_INIT = "VFD_DP_INIT"
ENV_BACKEND = "VFD_DP_BACKEND"


def auto_dp(batchsize: int, requested: int = 0,
            n_devices: int = 1) -> int:
    """Largest usable dp size (JAX ``auto_dp``): the request (0: every
    device) capped at the device count and shrunk to a divisor of the
    (micro)batch."""
    dp = requested if requested > 0 else n_devices
    dp = min(dp, n_devices, batchsize)
    while batchsize % dp:
        dp -= 1
    return max(dp, 1)


def resolve_dp(cfg, device_type: str) -> int:
    """``--dp`` as the JAX engine resolves it: dp divides the microbatch
    (``batchsize // accum``; under ``--pp`` the GPipe microbatch).  On
    ``cuda`` the request is capped at the visible cards left after the
    ``--pp`` stages, the ``--sp`` shards and the ``--moe_shards``
    replicas and the ``--tp`` channel shards (``make_mesh``: ``dp sp tp
    ep`` must fit the devices) and ``--dp 0`` means all of them; on the
    CPU the request is the number of processes to start (``--dp 0``:
    one)."""
    pp = max(1, cfg.pp)
    sp = max(1, cfg.sp)
    tp = max(1, cfg.tp)
    ep = max(1, cfg.moe_shards)
    micro = cfg.n_pp_micro if pp > 1 else max(1, cfg.accum)
    if device_type == "cuda":
        cards = max(1, torch.cuda.device_count())
        if pp > cards:
            raise SystemExit(f"--pp {pp}: {pp} stages need {pp} cards, "
                             f"{cards} visible")
        if sp > cards:
            raise SystemExit(f"--sp {sp}: {sp} frame shards need {sp} "
                             f"cards, {cards} visible")
        if sp * tp > cards:
            raise SystemExit(f"--tp {tp}: {tp} channel shards need "
                             f"{sp * tp} cards ({tp} per frame shard), "
                             f"{cards} visible")
        if sp * tp * ep > cards:
            raise SystemExit(f"--moe_shards {ep}: {ep} expert shards need "
                             f"{sp * tp * ep} cards ({ep} per frame and "
                             f"channel shard), {cards} visible")
        n = cards // (pp * sp * tp * ep)
    else:
        n = max(1, cfg.dp)
    dp = auto_dp(cfg.batchsize // micro, cfg.dp, n)
    if device_type == "cuda" or dp != max(1, cfg.dp):
        per = (f" per stage of --pp {pp}" if pp > 1 else
               f" per shard of --sp {sp}" if sp > 1 else "")
        if tp > 1:
            per += f" per channel group of --tp {tp}"
        if ep > 1:
            per += f" per expert group of --moe_shards {ep}"
        print(f" >> --dp {cfg.dp} -> dp {dp} ({n} {device_type} "
              f"device(s){per}, microbatch {cfg.batchsize // micro})",
              flush=True)
    return dp


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks of ``group``; its backward is the sum over
    the ranks of the gradient (each rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.detach().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.detach().contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


# the default group of ``DataParallel``'s collectives: the place's own
# (whose value may be None, the whole process group)
_OWN_GROUP = object()


class DataParallel:
    """One process's place in a data-parallel group.

    ``active``: the group's collectives run (a process group is set up and
    no ``local()`` block is open); otherwise every method is the identity
    of a single process.  At world size 1 in a group the collectives still
    run: the dp code path of one rank.

    ``rank`` and ``world`` are the place and size in the dp group
    (``group``: None for the whole process group; under ``--pp`` the
    subgroup of the ranks of one pipeline stage).  ``writes``: does this
    process write the run's files (default: dp rank 0).

    ``bn_stats``: ``"global"`` (training: BatchNorm statistics over the
    ranks, their backward summed over the ranks too); the two controls of
    the equivalence checks (``tools/dp_equivalence.py``), never training
    options: ``"local"`` (each rank's own statistics) and ``"forward"``
    (summed over the ranks in the forward only, as a plain
    ``dist.all_reduce`` there would: each rank's gradient then misses the
    other ranks' share).  ``local_ops``: the other controls, the names of
    the reductions left to each rank (``"moe"``, ``"absmax"``,
    ``"stretch"``; ``synced``); under ``--sp`` also ``"bn_sp"`` (the
    BatchNorm statistics of the sharded segments over the rank's frames
    alone), ``"stretch_grid"`` (the stretch's MAX over the whole grid,
    which mixes frames), ``"halo"`` (``SeqParallel``: zero halos),
    ``"carry"`` (``SeqParallel``: each shard starts the ConvLSTM's
    recurrence from zeros, as if alone) and ``"dropout_sp"`` (each shard
    draws a mask of its own frames' shape, the same on every shard, as a
    dropout that passes no ``frame_dim`` would); under ``--moe_shards``
    ``"ep_combine"`` (the MoE combine's backward summed over the ep
    group), ``"ep_dispatch"`` (the dispatch's backward not summed),
    ``"ep_router"`` (the router's input summed too), ``"ep_table"`` (the
    MoE count table over the whole world) and ``"ep_grads"`` (the expert
    gradients in the world's flattened all-reduce); under ``--tp``
    ``"tp_bn"`` (the BatchNorm sums over the whole grid, which adds
    channel slice t's sums to slice t''s), ``"tp_mean"`` (the split
    leaves' gradients in the world's flattened all-reduce) and, read by
    ``TensorParallel``, ``"tp_copy"`` (the copy-in's backward not summed),
    ``"tp_gather"`` (the gather's backward summed), ``"tp_dropout"``
    (Xception's decoder dropout drawn on the rank's slice) and
    ``"tp_deconv_dim0"`` (a transposed conv's weight cut on dim 0).

    ``sp``: the rank's ``SeqParallel`` on a ``(dp, sp)`` grid (``None``
    without one).  Then ``rank`` and ``world`` place the rows, ``group``
    (None) is the whole grid, and ``size``, dp sp ranks, divides the
    gradients' and metrics' sums.  ``expert``: the rank's
    ``ExpertParallel`` on a ``(dp, sp, ep)`` grid (``None`` without one);
    then ``group`` is its replica's ``dp sp`` ranks (``peers_group``).
    ``tp``: the rank's ``TensorParallel`` on a ``(dp, sp, tp, ep)`` grid
    (``None`` without one); then ``group`` is the ``dp sp`` ranks of its
    channel slice (and expert replica)."""

    def __init__(self, rank: int = 0, world: int = 1, grouped: bool = False,
                 device: torch.device | str = "cpu",
                 bn_stats: str = "global", group=None,
                 writes: bool | None = None):
        self.rank = rank
        self.world = world
        self.grouped = grouped
        self.device = torch.device(device)
        self.bn_stats = bn_stats
        self.local_ops: frozenset = frozenset()
        self.group = group
        self._writes = rank == 0 if writes is None else writes
        # the microbatches whose slices make up this rank's rows of the
        # batch that a forward sees: 1 (under --accum each forward is one
        # microbatch), under --pp the GPipe microbatches (its back runs
        # on all of them at once)
        self.forward_micro = 1
        self.sp = None
        self.expert = None
        self.tp = None
        self._on = True

    @classmethod
    def current(cls, device: torch.device | str = "cpu") -> "DataParallel":
        """This process's place in the process group set up, if any
        (none inside ``alone``)."""
        if dist.is_available() and dist.is_initialized() and not _ALONE:
            return cls(dist.get_rank(), dist.get_world_size(), True, device)
        return cls(device=device)

    @property
    def active(self) -> bool:
        return self.grouped and self._on

    @property
    def size(self) -> int:
        """The ranks that the gradients and metrics are averaged over:
        ``world``, times the frame shards under ``--sp``."""
        return self.world * (self.sp.size if self.sp is not None else 1)

    @property
    def stretch_group(self):
        """The ranks whose rows the flow's stretch takes its extrema over:
        those that hold this rank's frames (under ``--sp`` the dp peers of
        its shard; the ``"stretch_grid"`` control: the whole grid)."""
        if self.sp is None or "stretch_grid" in self.local_ops:
            return self.group
        return self.sp.peers_group

    @property
    def writes(self) -> bool:
        """Does this process write files (rank 0, or no group)?"""
        return self._writes

    def synced(self, op: str) -> bool:
        """Does the reduction ``op`` run over the ranks (active, and not
        left local by a control)?"""
        return self.active and op not in self.local_ops

    @contextlib.contextmanager
    def local(self):
        """A block in which this process computes as if alone (the test
        sweep: every rank runs it whole; under ``--sp`` the nets take
        whole clips, and ``parallel/sp_generator.generator_forward_sp``
        alone shards the frames)."""
        on, self._on = self._on, False
        sp_on = self.sp.on if self.sp is not None else False
        if self.sp is not None:
            self.sp.on = False
        try:
            yield
        finally:
            self._on = on
            if self.sp is not None:
                self.sp.on = sp_on

    def bind(self, module: torch.nn.Module) -> torch.nn.Module:
        """Point every submodule with a ``dp`` attribute (BatchNorms,
        dropout) at this group, every one with an ``sp`` attribute (the
        modules that shard frames) at its ``SeqParallel`` and every one
        with a ``tp`` attribute (the modules that split channels) at its
        ``TensorParallel``."""
        for m in module.modules():
            if hasattr(m, "dp"):
                m.dp = self
            if hasattr(m, "sp"):
                m.sp = self.sp
            if hasattr(m, "tp"):
                m.tp = self.tp
        return module

    # -- the rank's rows of the global batch -------------------------------
    def rows(self, batch: int, accum: int = 1) -> torch.Tensor | None:
        """This rank's row indices of a global batch of ``batch`` rows in
        ``accum`` microbatches, or None when not active."""
        if not self.active:
            return None
        if batch % (accum * self.world):
            raise ValueError(f"batch {batch} is not {accum} microbatches "
                             f"divisible over {self.world} ranks")
        micro = batch // accum
        per = micro // self.world
        return torch.tensor([i * micro + self.rank * per + j
                             for i in range(accum) for j in range(per)])

    def take(self, tensors, accum: int = 1):
        """This rank's rows (dim 0) of each global-batch tensor."""
        rows = self.rows(tensors[0].shape[0], accum)
        if rows is None:
            return tuple(tensors)
        return tuple(t[rows.to(t.device)] for t in tensors)

    def rand(self, shape, generator: torch.Generator | None,
             device, frame_dim: int | None = None) -> torch.Tensor:
        """Uniform draws for this rank's slice of a global tensor: the
        global tensor's (``world`` times the rows of ``shape``) drawn
        from ``generator`` on its device, this rank's rows kept
        (``rows``, the forward's ``forward_micro`` microbatches) and moved
        to ``device``.  ``frame_dim``: the axis of ``shape`` that holds
        this rank's frames under ``--sp`` (the global tensor has ``sp``
        times as many; this rank's are kept)."""
        draw = device if generator is None else generator.device
        if not self.active:
            return torch.rand(shape, generator=generator,
                              device=draw).to(device)
        if "dropout_sp" in self.local_ops:        # the control
            frame_dim = None
        n = shape[0]
        full_shape = [self.world * n, *shape[1:]]
        if frame_dim is not None and self.sp is not None:
            full_shape[frame_dim] *= self.sp.size
        full = torch.rand(full_shape, generator=generator, device=draw)
        rows = self.rows(self.world * n, self.forward_micro)
        full = full[rows.to(full.device)]
        if frame_dim is not None and self.sp is not None:
            full = full[(slice(None),) * frame_dim
                        + (self.sp.frame_slice(full_shape[frame_dim]),)]
        return full.to(device)

    # -- collectives -------------------------------------------------------
    def all_reduce_sum(self, x: torch.Tensor,
                       group=_OWN_GROUP) -> torch.Tensor:
        """The sum of ``x`` over the ranks (of ``group``; by default this
        place's ``group``), differentiable (identity when not active)."""
        if not self.active:
            return x
        return _AllReduceSum.apply(
            x, self.group if group is _OWN_GROUP else group)

    def bn_sum(self, x: torch.Tensor) -> torch.Tensor:
        """A BatchNorm's sum over the ranks, as ``bn_stats`` says.  Under
        ``--sp`` over the whole grid, but in a segment that runs replicated
        on the sp peers (``SeqParallel.replicated``: each holds all of
        its rows' frames) over the dp peers of the rank's shard, so that
        each element counts once (and with the ``"bn_sp"`` control in
        every segment).  Under ``--tp`` over the ranks of the rank's
        channel slice (``group``; the ``"tp_bn"`` control: the whole
        grid)."""
        group = self.group
        if self.sp is not None and (self.sp.replicated
                                    or "bn_sp" in self.local_ops):
            group = self.sp.peers_group
        if self.tp is not None and "tp_bn" in self.local_ops:
            group = None
        if self.bn_stats == "forward" and self.active:
            local = x.detach()
            total = local.clone()
            dist.all_reduce(total, group=group)
            return x + (total - local)
        return self.all_reduce_sum(x, group)

    def all_reduce_max_(self, x: torch.Tensor,
                        group=_OWN_GROUP) -> torch.Tensor:
        """``x`` replaced by its elementwise maximum over the ranks (of
        ``group``; by default this place's ``group``)."""
        if self.active:
            dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.group
                            if group is _OWN_GROUP else group)
        return x

    @property
    def replicas(self) -> int:
        """The ranks that hold the same rows and frames: the ``--tp``
        channel shards times the ``--moe_shards`` expert shards."""
        return (self.expert.size if self.expert is not None else 1) \
            * (self.tp.size if self.tp is not None else 1)

    def mean_grads(self, module: torch.nn.Module, sharded=()) -> None:
        """Every ``.grad`` of ``module`` replaced by its mean over the
        ranks: one all-reduce of the gradients flattened.  Under
        ``--moe_shards`` and ``--tp`` (``replicas`` > 1) the replicated
        parameters' over the whole world (the replicas' means bit-equal,
        so their parameters stay so), and those of ``sharded`` (the rank's
        experts and channel slices, which no other replica holds) apart,
        over ``group`` alone: one flattened all-reduce would add expert
        j's gradients to expert j''s, channel slice t's to slice t''s."""
        if not self.active:
            return
        replicas = self.replicas
        controls = {"ep_grads", "tp_mean"} & self.local_ops
        if replicas == 1 or controls:
            # (the controls: the experts, or the channel slices, in the
            # world's all-reduce)
            sharded = ()
        own = {id(p) for p in sharded}
        params = [p for p in module.parameters() if p.grad is not None]
        _mean_flat([p.grad for p in params if id(p) not in own],
                   None if replicas > 1 else self.group,
                   self.size * replicas)
        _mean_flat([p.grad for p in params if id(p) in own], self.group,
                   self.size)

    def mean_metrics(self, metrics: dict) -> dict:
        """The step's 0-dim metrics averaged over the ranks (each a mean
        over an equal slice, so the mean is the global batch's)."""
        if not self.active or not metrics:
            return metrics
        names = sorted(metrics)
        flat = torch.stack([metrics[k].detach().to(torch.float64)
                            for k in names])
        dist.all_reduce(flat, group=self.group)
        flat.div_(self.size)
        return {k: flat[i].to(metrics[k].dtype) for i, k in enumerate(names)}

    def any(self, flag: bool) -> bool:
        """Is ``flag`` set on any rank of the whole process group (an
        all-reduced MAX; under ``--pp`` the stages too)?"""
        if not self.active:
            return bool(flag)
        t = torch.tensor([1.0 if flag else 0.0], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item() > 0)


def _mean_flat(grads: list, group, size: int) -> None:
    """``grads`` replaced in place by their sums over ``group`` over
    ``size``, one all-reduce of them flattened."""
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat.div_(size)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


# -- one process alone inside a group ----------------------------------------

_ALONE = False


@contextlib.contextmanager
def alone():
    """A block in which ``DataParallel.current`` finds no group: an engine
    built there computes as one process (a rank's dp-1 reference in the
    equivalence checks), and creates no subgroup."""
    global _ALONE
    was, _ALONE = _ALONE, True
    try:
        yield
    finally:
        _ALONE = was


# -- the (dp, sp, tp, ep) grid of --sp, --tp and --moe_shards ---------------

class _Counted:
    """A rank's place on an axis whose exchanges are counted by kind in
    ``counts`` (``[calls, ms]``); with ``timed`` the device is
    synchronised around each one and the ms are summed."""

    def __init__(self, device: torch.device | str = "cpu"):
        self.device = torch.device(device)
        self.timed = False
        self.counts: dict[str, list] = {}

    @contextlib.contextmanager
    def count(self, kind: str):
        """One exchange of ``kind``, counted (and timed with ``timed``)."""
        if self.timed and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.timed and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            entry = self.counts.setdefault(kind, [0, 0.0])
            entry[0] += 1
            if self.timed:
                entry[1] += 1e3 * (time.perf_counter() - t0)


class SeqParallel(_Counted):
    """One rank's place on the frame axis of a ``(dp, sp)`` grid: shard
    ``index`` of ``size``, holding frames ``[index T/size, (index+1)
    T/size)`` of its rows.  Its groups: ``group``, the sp peers of its dp
    row (global ranks ``ranks``, in shard order; the halos' neighbours,
    the gathers and sums over the frame axis); ``prev_group`` and
    ``next_group``, the two-rank groups with the shards before and after
    it (None at an edge), where the halos pass; ``peers_group``, the dp
    peers of its shard (the ranks that hold its frames of the other rows).

    The modules that shard frames are bound to it (``DataParallel.bind``:
    their ``sp``) and call the frame axis's operations through it:
    ``halo``, ``upsample2x_t``, ``gather``, ``split``, ``sum``,
    ``carry_in`` and ``carry_out`` (``parallel/temporal.py``).

    ``on``: the nets shard their frames (off in the test sweep, whose nets
    take whole clips, but for ``generator_forward_sp``).  ``replicated``:
    a segment of a net runs on the gathered frames, the same on every sp
    peer (``segment``).  ``local_ops``: the controls ``"halo"`` (zero
    halos, each shard padded as if alone) and ``"carry"`` (each shard's
    recurrence started from zeros).  ``counts``: the
    exchanges made by kind, ``[calls, ms]``; with ``timed`` the device is
    synchronised around each one and the ms are summed."""

    def __init__(self, index: int, size: int, group, ranks: list[int],
                 prev_group=None, next_group=None, peers_group=None,
                 device: torch.device | str = "cpu"):
        super().__init__(device)
        self.index, self.size = index, size
        self.group, self.ranks = group, list(ranks)
        self.prev_group, self.next_group = prev_group, next_group
        self.peers_group = peers_group
        self.on = True
        self.replicated = False
        self.local_ops: frozenset = frozenset()

    def frame_slice(self, frames: int) -> slice:
        """This shard's frames of a clip of ``frames``."""
        if frames % self.size:
            raise ValueError(f"{frames} frames do not split over "
                             f"sp={self.size}")
        n = frames // self.size
        return slice(self.index * n, (self.index + 1) * n)

    @property
    def sharded(self) -> bool:
        """Do the nets hold this rank's frames alone here (``on``, and not
        in a replicated segment)?"""
        return self.on and not self.replicated

    # -- the frame axis's operations (parallel/temporal.py) ------------------
    def halo(self, block: torch.Tensor, halo: int, dim: int = 2,
             left: bool = True, right: bool = True) -> torch.Tensor:
        """``block`` with ``halo`` frames of each neighbour shard around
        it (``temporal.halo_exchange``)."""
        return temporal.halo_exchange(block, halo, self, dim, left, right)

    def upsample2x_t(self, block: torch.Tensor,
                     dim: int = 2) -> torch.Tensor:
        """This shard's frames of the x2 upsample over T
        (``temporal.upsample2x_t_sp``)."""
        return temporal.upsample2x_t_sp(block, self, dim)

    def gather(self, block: torch.Tensor, dim: int = 2) -> torch.Tensor:
        """Every shard's frames on every peer (``temporal.gather_frames``)."""
        return temporal.gather_frames(block, self, dim)

    def split(self, x: torch.Tensor, dim: int = 2) -> torch.Tensor:
        """This shard's frames of a clip every peer holds whole."""
        size = x.shape[dim] // self.size
        return x.narrow(dim, self.index * size, size)

    def carry_in(self, anchor: torch.Tensor, state: torch.Tensor):
        """``(anchor, the state this shard's recurrence starts from)``,
        handed on by the shard before (``temporal.carry_in``)."""
        return temporal.carry_in(anchor, state, self)

    def carry_out(self, state: torch.Tensor) -> torch.Tensor:
        """This shard's last state handed to the shard after, returned
        for use in its place (``temporal.carry_out``)."""
        return temporal.carry_out(state, self)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the sp peers of the row; its backward is
        the same sum of the gradient (each peer's loss reads the sum)."""
        with self.count("sum"):
            return _AllReduceSum.apply(x, self.group)

    @contextlib.contextmanager
    def segment(self, sharded: bool):
        """A block of a net that runs on sharded (``sharded``) or on
        gathered, replicated frames."""
        was, self.replicated = self.replicated, not sharded
        try:
            yield
        finally:
            self.replicated = was

    @contextlib.contextmanager
    def sharding(self):
        """A block in which the nets shard their frames (``on``)."""
        was, self.on = self.on, True
        try:
            yield
        finally:
            self.on = was



class ExpertParallel(_Counted):
    """One rank's place on the expert axis of a ``(dp, sp, ep)`` grid
    (``--moe_shards N``): replica ``index`` of ``size`` of its ``(d,
    k)``, holding experts ``[index E/size, (index+1) E/size)`` of the MoE
    block.  ``group``: the ``size`` replicas (global ranks ``ranks``, in
    replica order), over which the MoE layer's routing is broadcast, its
    dispatched tokens' gradients summed and its expert outputs combined
    (``parallel/moe.py``; ``counts``: ``"route"``, ``"dispatch"``,
    ``"combine"``); ``peers_group``: the ``dp sp`` ranks of replica
    ``index`` (each element of the global batch once)."""

    def __init__(self, index: int, size: int, group, ranks: list[int],
                 peers_group=None, device: torch.device | str = "cpu"):
        super().__init__(device)
        self.index, self.size = index, size
        self.group, self.ranks = group, list(ranks)
        self.peers_group = peers_group

    def experts(self, n_experts: int) -> slice:
        """The rank's experts of ``n_experts``."""
        if n_experts % self.size:
            raise ValueError(f"{n_experts} experts do not split over "
                             f"moe_shards={self.size}")
        n = n_experts // self.size
        return slice(self.index * n, (self.index + 1) * n)


class TensorParallel(_Counted):
    """One rank's place on the channel axis of a ``(dp, sp, tp, ep)``
    grid (``--tp N``): shard ``index`` of ``size`` of its ``(d, k, j)``,
    holding channel slice ``index`` of every leaf that
    ``parallel/tensor.py`` splits.  ``group``: the ``size`` ranks of the
    ``(d, k, j)`` (global ranks ``ranks``, in shard order), over which a
    split conv's input gradient is summed and its output gathered
    (``counts``: ``"copy"``, ``"gather"``); ``peers_group``: the ``dp
    sp`` ranks of slice ``index`` (each element of the global batch
    once).  ``local_ops``: the controls ``"tp_copy"`` (the copy-in's
    backward not summed), ``"tp_gather"`` (the gather's backward summed
    over the group), ``"tp_dropout"`` (``models/xception3d.DeConvBlock``)
    and ``"tp_deconv_dim0"`` (``parallel/tensor.StateShards.release``)."""

    def __init__(self, index: int, size: int, group, ranks: list[int],
                 peers_group=None, device: torch.device | str = "cpu"):
        super().__init__(device)
        self.index, self.size = index, size
        self.group, self.ranks = group, list(ranks)
        self.peers_group = peers_group
        self.local_ops: frozenset = frozenset()


class SpGrid:
    """This process's place in the ``(dp, sp, tp, ep)`` grid of the
    process group: dp outer, then sp, then tp, ep inner (JAX
    ``make_mesh``'s axis order), rank ``((d sp + k) tp + t) ep + j``.
    Every rank builds every subgroup, in one order (``dist.new_group`` is
    a collective of the whole group); ``sp_grid`` makes one per process,
    sp, ep and tp size."""

    def __init__(self, sp: int, ep: int = 1, tp: int = 1):
        self.rank = dist.get_rank()
        world = dist.get_world_size()
        if world % (sp * tp * ep):
            raise ValueError(f"{world} ranks do not split into sp={sp} "
                             f"frame shards x tp={tp} channel shards x "
                             f"ep={ep} expert shards")
        self.sp, self.tp, self.ep = sp, tp, ep
        self.dp = world // (sp * tp * ep)
        self.dp_index, rest = divmod(self.rank, sp * tp * ep)
        self.sp_index, rest = divmod(rest, tp * ep)
        self.tp_index, self.ep_index = divmod(rest, ep)
        self.peers_group = self.row_group = None
        self.prev_group = self.next_group = None
        self.ep_group = self.tp_group = self.replica_group = None

        def at(d, k, t=None, j=None):
            t = self.tp_index if t is None else t
            j = self.ep_index if j is None else j
            return ((d * sp + k) * tp + t) * ep + j

        # the replicas of one (d, k): each (t, j) in turn
        places = [(t, j) for t in range(tp) for j in range(ep)]
        mine = (self.tp_index, self.ep_index)
        # the frame axis, within each replica (every replica's groups
        # built, in one order, on every rank)
        for t, j in places if sp > 1 else ():
            for k in range(sp):
                g = dist.new_group([at(d, k, t, j) for d in range(self.dp)])
                if (k, t, j) == (self.sp_index, *mine):
                    self.peers_group = g
            for d in range(self.dp):
                g = dist.new_group([at(d, k, t, j) for k in range(sp)])
                row = (d, t, j) == (self.dp_index, *mine)
                if row:
                    self.row_group = g
                for k in range(sp - 1):
                    g = dist.new_group([at(d, k, t, j), at(d, k + 1, t, j)])
                    if row and k == self.sp_index:
                        self.next_group = g
                    if row and k + 1 == self.sp_index:
                        self.prev_group = g
        here = (self.dp_index, self.sp_index)
        # the channel axis: each (d, k, j)'s tp ranks
        for d in range(self.dp) if tp > 1 else ():
            for k in range(sp):
                for j in range(ep):
                    g = dist.new_group([at(d, k, t, j) for t in range(tp)])
                    if (d, k, j) == (*here, self.ep_index):
                        self.tp_group = g
        # the expert axis: each (d, k, t)'s replicas
        for d in range(self.dp) if ep > 1 else ():
            for k in range(sp):
                for t in range(tp):
                    g = dist.new_group([at(d, k, t, j) for j in range(ep)])
                    if (d, k, t) == (*here, self.tp_index):
                        self.ep_group = g
        # each replica's dp sp ranks
        for t, j in places if len(places) > 1 else ():
            g = dist.new_group([at(d, k, t, j) for d in range(self.dp)
                                for k in range(sp)])
            if (t, j) == mine:
                self.replica_group = g
        self._at = at

    def data_parallel(self, device) -> DataParallel:
        """This rank's ``DataParallel``: its rows' place, its replica's
        grid to reduce over (the whole grid without ``tp`` or ``ep``),
        rank 0 of the grid writing, its ``SeqParallel`` (sp > 1), its
        ``TensorParallel`` (tp > 1) and its ``ExpertParallel`` (ep >
        1)."""
        dp = DataParallel(self.dp_index, self.dp, True, device,
                          group=self.replica_group, writes=self.rank == 0)
        d, k = self.dp_index, self.sp_index
        if self.sp > 1:
            dp.sp = SeqParallel(
                k, self.sp, self.row_group,
                [self._at(d, i) for i in range(self.sp)],
                self.prev_group, self.next_group, self.peers_group, device)
        if self.tp > 1:
            dp.tp = TensorParallel(
                self.tp_index, self.tp, self.tp_group,
                [self._at(d, k, t) for t in range(self.tp)],
                self.replica_group, device)
        if self.ep > 1:
            dp.expert = ExpertParallel(
                self.ep_index, self.ep, self.ep_group,
                [self._at(d, k, j=j) for j in range(self.ep)],
                self.replica_group, device)
        return dp


_SP_GRIDS: dict = {}


def sp_grid(sp: int, ep: int = 1, tp: int = 1) -> SpGrid:
    """This process's grid for ``sp`` frame shards, ``ep`` expert shards
    and ``tp`` channel shards (made once per process group)."""
    key = (sp, ep, tp, id(dist.group.WORLD))
    if key not in _SP_GRIDS:
        _SP_GRIDS[key] = SpGrid(sp, ep, tp)
    return _SP_GRIDS[key]


# -- starting the ranks -----------------------------------------------------

def rank_env() -> tuple[int, int, str, str] | None:
    """``(rank, world, init_method, backend)`` of a process that
    ``launch`` started, else None."""
    if ENV_INIT not in os.environ:
        return None
    return (int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
            os.environ[ENV_INIT], os.environ[ENV_BACKEND])


def rank_device(device: torch.device, rank: int) -> torch.device:
    """The card of rank ``rank``: ``cuda:{rank mod cards}`` (so several
    gloo ranks may share one card); the CPU stays the CPU."""
    if device.type != "cuda":
        return device
    index = rank % torch.cuda.device_count()
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


@contextlib.contextmanager
def rank_group(rank: int, world: int, init_method: str, backend: str,
               timeout_s: float = 600.0):
    """This process joined to its group for the block; a collective that
    waits longer than ``timeout_s`` raises (a hung rank fails its peers
    instead of hanging them)."""
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        yield
    finally:
        dist.destroy_process_group()


def launch(entry: str, argv: list[str], world: int, backend: str, *,
           timeout: float | None = None, env: dict | None = None,
           log: str | os.PathLike | None = None,
           on_spawn=None) -> None:
    """Run ``python -m entry *argv`` as ``world`` ranks of one group over
    ``backend`` (``"nccl"`` or ``"gloo"``), meeting through a file in a
    fresh temporary directory, and wait for all of them.

    A rank that exits non-zero stops the others; so does ``timeout``
    seconds passing (the join timeout), which kills every rank.  Either
    raises ``RuntimeError``; no rank is left running.  SIGTERM and SIGINT
    sent to this process are passed on to the ranks, which park together
    (``EngineBase``) and exit 0.  ``log``: a file that takes the ranks'
    output (else they write to this process's); ``on_spawn(pids)`` is
    called once every rank is started."""
    # the ranks import this package from where this process found it
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p)
    with tempfile.TemporaryDirectory() as rdv:
        base = {**os.environ, **(env or {}), "WORLD_SIZE": str(world),
                "PYTHONPATH": path,
                ENV_INIT: "file://" + os.path.join(rdv, "rendezvous"),
                ENV_BACKEND: backend}
        out = open(log, "a") if log is not None else None
        try:
            procs = [subprocess.Popen([sys.executable, "-m", entry, *argv],
                                      env={**base, "RANK": str(r)},
                                      stdout=out, stderr=out)
                     for r in range(world)]
        finally:
            if out is not None:
                out.close()          # the ranks hold their own copies
        if on_spawn is not None:
            on_spawn([p.pid for p in procs])
        forwarded = {}

        def forward(sig, _frame):
            for p in procs:
                if p.poll() is None:
                    p.send_signal(sig)

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                forwarded[sig] = signal.signal(sig, forward)
            except ValueError:        # not the main thread
                pass
        try:
            _wait_all(procs, timeout)
        finally:
            for sig, handler in forwarded.items():
                signal.signal(sig, handler)
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()


def _wait_all(procs: list, timeout: float | None) -> None:
    start = time.monotonic()
    while True:
        codes = [p.poll() for p in procs]
        failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
        if failed:
            for p in procs:
                if p.poll() is None:
                    p.terminate()
            raise RuntimeError(
                f"rank(s) {failed} of {len(procs)} exited with "
                f"{[codes[r] for r in failed]}; the others were stopped")
        if all(c == 0 for c in codes):
            return
        if timeout is not None and time.monotonic() - start > timeout:
            raise RuntimeError(
                f"ranks {[r for r, c in enumerate(codes) if c is None]} of "
                f"{len(procs)} still running after the join timeout of "
                f"{timeout:g} s; every rank was killed")
        time.sleep(0.05)
