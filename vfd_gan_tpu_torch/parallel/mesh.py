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
    ``--pp`` stages and ``--dp 0`` means all of them; on the CPU the
    request is the number of processes to start (``--dp 0``: one)."""
    pp = max(1, cfg.pp)
    micro = cfg.n_pp_micro if pp > 1 else max(1, cfg.accum)
    if device_type == "cuda":
        cards = max(1, torch.cuda.device_count())
        if pp > cards:
            raise SystemExit(f"--pp {pp}: {pp} stages need {pp} cards, "
                             f"{cards} visible")
        n = cards // pp
    else:
        n = max(1, cfg.dp)
    dp = auto_dp(cfg.batchsize // micro, cfg.dp, n)
    if device_type == "cuda" or dp != max(1, cfg.dp):
        print(f" >> --dp {cfg.dp} -> dp {dp} ({n} {device_type} "
              f"device(s){f' per stage of --pp {pp}' if pp > 1 else ''}, "
              f"microbatch {cfg.batchsize // micro})", flush=True)
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
    ``"stretch"``; ``synced``)."""

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
        sweep: every rank runs it whole)."""
        on, self._on = self._on, False
        try:
            yield
        finally:
            self._on = on

    def bind(self, module: torch.nn.Module) -> torch.nn.Module:
        """Point every submodule with a ``dp`` attribute (BatchNorms,
        dropout) at this group."""
        for m in module.modules():
            if hasattr(m, "dp"):
                m.dp = self
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
             device) -> torch.Tensor:
        """Uniform draws for this rank's slice of a global tensor: the
        global tensor's (``world`` times the rows of ``shape``) drawn
        from ``generator`` on its device, this rank's rows kept
        (``rows``, the forward's ``forward_micro`` microbatches) and moved
        to ``device``."""
        draw = device if generator is None else generator.device
        if not self.active:
            return torch.rand(shape, generator=generator,
                              device=draw).to(device)
        n = shape[0]
        full = torch.rand((self.world * n, *shape[1:]), generator=generator,
                          device=draw)
        rows = self.rows(self.world * n, self.forward_micro)
        return full[rows.to(full.device)].to(device)

    # -- collectives -------------------------------------------------------
    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks, differentiable (identity when
        not active)."""
        return _AllReduceSum.apply(x, self.group) if self.active else x

    def bn_sum(self, x: torch.Tensor) -> torch.Tensor:
        """A BatchNorm's sum over the ranks, as ``bn_stats`` says."""
        if self.bn_stats == "forward" and self.active:
            local = x.detach()
            total = local.clone()
            dist.all_reduce(total, group=self.group)
            return x + (total - local)
        return self.all_reduce_sum(x)

    def all_reduce_max_(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` replaced by its elementwise maximum over the ranks."""
        if self.active:
            dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.group)
        return x

    def mean_grads(self, module: torch.nn.Module) -> None:
        """Every ``.grad`` of ``module`` replaced by its mean over the
        ranks: one all-reduce of the gradients flattened."""
        if not self.active:
            return
        grads = [p.grad for p in module.parameters() if p.grad is not None]
        if not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.group)
        flat.div_(self.world)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

    def mean_metrics(self, metrics: dict) -> dict:
        """The step's 0-dim metrics averaged over the ranks (each a mean
        over an equal slice, so the mean is the global batch's)."""
        if not self.active or not metrics:
            return metrics
        names = sorted(metrics)
        flat = torch.stack([metrics[k].detach().to(torch.float64)
                            for k in names])
        dist.all_reduce(flat, group=self.group)
        flat.div_(self.world)
        return {k: flat[i].to(metrics[k].dtype) for i, k in enumerate(names)}

    def any(self, flag: bool) -> bool:
        """Is ``flag`` set on any rank of the whole process group (an
        all-reduced MAX; under ``--pp`` the stages too)?"""
        if not self.active:
            return bool(flag)
        t = torch.tensor([1.0 if flag else 0.0], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item() > 0)


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
           timeout: float | None = None, env: dict | None = None) -> None:
    """Run ``python -m entry *argv`` as ``world`` ranks of one group over
    ``backend`` (``"nccl"`` or ``"gloo"``), meeting through a file in a
    fresh temporary directory, and wait for all of them.

    A rank that exits non-zero stops the others; so does ``timeout``
    seconds passing (the join timeout), which kills every rank.  Either
    raises ``RuntimeError``; no rank is left running.  SIGTERM and SIGINT
    sent to this process are passed on to the ranks, which park together
    (``EngineBase``) and exit 0."""
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
        procs = [subprocess.Popen([sys.executable, "-m", entry, *argv],
                                  env={**base, "RANK": str(r)})
                 for r in range(world)]
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
