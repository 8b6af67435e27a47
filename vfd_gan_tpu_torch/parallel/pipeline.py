"""Pipeline parallelism (GPipe) over a chain of same-signature blocks
(port of ``vfd_gan_tpu.parallel.pipeline``).

The JAX package runs ``--pp`` as one program over a mesh whose last axis
is ``pp``: the chain's blocks are stacked and sharded over it, the batch
is cut into M microbatches, a ``lax.scan`` hands activations to the next
stage with ``ppermute``, and ``jax.grad`` transposes the whole.  The port
runs one process per (dp, pp) place on ``torch.distributed`` and writes
that schedule out:

* ``StageGrid``: the ranks of one command as a ``dp x pp`` grid, pp the
  last axis as in JAX's mesh (rank = d pp + s); the dp subgroup of each
  stage (its ranks hold the stage's blocks and split each microbatch's
  rows), the pp subgroup of each dp index (its ranks hold the same rows,
  one stage each) and a two-rank group for each pair of neighbouring
  stages, where the hand-offs run.
* ``GPipe``: one stage's part of a step.  The forward runs the M
  microbatches in order through this stage's blocks, each taken from the
  previous stage and handed to the next (stage 0 takes them from its own
  input); the last stage's outputs reach every rank of the pp group (JAX's
  final ``psum``).  After the caller's ``loss.backward()`` has reached the
  chain's output, ``backward`` runs the chain's backward per microbatch,
  the gradients handed from each stage to the one before, and stage 0's
  reaches its input's graph.  All forwards, then all backwards: no
  overlap of stages.

The hand-offs are ``broadcast`` in the neighbour group (the only
collectives besides ``all_reduce``), so gloo runs them on CUDA tensors as
well, several ranks on one card.  A stage's BatchNorm statistics are each
microbatch's (over its dp subgroup, ``parallel/mesh.DataParallel``):
exactly the chain run sequentially per microbatch on one device, which is
what ``GPipe`` runs when there is no grid (``grid=None``), and what the
equivalence checks hold the grid to (``tools/dp_equivalence.py``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class StageGrid:
    """This process's place in a ``dp x pp`` grid of the process group.

    Every rank builds every subgroup, in one order (``dist.new_group`` is
    a collective of the whole group); ``stage_grid`` makes one per
    process and pp size."""

    def __init__(self, pp: int):
        self.rank = dist.get_rank()
        world = dist.get_world_size()
        if world % pp:
            raise ValueError(f"{world} ranks do not split into pp={pp} "
                             "stages")
        self.pp, self.dp_size = pp, world // pp
        self.stage, self.dp_index = self.rank % pp, self.rank // pp
        self.dp_group = self.pp_group = None
        self.prev_group = self.next_group = None
        for s in range(pp):
            g = dist.new_group([d * pp + s for d in range(self.dp_size)])
            if s == self.stage:
                self.dp_group = g
        for d in range(self.dp_size):
            g = dist.new_group([d * pp + s for s in range(pp)])
            if d == self.dp_index:
                self.pp_group = g
            for s in range(pp - 1):
                g = dist.new_group([d * pp + s, d * pp + s + 1])
                if d == self.dp_index and s == self.stage:
                    self.next_group = g
                if d == self.dp_index and s + 1 == self.stage:
                    self.prev_group = g

    @property
    def first(self) -> bool:
        return self.stage == 0

    @property
    def last(self) -> bool:
        return self.stage == self.pp - 1

    def rank_of(self, stage: int) -> int:
        """The global rank of ``stage`` in this rank's pp group."""
        return self.dp_index * self.pp + stage


_GRIDS: dict = {}


def stage_grid(pp: int) -> StageGrid:
    """This process's grid for ``pp`` stages (made once per process
    group)."""
    key = (pp, id(dist.group.WORLD))
    if key not in _GRIDS:
        _GRIDS[key] = StageGrid(pp)
    return _GRIDS[key]


def stage_blocks(n_blocks: int, pp: int, stage: int) -> range:
    """The indices of the blocks that ``stage`` holds: a contiguous
    ``n_blocks / pp`` of them."""
    if n_blocks % pp:
        raise ValueError(f"{n_blocks} blocks do not divide over pp={pp}")
    k = n_blocks // pp
    return range(stage * k, (stage + 1) * k)


def _buffer(like: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor of ``like``'s shape to receive into: a
    broadcast moves storage, and a conv's output on the card may be
    channels-last (``empty_like`` would keep its strides and read the
    sender's contiguous bytes in the wrong order)."""
    return torch.empty(like.shape, dtype=like.dtype, device=like.device)


class GPipe:
    """One stage's part of the GPipe schedule over ``blocks`` (callables
    ``x -> y`` of one signature): on ``grid``, this stage's blocks; with
    ``grid=None``, the whole chain in one process, run per microbatch."""

    def __init__(self, blocks, grid: StageGrid | None, n_micro: int):
        self.blocks = list(blocks)
        self.grid = grid
        self.n_micro = n_micro
        self._saved = None
        # hand-offs made by the last forward and backward
        self.hand_offs = 0

    def _chain(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x

    def _hand(self, x: torch.Tensor, group, src: int) -> torch.Tensor:
        dist.broadcast(x, src, group=group)
        self.hand_offs += 1
        return x

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        """The chain's output for ``h`` (this rank's rows: M microbatches
        of equal size, contiguous).  On a grid the output is a leaf that
        requires grad (its gradient, after the caller's backward, is what
        ``backward`` sends down the chain); stage 0's ``h`` keeps its
        graph, the other stages' is read for its shape alone."""
        if h.shape[0] % self.n_micro:
            raise ValueError(f"{h.shape[0]} rows are not {self.n_micro} "
                             "microbatches")
        chunks = h.chunk(self.n_micro)
        if self.grid is None:
            return torch.cat([self._chain(c) for c in chunks])
        grid = self.grid
        self.hand_offs = 0
        ins, outs = [], []
        for c in chunks:
            if grid.first:
                x = c
            else:
                x = self._hand(_buffer(c), grid.prev_group,
                               grid.rank_of(grid.stage - 1))
                x.requires_grad_(torch.is_grad_enabled())
            y = self._chain(x)
            if not grid.last:
                self._hand(y.detach().contiguous(), grid.next_group,
                           grid.rank)
            ins.append(x)
            outs.append(y)
        out = torch.cat([y.detach() for y in outs]).contiguous() \
            if grid.last else _buffer(h)
        # the last stage's output to every rank of the pp group
        dist.broadcast(out, grid.rank_of(grid.pp - 1), group=grid.pp_group)
        out.requires_grad_(torch.is_grad_enabled())
        self._saved = (ins, outs, out)
        return out

    def backward(self) -> None:
        """The chain's backward from the gradient that the caller's
        backward left on ``forward``'s output, per microbatch in order,
        each stage's input gradient handed to the stage before; stage 0's
        reaches ``h``'s graph (one backward over its microbatches)."""
        if self.grid is None or self._saved is None:
            return
        grid = self.grid
        ins, outs, out = self._saved
        self._saved = None
        grads = out.grad.chunk(self.n_micro) if grid.last else None
        firsts = []
        for m, (x, y) in enumerate(zip(ins, outs)):
            if grid.last:
                g = grads[m].contiguous()
            else:
                g = self._hand(_buffer(y), grid.next_group,
                               grid.rank_of(grid.stage + 1))
            if grid.first:
                firsts.append(g)
                continue
            torch.autograd.backward(y, g)
            self._hand(x.grad.contiguous(), grid.prev_group, grid.rank)
        if grid.first and outs[0].requires_grad:
            torch.autograd.backward(outs, firsts)
