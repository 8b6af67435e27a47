"""Pipeline-parallel Xception-3D: GPipe over the eight middle blocks
(port of ``vfd_gan_tpu.parallel.pp_xception``).

``--pp N [--pp_micro M]`` (Xception only) runs ``dp x pp`` ranks
(``parallel/pipeline.StageGrid``).  Stage ``s`` holds middle blocks
``block{4 + s 8/pp} .. block{3 + (s+1) 8/pp}``: it runs them, and its
optimizer steps them.  One train step, on every rank of a pp group (the
same rows of the batch):

* ``front`` (stem and entry blocks) and ``back`` (exit block to head) run
  on every rank with the batch's BatchNorm statistics (over the dp
  subgroup), as GSPMD's replicated layers compute in JAX; only stage 0's
  front feeds the chain, so the other stages run theirs without a graph
  (its running statistics move alike on every rank);
* the middle chain is ``parallel/pipeline.GPipe``: M microbatches with
  per-microbatch BatchNorm statistics, the last stage's output handed to
  every rank, where ``back`` and the loss run (the dropout's draws are the
  engine generator's global draws, the same on every stage);
* gradients: the chain's backward per microbatch down the stages, stage
  0's into its front; then ``share_grads`` broadcasts stage 0's gradients
  of every parameter outside the chain (the front's exist there alone; the
  back's are equal on every stage) in the pp group, and the dp mean of
  every gradient runs in the dp subgroup (``DataParallel.mean_grads``).

A stage holds its own blocks alone: on every rank the other stages'
blocks keep their modules and names but hold no storage, no gradient and
no Adam state (``release``), as JAX's stage-sharded stack leaves each
device ``8/pp`` of the blocks.  Checkpoints stay canonical: ``whole``
gives every rank of a pp group every block (parameters, BatchNorm
buffers, Adam's moments and step, broadcast from the stage that holds
them) for a block of code (a test sweep, which every rank runs whole;
``latest.pt`` and a best ``.pth``, which rank 0 writes) and releases them
after it, so that ``infer``, ``serve``, ``evaluate_models`` and a plain
``--resume`` load a ``--pp`` run's files with ``strict=True``, and a
``--pp`` run resumes from a plain run's (it loads whole, then releases).
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from vfd_gan_tpu_torch.models.xception3d import N_MIDDLE_BLOCKS
from vfd_gan_tpu_torch.parallel.pipeline import GPipe, StageGrid, stage_blocks


class XceptionPipeline:
    """The pipelined train forward and backward of one ``Xception3D`` on
    ``grid`` (``None``: the chain run sequentially per microbatch in this
    process, the reference of the equivalence checks)."""

    def __init__(self, model, grid: StageGrid | None, n_micro: int):
        self.model = model
        self.grid = grid
        blocks = model.middle_blocks()
        self.owned = [blocks[i] for i in stage_blocks(
            N_MIDDLE_BLOCKS, grid.pp, grid.stage)] if grid else blocks
        self.gpipe = GPipe(self.owned, grid, n_micro)
        # the shapes of the released tensors of the other stages' blocks
        self._shapes: dict = {}
        chain = {id(p) for b in blocks for p in b.parameters()}
        # the parameters outside the chain, in the module's order
        self.replicated = [p for p in model.parameters()
                           if id(p) not in chain]

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``model(x, generator)`` with the middle chain pipelined."""
        if self.grid is None or self.grid.first:
            h = self.model.front(x)
        else:
            with torch.no_grad():
                h = self.model.front(x)
        return self.model.back(self.gpipe.forward(h), generator)

    def backward(self) -> None:
        """The chain's backward, after the caller's ``loss.backward()``,
        and the replicated parameters' gradients shared."""
        self.gpipe.backward()
        self.share_grads()

    def share_grads(self) -> None:
        """Stage 0's gradients of the parameters outside the chain, to
        every rank of its pp group: one flattened broadcast."""
        if self.grid is None:
            return
        for p in self.replicated:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        flat = torch.cat([p.grad.reshape(-1) for p in self.replicated])
        dist.broadcast(flat, self.grid.rank_of(0), group=self.grid.pp_group)
        offset = 0
        for p in self.replicated:
            p.grad.copy_(flat[offset:offset + p.numel()].view_as(p))
            offset += p.numel()

    def _foreign(self):
        """``(module, name, is a parameter)`` of every tensor of the
        blocks that the other stages hold."""
        mine = {id(b) for b in self.owned}
        for block in self.model.middle_blocks():
            if id(block) in mine:
                continue
            for mod in block.modules():
                for name, t in mod._parameters.items():
                    if t is not None:
                        yield mod, name, True
                for name, t in mod._buffers.items():
                    if t is not None:
                        yield mod, name, False

    def release(self, optimizer: torch.optim.Optimizer) -> None:
        """Free this rank's copies of the other stages' blocks (their
        storage and Adam state); their shapes are kept for ``whole``."""
        if self.grid is None or self._shapes:
            return
        for mod, name, is_param in self._foreign():
            t = getattr(mod, name)
            self._shapes[(id(mod), name)] = t.shape
            if is_param:
                optimizer.state.pop(t, None)
                t.data = t.data.new_empty(0)
            else:
                mod._buffers[name] = t.new_empty(0)

    @contextlib.contextmanager
    def whole(self, optimizer: torch.optim.Optimizer):
        """Every stage's blocks on this rank for the block (each rank of
        the pp group calls it at the same point), released after it."""
        if self.grid is None:
            yield
            return
        for mod, name, is_param in self._foreign():
            shape = self._shapes.pop((id(mod), name), None)
            if shape is None:
                continue
            t = getattr(mod, name)
            if is_param:
                t.data = t.data.new_empty(shape)
            else:
                mod._buffers[name] = t.new_empty(shape)
        self._gather(optimizer)
        try:
            yield
        finally:
            self.release(optimizer)

    def _gather(self, optimizer: torch.optim.Optimizer) -> None:
        """Every stage's blocks from the stage that holds them to the
        other ranks of its pp group: parameters, buffers and Adam's state,
        one float64 broadcast per stage (exact for float32 and float64
        tensors and integer counts)."""
        grid = self.grid
        blocks = self.model.middle_blocks()
        for stage in range(grid.pp):
            tensors = []
            for i in stage_blocks(N_MIDDLE_BLOCKS, grid.pp, stage):
                for p in blocks[i].parameters():
                    state = optimizer.state[p]
                    if not state:
                        # Adam's own initial state, as its first step
                        # would make it
                        state["step"] = torch.tensor(0.0)
                        state["exp_avg"] = torch.zeros_like(p)
                        state["exp_avg_sq"] = torch.zeros_like(p)
                    tensors += [p.data, state["step"], state["exp_avg"],
                                state["exp_avg_sq"]]
                tensors += list(blocks[i].buffers())
            device = tensors[0].device
            flat = torch.cat([t.detach().reshape(-1).to(device, torch.float64)
                              for t in tensors])
            dist.broadcast(flat, grid.rank_of(stage), group=grid.pp_group)
            offset = 0
            for t in tensors:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()
