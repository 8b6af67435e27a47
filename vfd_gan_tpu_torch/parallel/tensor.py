"""Tensor parallelism over channels (port of the ``tp`` branch of
``vfd_gan_tpu.parallel.mesh``: ``param_spec`` and ``state_shardings``).

JAX shards the trailing axis of every state leaf over the mesh's ``tp``
axis when ``tp`` divides it, and leaves it replicated otherwise; Adam's
moments follow their leaves, scalars stay whole.  That trailing axis is
the output channel of every leaf of the nets that take ``--tp``: spatial
kernels ``(kh, kw, Cin, Cout)``, temporal kernels ``(kt, Cin, Cout)``,
biases, BatchNorm scale, bias, mean and variance ``(C,)``, Dense kernels
``(in, out)``; in the port's layout it is dim 0 of each ``Conv3d``,
``Linear`` and BatchNorm tensor (a ``ConvTranspose3d`` weight is ``(Cin,
Cout, ...)``: its output axis is dim 1, and no net that takes ``--tp``
has one).  GSPMD then inserts the activation collectives; the port adds
them by hand, column-parallel:

* a conv whose output channels split (``split``) takes its input through
  ``copy_in`` (the identity; its backward sums the input's gradient over
  the tp group, where each rank holds its own ``W_t^T dY_t``), runs on the
  rank's rows of its weight and bias, and the channel-local BatchNorm and
  activation after it run on the same slice; ``gather`` then puts the
  slices together (one all-reduce SUM of a zero-padded buffer: the other
  terms are exact zeros, so the whole tensor is the tp 1 one bit for bit)
  and its backward keeps the rank's slice of the gradient, with no sum
  (every rank's loss is the replicated loss);
* a conv whose output channels do not split runs whole on every tp rank,
  with no collective.

So every activation between two such segments is whole on every tp rank,
and the rest of a step (the augment, the flow, the losses, the opening)
runs replicated on the tp ranks from the same draws.  ``TpShards`` keeps
the rank's slices of the parameters, running statistics and Adam moments
and gathers them whole for a checkpoint, a resume or a state read.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
import torch.nn as nn


def splits(channels: int, tp: int) -> bool:
    """JAX ``param_spec``'s rule: is a leaf whose trailing (output
    channel) axis has ``channels`` sharded over ``tp`` ranks?"""
    return tp > 1 and channels > 0 and channels % tp == 0


def split(tp, channels: int) -> bool:
    """Does a conv of ``channels`` outputs run on the rank's slice under
    ``tp`` (a ``parallel.mesh.TensorParallel``, or None)?"""
    return tp is not None and splits(channels, tp.size)


def channel_slice(tp, channels: int) -> slice:
    """The rank's output channels of ``channels``."""
    n = channels // tp.size
    return slice(tp.index * n, (tp.index + 1) * n)


class _CopyIn(torch.autograd.Function):
    """The identity on a split conv's input; its backward sums the
    gradient over the tp group (each rank's is its own slice's part)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        g = grad.detach().contiguous().clone()
        with ctx.tp.count("copy"):
            dist.all_reduce(g, group=ctx.tp.group)
        return g, None


class _Gather(torch.autograd.Function):
    """The rank's channel slice (dim 1) put into the whole tensor on every
    rank of the tp group: one all-reduce SUM of the slices, each in its
    channels of a zero buffer.  Its backward is the rank's slice of the
    gradient (the ``"tp_gather"`` control: summed over the group first)."""

    @staticmethod
    def forward(ctx, y, tp):
        ctx.tp, ctx.n = tp, y.shape[1]
        full = y.new_zeros((y.shape[0], y.shape[1] * tp.size, *y.shape[2:]))
        full[:, tp.index * ctx.n:(tp.index + 1) * ctx.n] = y
        with tp.count("gather"):
            dist.all_reduce(full, group=tp.group)
        return full

    @staticmethod
    def backward(ctx, grad):
        tp = ctx.tp
        if "tp_gather" in tp.local_ops:
            grad = grad.detach().contiguous().clone()
            dist.all_reduce(grad, group=tp.group)
        return grad.narrow(1, tp.index * ctx.n, ctx.n).contiguous(), None


def copy_in(x: torch.Tensor, tp) -> torch.Tensor:
    """``x`` into a split conv (``_CopyIn``; the ``"tp_copy"`` control:
    as it is, its gradient not summed)."""
    if "tp_copy" in tp.local_ops:
        return x
    return _CopyIn.apply(x, tp)


def gather(y: torch.Tensor, tp) -> torch.Tensor:
    """The whole tensor of the rank's channel slice ``y`` (``_Gather``)."""
    return _Gather.apply(y, tp)


def column(tp, channels: int, x: torch.Tensor, fn) -> torch.Tensor:
    """``fn(x)``, a segment whose first conv has ``channels`` outputs and
    whose rest is channel-local: under ``tp`` where they split, on the
    rank's slice between ``copy_in`` and ``gather``; else whole."""
    if not split(tp, channels):
        return fn(x)
    return gather(fn(copy_in(x, tp)), tp)


# -- the rank's slices of the state -------------------------------------------

# Adam's per-element state of a parameter, split with it
_MOMENTS = ("exp_avg", "exp_avg_sq")


def split_tensors(module: nn.Module, tp_size: int):
    """``(module, name, channels)`` of each tensor of ``module`` that
    ``splits`` puts on channel slices over ``tp_size`` ranks: every
    parameter and buffer of a ``Conv3d``, a ``Linear`` or a BatchNorm
    whose output channels split, but a scalar (``num_batches_tracked``).
    Raises on a ``ConvTranspose3d`` that would split (its output axis is
    dim 1; no net that takes ``--tp`` has one)."""
    out = []
    for m in module.modules():
        if isinstance(m, nn.Conv3d):
            channels = m.out_channels
        elif isinstance(m, nn.Linear):
            channels = m.out_features
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            channels = m.num_features
        elif isinstance(m, nn.ConvTranspose3d):
            if splits(m.out_channels, tp_size):
                raise NotImplementedError(
                    "--tp: a ConvTranspose3d's output axis is its weight's "
                    "dim 1")
            continue
        else:
            continue
        if not splits(channels, tp_size):
            continue
        for name, t in (*m.named_parameters(recurse=False),
                        *m.named_buffers(recurse=False)):
            if t is not None and t.dim() >= 1:
                out.append((m, name, channels))
    return out


def held_elements(module: nn.Module, tp_size: int,
                  buffers: bool = True) -> int:
    """The parameter and (with ``buffers``) running-statistic elements of
    ``module`` that one of ``tp_size`` ranks holds (each split tensor's
    ``1 / tp_size``, the rest whole); its parameters' share is that of
    each Adam moment.  ``module`` holds its whole tensors."""
    split_ids = {id(getattr(m, name)) for m, name, _ in
                 split_tensors(module, tp_size)}
    tensors = (*module.parameters(), *(module.buffers() if buffers else ()))
    return sum(t.numel() // (tp_size if id(t) in split_ids else 1)
               for t in tensors if t.dim() >= 1)


class TpShards:
    """The nets' split tensors over the tp group (``--tp``; JAX
    ``state_shardings``' ``P(..., "tp")`` on every leaf that ``splits``
    and on its Adam moments): the rank holds its channel slice of each
    between the blocks of ``whole``, which gathers every tensor and its
    moments whole on every rank of the group (a save, a resume, a state
    read; each rank of the group enters it at the same point), as
    ``parallel/moe.ExpertShards`` gathers the experts.  Built on the
    nets' whole tensors (the initialiser's draws, the same for any
    ``--tp``)."""

    def __init__(self, modules, tp):
        self.tp = tp
        # (module, name, channels) of each split tensor
        self.tensors = [entry for m in modules
                        for entry in split_tensors(m, tp.size)]

    @property
    def params(self) -> list:
        """The split parameters (the rank's own: ``mean_grads``'
        ``sharded``)."""
        return [getattr(m, name) for m, name, _ in self.tensors
                if isinstance(getattr(m, name), nn.Parameter)]

    def _slots(self, optimizers):
        """``(owner, key, tensor, channels)`` of every split tensor and
        of its Adam moments: ``owner`` a module (``key`` its attribute) or
        an optimizer's per-parameter state."""
        states = {}
        for opt in optimizers:
            states.update(opt.state)
        for m, name, channels in self.tensors:
            t = getattr(m, name)
            yield m, name, t, channels
            state = states.get(t, {}) if isinstance(t, nn.Parameter) else {}
            for k in _MOMENTS:
                if k in state:
                    yield state, k, state[k], channels

    @staticmethod
    def _put(owner, key, value: torch.Tensor) -> None:
        if isinstance(owner, dict):
            owner[key] = value
        elif isinstance(getattr(owner, key), nn.Parameter):
            getattr(owner, key).data = value
        else:
            setattr(owner, key, value)

    def release(self, optimizers=()) -> None:
        """Keep the rank's slice of each split tensor and of its Adam
        moments (a no-op on what is already sliced)."""
        for owner, key, t, channels in list(self._slots(optimizers)):
            if t.shape[0] == channels:
                self._put(owner, key,
                          t[channel_slice(self.tp, channels)].clone())

    @contextlib.contextmanager
    def whole(self, optimizers=()):
        """Every split tensor and its Adam moments whole on this rank for
        the block (one all-reduce of the group's slices, each in its rows
        of a zero buffer, in float64: exact), the rank's own kept after
        it."""
        slots = list(self._slots(optimizers))
        fulls = []
        for _, _, t, channels in slots:
            full = t.new_zeros((channels, *t.shape[1:]), dtype=torch.float64)
            full[channel_slice(self.tp, channels)] = t
            fulls.append(full)
        if fulls:
            flat = torch.cat([f.reshape(-1) for f in fulls])
            dist.all_reduce(flat, group=self.tp.group)
            offset = 0
            for (owner, key, t, _), full in zip(slots, fulls):
                n = full.numel()
                self._put(owner, key,
                          flat[offset:offset + n].view(full.shape).to(t.dtype))
                offset += n
        try:
            yield
        finally:
            self.release(optimizers)
