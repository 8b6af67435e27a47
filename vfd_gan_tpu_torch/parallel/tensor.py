"""Tensor parallelism over channels (port of the ``tp`` branch of
``vfd_gan_tpu.parallel.mesh``: ``param_spec`` and ``state_shardings``).

JAX shards the trailing axis of every state leaf over the mesh's ``tp``
axis when ``tp`` divides it, and leaves it replicated otherwise; Adam's
moments follow their leaves, scalars stay whole.  That trailing axis is
the output channel of every conv, BatchNorm and Dense leaf: spatial
kernels ``(kh, kw, Cin, Cout)``, temporal kernels ``(kt, Cin, Cout)``,
transposed kernels ``(kh, kw, Cin, Cout)``, biases, BatchNorm scale, bias,
mean and variance ``(C,)``, Dense kernels ``(in, out)``.  In the port's
layout it is dim 0 of each ``Conv3d``, ``Conv2d``, ``Linear`` and
BatchNorm tensor and dim 1 of a ``ConvTranspose2d`` weight ``(Cin, Cout,
kh, kw)`` (a ``ConvTranspose3d``'s too: AnoGAN's, not ported yet).  The
MoE block keeps JAX's layouts (``models/moe_block.MoEMlp``: ``router (C,
E)``, ``experts_w1/w2 (E, C, C)``, ``experts_b1/b2 (E, C)``), so there it
is the last dim of each, but under ``--moe_shards`` JAX's first branch
puts the expert leaves on ``ep`` by their leading axis
(``expert_tensors``), and the router alone stays on ``tp``.
GSPMD then inserts the activation collectives; the port adds
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
runs replicated on the tp ranks from the same draws.  ``StateShards``
keeps the rank's slices of the parameters, running statistics and Adam
moments (and under ``--moe_shards`` its experts) and gathers them whole
for a checkpoint, a resume or a state read.
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
    """The rank's output channels of ``channels`` (of a group's place
    ``tp``; an ep place's are its experts, ``ExpertParallel.experts``)."""
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
    """The rank's channel slice (dim ``dim``) put into the whole tensor on
    every rank of the tp group: one all-reduce SUM of the slices, each in
    its channels of a zero buffer.  Its backward is the rank's slice of
    the gradient (the ``"tp_gather"`` control: summed over the group
    first)."""

    @staticmethod
    def forward(ctx, y, tp, dim):
        ctx.tp, ctx.dim, ctx.n = tp, dim, y.shape[dim]
        shape = list(y.shape)
        shape[dim] *= tp.size
        full = y.new_zeros(shape)
        full.narrow(dim, tp.index * ctx.n, ctx.n).copy_(y)
        with tp.count("gather"):
            dist.all_reduce(full, group=tp.group)
        return full

    @staticmethod
    def backward(ctx, grad):
        tp = ctx.tp
        if "tp_gather" in tp.local_ops:
            grad = grad.detach().contiguous().clone()
            dist.all_reduce(grad, group=tp.group)
        return grad.narrow(ctx.dim, tp.index * ctx.n,
                           ctx.n).contiguous(), None, None


def copy_in(x: torch.Tensor, tp) -> torch.Tensor:
    """``x`` into a split conv (``_CopyIn``; the ``"tp_copy"`` control:
    as it is, its gradient not summed)."""
    if "tp_copy" in tp.local_ops:
        return x
    return _CopyIn.apply(x, tp)


def gather(y: torch.Tensor, tp, dim: int = 1) -> torch.Tensor:
    """The whole tensor of the rank's channel slice ``y`` (``_Gather``;
    the channels on ``dim``)."""
    return _Gather.apply(y, tp, dim % y.dim())


def column(tp, channels: int, x: torch.Tensor, fn,
           dim: int = 1) -> torch.Tensor:
    """``fn(x)``, a segment whose first conv (or product) has ``channels``
    outputs on ``dim`` and whose rest is channel-local: under ``tp`` where
    they split, on the rank's slice between ``copy_in`` and ``gather``;
    else whole."""
    if not split(tp, channels):
        return fn(x)
    return gather(fn(copy_in(x, tp)), tp, dim)


# -- the rank's slices of the state -------------------------------------------

# Adam's per-element state of a parameter, split with it
_MOMENTS = ("exp_avg", "exp_avg_sq")


def _own_tensors(m: nn.Module):
    return ((name, t) for name, t in (*m.named_parameters(recurse=False),
                                      *m.named_buffers(recurse=False))
            if t is not None and t.dim() >= 1)


def split_tensors(module: nn.Module, tp_size: int, ep_size: int = 1):
    """``(module, name, channels, dim)`` of each tensor of ``module`` that
    ``splits`` puts on channel slices over ``tp_size`` ranks, ``dim`` the
    axis JAX's ``param_spec`` shards in the port's layout: every
    parameter and buffer but a scalar (``num_batches_tracked``) of a
    ``Conv3d``, ``Conv2d``, ``Linear`` or BatchNorm (dim 0) and of a
    ``ConvTranspose2d`` (its weight's dim 1, its bias's dim 0) whose
    output channels split, and each MoE leaf whose last dim splits (the
    router's experts, the expert MLPs' channels), but the expert leaves
    when ``ep_size`` > 1 expert shards take them on their leading axis
    (``expert_tensors``: JAX ``state_shardings``' first branch, which
    takes them when ``ep_size`` divides the experts, as the port's config
    demands).  Raises on a ``ConvTranspose3d`` that would split (AnoGAN's;
    ROADMAP queue 1 item 13 tp step c)."""
    from vfd_gan_tpu_torch.models.moe_block import MoEMlp

    out = []
    for m in module.modules():
        if isinstance(m, MoEMlp):
            for name, t in _own_tensors(m):
                if name.startswith("experts") and ep_size > 1:
                    continue            # the ep axis's (expert_tensors)
                # (the whole sizes: the leaf may hold a slice already)
                size = m.n_experts if name == "router" else m.channels
                if splits(size, tp_size):
                    out.append((m, name, size, t.dim() - 1))
            continue
        if isinstance(m, nn.ConvTranspose3d):
            if splits(m.out_channels, tp_size):
                raise NotImplementedError(
                    "--tp: a splitting ConvTranspose3d (its output axis "
                    "is its weight's dim 1) is not ported yet (ROADMAP.md "
                    "queue 1 item 13 tp step c)")
            continue
        if isinstance(m, (nn.Conv3d, nn.Conv2d, nn.ConvTranspose2d)):
            channels = m.out_channels
        elif isinstance(m, nn.Linear):
            channels = m.out_features
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            channels = m.num_features
        else:
            continue
        if not splits(channels, tp_size):
            continue
        transposed = isinstance(m, nn.ConvTranspose2d)
        for name, _ in _own_tensors(m):
            out.append((m, name, channels,
                        1 if transposed and name == "weight" else 0))
    return out


def expert_tensors(module: nn.Module):
    """``(module, name, experts, 0)`` of each expert-stacked leaf of the
    MoE blocks of ``module`` (``experts_w1/b1/w2/b2``): what
    ``--moe_shards`` expert shards split on their leading axis (JAX
    ``state_shardings``' ``P("ep")``)."""
    from vfd_gan_tpu_torch.models.moe_block import MoEMlp

    return [(m, name, m.n_experts, 0) for m in module.modules()
            if isinstance(m, MoEMlp) for name, _ in _own_tensors(m)
            if name.startswith("experts")]


def held_elements(module: nn.Module, tp_size: int,
                  buffers: bool = True) -> int:
    """The parameter and (with ``buffers``) running-statistic elements of
    ``module`` that one of ``tp_size`` ranks holds (each split tensor's
    ``1 / tp_size``, the rest whole); its parameters' share is that of
    each Adam moment.  ``module`` holds its whole tensors."""
    split_ids = {id(getattr(m, name)) for m, name, _, _ in
                 split_tensors(module, tp_size)}
    tensors = (*module.parameters(), *(module.buffers() if buffers else ()))
    return sum(t.numel() // (tp_size if id(t) in split_ids else 1)
               for t in tensors if t.dim() >= 1)


class StateShards:
    """The nets' split leaves (JAX ``state_shardings``): under ``--tp``
    each leaf that ``splits``, on its own axis over the tp group
    (``split_tensors``), under ``--moe_shards`` the MoE block's expert
    leaves, on their leading axis over the ep group (``expert_tensors``),
    and the Adam moments of each with it.  The rank holds its slice of
    each (the same rows of each group's formula: ``channel_slice``)
    between the blocks of ``whole``, which gathers every tensor and its
    moments whole on every rank (a save, a resume, a state read; each
    rank enters it at the same point).  Built on the nets' whole tensors
    (the initialiser's draws, the same for any ``--tp`` or
    ``--moe_shards``); no leaf is on both axes (under tp x ep the expert
    leaves are ep's, whole on every tp rank of an ep rank)."""

    def __init__(self, modules, tp=None, ep=None):
        # (module, name, whole size, dim, the group's place) of each
        self.tensors = []
        for m in modules:
            if ep is not None:
                self.tensors += [(*t, ep) for t in expert_tensors(m)]
            if tp is not None:
                self.tensors += [
                    (*t, tp) for t in split_tensors(
                        m, tp.size, ep.size if ep is not None else 1)]
        leaves = [id(getattr(m, name)) for m, name, *_ in self.tensors]
        if len(set(leaves)) != len(leaves):
            raise RuntimeError("a leaf split over both tp and ep")

    @property
    def params(self) -> list:
        """The split parameters (the rank's own: ``mean_grads``'
        ``sharded``)."""
        return [getattr(m, name) for m, name, *_ in self.tensors
                if isinstance(getattr(m, name), nn.Parameter)]

    def _slots(self, optimizers):
        """``(owner, key, tensor, size, dim, axis)`` of every split tensor
        and of its Adam moments: ``owner`` a module (``key`` its
        attribute) or an optimizer's per-parameter state."""
        states = {}
        for opt in optimizers:
            states.update(opt.state)
        for m, name, size, dim, axis in self.tensors:
            t = getattr(m, name)
            yield m, name, t, size, dim, axis
            state = states.get(t, {}) if isinstance(t, nn.Parameter) else {}
            for k in _MOMENTS:
                if k in state:
                    yield state, k, state[k], size, dim, axis

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
        moments (a no-op on what is already sliced).  The control
        ``"tp_deconv_dim0"`` (the tp group's ``local_ops``) cuts a
        ``ConvTranspose2d`` weight on dim 0, its input channels, and
        reads the rows in the layout of its slice (the element count is
        the same)."""
        with torch.no_grad():
            self._release(optimizers)

    def _release(self, optimizers) -> None:
        for owner, key, t, size, dim, axis in list(self._slots(optimizers)):
            if t.shape[dim] != size:
                continue
            rows = channel_slice(axis, size)
            part = t.narrow(dim, rows.start, rows.stop - rows.start)
            if isinstance(owner, nn.ConvTranspose2d) and dim \
                    and "tp_deconv_dim0" in axis.local_ops:
                n = t.shape[0] // axis.size
                part = t.narrow(0, axis.index * n, n).reshape(part.shape)
            self._put(owner, key, part.clone())

    @contextlib.contextmanager
    def whole(self, optimizers=()):
        """Every split tensor and its Adam moments whole on this rank for
        the block (one all-reduce of each group's slices, each in its
        rows of a zero buffer: a value plus zeros, exact in the tensors'
        own dtype), the rank's own kept after it.  Outside autograd: a
        running statistic made of the parameters' buffer would require
        grad, which cuDNN's eval-mode BatchNorm refuses."""
        with torch.no_grad():
            self._gather_whole(optimizers)
        try:
            yield
        finally:
            self.release(optimizers)

    def _gather_whole(self, optimizers) -> None:
        slots = list(self._slots(optimizers))
        # one all-reduce a group, in the order of the tensors (the same
        # on every rank)
        axes = list({id(s[5]): s[5] for s in slots}.values())
        for axis in axes:
            self._gather_group(axis, [s for s in slots if s[5] is axis])

    def _gather_group(self, axis, slots) -> None:
        dtype = torch.float32
        for _, _, t, *_ in slots:
            dtype = torch.promote_types(dtype, t.dtype)
        fulls = []
        for _, _, t, size, dim, _ in slots:
            shape = list(t.shape)
            shape[dim] = size
            full = t.new_zeros(shape, dtype=dtype)
            rows = channel_slice(axis, size)
            full.narrow(dim, rows.start, rows.stop - rows.start).copy_(t)
            fulls.append(full)
        flat = torch.cat([f.reshape(-1) for f in fulls])
        dist.all_reduce(flat, group=axis.group)
        offset = 0
        for (owner, key, t, *_), full in zip(slots, fulls):
            n = full.numel()
            self._put(owner, key,
                      flat[offset:offset + n].view(full.shape).to(t.dtype))
            offset += n
