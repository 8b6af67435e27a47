"""Sequence (frame-axis) parallelism with halo exchange (port of
``vfd_gan_tpu.parallel.temporal``).

The JAX package shards the clip's frame axis over an ``sp`` mesh axis and
runs each temporal op per shard under ``shard_map``, with ``lax.ppermute``
bringing ``(kt-1)/2`` boundary frames from each neighbour.  The port runs
one process per shard (``parallel/mesh.SpGrid``), and each function here
is that per-shard body: it takes this rank's block of frames and its
``parallel.mesh.SeqParallel`` and returns this rank's block of the result,
equal to the rank's frames of the unsharded op.

* ``halo_exchange``: the block with ``halo`` frames of each neighbour
  around it (zeros at the edge shards, as the unsharded op's zero
  padding).  A ``torch.autograd.Function``: its backward sends each
  halo's gradient back to the neighbour it came from, which adds it to
  its edge frames.
* ``upsample2x_t_sp``: align-corners x2 over T on the *global* grid
  ``src = i (T-1) / (2T-1)``, with one halo frame a side.
* ``avg_pool2x_t_sp``: the /2 pool, local when the shard's count is even.
* ``temporal_conv_sp``: a ``(kt, 1, 1)`` conv VALID over the halo-padded
  block.
* ``gather_frames`` (every shard's frames on every peer; backward: the
  peers' gradients summed, this shard's part kept): what a net needs
  where a level's frames run out (``models/mygan.py``).
* ``carry_in`` and ``carry_out``: a recurrence chained along the row
  (``models/convlstm.py``).  Shard k takes the state that shard k-1
  carried out of its last frame (zeros on shard 0), runs its frames and
  hands its last state to shard k+1; in the backward the state's
  gradient passes the other way, from the last shard to the first.

The nets call these through the ``SeqParallel`` they are bound to
(``sp.halo``, ``sp.upsample2x_t``, ``sp.gather``, ``sp.carry_in``,
``sp.carry_out``; with ``sp.split`` and ``sp.sum``), so ``models/`` and
``ops/`` import nothing of this package.

Every hand-off is a ``broadcast`` in the two-rank group of a neighbour
pair (``SeqParallel.prev_group``/``next_group``) or in the row's sp group:
gloo's ``send`` of a CUDA tensor aborts the process, and gloo runs
broadcasts and all-reduces on CUDA tensors, several ranks on one card
(``parallel/pipeline.py``).  Receive buffers are contiguous tensors of
the block's shape (a broadcast moves storage, and a conv's output on the
card may be channels-last).  Frames are axis ``dim``: 2 for the nets'
NCDHW videos, 1 for channel-last ``(B, T, H, W, C)`` ones.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch
import torch.distributed as dist
import torch.nn.functional as F

from vfd_gan_tpu_torch.ops.resize import _linear_matrix

if TYPE_CHECKING:
    from vfd_gan_tpu_torch.parallel.mesh import SeqParallel


def _buffer(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(shape, dtype=like.dtype, device=like.device)


def _sent(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` to broadcast from: gloo's broadcast of a
    CUDA tensor writes the root's tensor back too, which would bump the
    version of a tensor that autograd saved (a 1-frame shard's halo is
    the whole block: ReLU's output, caught on the card)."""
    return x.clone(memory_format=torch.contiguous_format)


def _swap(sp: SeqParallel, to_prev: torch.Tensor | None,
          to_next: torch.Tensor | None, shape, like: torch.Tensor):
    """Each shard hands ``to_prev`` to the shard before it and ``to_next``
    to the one after it; returns ``(from_prev, from_next)``, what its
    neighbours handed it (zeros at an edge).  A direction whose tensor is
    None is not used (None on every rank alike).  Within a pair the lower
    shard's broadcast goes first, and each rank takes its pair with the
    shard before it first, so the ranks meet in one order."""
    k, n = sp.index, sp.size
    from_prev = from_next = None
    if k > 0:
        if to_next is not None:               # shard k-1 -> shard k
            from_prev = _buffer(shape, like)
            dist.broadcast(from_prev, sp.ranks[k - 1], group=sp.prev_group)
        if to_prev is not None:               # shard k -> shard k-1
            dist.broadcast(_sent(to_prev), sp.ranks[k], group=sp.prev_group)
    if k < n - 1:
        if to_next is not None:
            dist.broadcast(_sent(to_next), sp.ranks[k], group=sp.next_group)
        if to_prev is not None:
            from_next = _buffer(shape, like)
            dist.broadcast(from_next, sp.ranks[k + 1], group=sp.next_group)
    if from_prev is None and to_next is not None:
        from_prev = torch.zeros(shape, dtype=like.dtype, device=like.device)
    if from_next is None and to_prev is not None:
        from_next = torch.zeros(shape, dtype=like.dtype, device=like.device)
    return from_prev, from_next


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, halo, sp, dim, left, right):
        ctx.halo, ctx.sp, ctx.dim = halo, sp, dim
        ctx.left, ctx.right = left, right
        size = block.shape[dim]
        if halo > size:
            raise ValueError(f"a halo of {halo} frames from a shard of "
                             f"{size}")
        shape = list(block.shape)
        shape[dim] = halo
        if "halo" in sp.local_ops:            # the control: as if alone
            lo = block.new_zeros(shape) if left else None
            hi = block.new_zeros(shape) if right else None
        else:
            with sp.count("halo"):
                lo, hi = _swap(
                    sp, block.narrow(dim, 0, halo) if right else None,
                    block.narrow(dim, size - halo, halo) if left else None,
                    shape, block)
        return torch.cat([t for t in (lo, block, hi) if t is not None], dim)

    @staticmethod
    def backward(ctx, grad):
        halo, sp, dim = ctx.halo, ctx.sp, ctx.dim
        size = grad.shape[dim] - halo * (ctx.left + ctx.right)
        start = halo if ctx.left else 0
        g = grad.narrow(dim, start, size).contiguous().clone()
        if "halo" in sp.local_ops:
            return g, None, None, None, None, None
        shape = list(grad.shape)
        shape[dim] = halo
        with sp.count("halo_grad"):
            # a left halo's gradient belongs to the shard before (its last
            # frames), a right halo's to the shard after (its first)
            from_prev, from_next = _swap(
                sp, grad.narrow(dim, 0, halo) if ctx.left else None,
                grad.narrow(dim, start + size, halo) if ctx.right else None,
                shape, grad)
        if from_prev is not None:             # the shard before's right halo
            g.narrow(dim, 0, halo).add_(from_prev)
        if from_next is not None:             # the shard after's left halo
            g.narrow(dim, size - halo, halo).add_(from_next)
        return g, None, None, None, None, None


def halo_exchange(block: torch.Tensor, halo: int, sp: SeqParallel,
                  dim: int = 2, left: bool = True,
                  right: bool = True) -> torch.Tensor:
    """``block`` (this shard's frames on axis ``dim``) with ``halo``
    frames of the shard before it in front (``left``) and of the shard
    after it behind (``right``), zeros at the edge shards; differentiable
    (JAX ``halo_exchange``)."""
    return _Halo.apply(block, halo, sp, dim, left, right)


def _t_weights(sp: SeqParallel, size: int, dtype: torch.dtype, device):
    """The global align-corners x2 grid of this shard's ``2 size`` output
    frames in ``dtype``'s arithmetic, as JAX's ``_upsample2x_t_local``
    computes it: ``src = i (T-1) / (2T-1)``, ``w = src - floor(src)``
    (torch's ``upsample_trilinear3d`` multiplies ``i`` by the rounded
    scale instead: in float32 the two part by an ulp of ``src``, up to
    5e-7 at T 16); returns ``(lo, hi, w)``, the source frames as indices
    into the block with one halo frame a side, and the weight of ``hi``."""
    t = sp.size * size
    i = torch.arange(2 * size, device=device) + 2 * sp.index * size
    src = i.to(dtype) * (t - 1) / (2 * t - 1)
    lo = src.floor()
    w = src - lo
    lo = lo.long()
    hi = torch.clamp(lo + 1, max=t - 1)
    first = sp.index * size - 1               # the block's frame 0
    return lo - first, hi - first, w


def _t_matrix(sp: SeqParallel, size: int, dtype: torch.dtype, device):
    """Rows ``[2 k size, 2 (k+1) size)`` of the ``(2T, T)`` align-corners
    matrix over the halo'd block's columns (global frames ``k size - 1``
    to ``(k+1) size``; an edge's missing column weighs 0): the bfloat16
    path's, ``ops/resize.upsample_ncdhw``."""
    t = sp.size * size
    full = _linear_matrix(t, 2 * t, True)
    first = sp.index * size - 1
    sub = torch.zeros((2 * size, size + 2), dtype=torch.float32)
    rows = torch.from_numpy(full[2 * sp.index * size:
                                 2 * (sp.index + 1) * size])
    for c in range(size + 2):
        if 0 <= first + c < t:
            sub[:, c] = rows[:, first + c]
    return sub.to(device=device, dtype=dtype)


def upsample2x_t_sp(block: torch.Tensor, sp: SeqParallel,
                    dim: int = 2) -> torch.Tensor:
    """This shard's frames of the align-corners x2 upsample over T of the
    frame-sharded clip (JAX ``_upsample2x_t_local``): one halo frame a
    side, then the global grid.  float32 and float64 interpolate with
    ``F.interpolate``'s formula ``a (1 - w) + b w``; other dtypes by the
    rounded matrix of ``ops/resize.upsample_ncdhw``."""
    size = block.shape[dim]
    buf = halo_exchange(block, 1, sp, dim)
    if block.dtype in (torch.float32, torch.float64):
        lo, hi, w = _t_weights(sp, size, block.dtype, block.device)
        shape = [1] * block.dim()
        shape[dim] = 2 * size
        w = w.view(shape)
        return buf.index_select(dim, lo) * (1 - w) \
            + buf.index_select(dim, hi) * w
    m = _t_matrix(sp, size, block.dtype, block.device)
    return torch.matmul(buf.movedim(dim, -1), m.T).movedim(-1, dim)


def avg_pool2x_t_sp(block: torch.Tensor, sp: SeqParallel,
                    dim: int = 2) -> torch.Tensor:
    """This shard's frames of the /2 temporal average pool: local, the
    shard's count being even (JAX ``avg_pool2x_t_sp``)."""
    size = block.shape[dim]
    if size % 2:
        raise ValueError(f"a shard of {size} frames does not pool by 2 "
                         "alone (gather_frames first)")
    shape = list(block.shape)
    shape[dim:dim + 1] = [size // 2, 2]
    return block.reshape(shape).mean(dim + 1)


def temporal_conv_sp(block: torch.Tensor, weight: torch.Tensor,
                     sp: SeqParallel, bias: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """This shard's frames of the ``(kt, 1, 1)`` conv with SAME padding
    over T of an NCDHW clip, ``weight`` ``(Cout, Cin, kt, 1, 1)``: VALID
    over the block padded with ``kt // 2`` halo frames a side (JAX
    ``temporal_conv_sp``)."""
    padded = halo_exchange(block, weight.shape[2] // 2, sp, 2)
    return F.conv3d(padded, weight, bias)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, sp, dim):
        ctx.sp, ctx.dim, ctx.size = sp, dim, block.shape[dim]
        parts = []
        with sp.count("gather"):
            for j, src in enumerate(sp.ranks):
                part = _sent(block) if j == sp.index \
                    else _buffer(block.shape, block)
                dist.broadcast(part, src, group=sp.group)
                parts.append(part)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        sp = ctx.sp
        g = grad.contiguous().clone()
        with sp.count("gather_grad"):
            dist.all_reduce(g, group=sp.group)
        return g.narrow(ctx.dim, sp.index * ctx.size, ctx.size), None, None


def gather_frames(block: torch.Tensor, sp: SeqParallel,
                  dim: int = 2) -> torch.Tensor:
    """Every shard's frames, in order, on every sp peer of the row; its
    backward sums the peers' gradients and keeps this shard's frames (each
    peer's loss reads the whole)."""
    return _Gather.apply(block, sp, dim)


class _CarryIn(torch.autograd.Function):
    """Shard k (> 0) receives the state of shard k-1; its backward sends
    the state's gradient back.  ``anchor`` (the layer's input gates, which
    every step reads) passes through unchanged: it ties the node into the
    graph, and since its gradient is whole only once every step's backward
    has run, the gradient leaves for shard k-1 before anything upstream
    of the layer (a BatchNorm's all-reduce over the grid) runs."""

    @staticmethod
    def forward(ctx, anchor, sp, shape):
        ctx.sp = sp
        state = _buffer(shape, anchor)
        with sp.count("carry"):
            dist.broadcast(state, sp.ranks[sp.index - 1],
                           group=sp.prev_group)
        return anchor.view_as(anchor), state

    @staticmethod
    def backward(ctx, g_anchor, g_state):
        sp = ctx.sp
        with sp.count("carry_grad"):
            dist.broadcast(_sent(g_state), sp.ranks[sp.index],
                           group=sp.prev_group)
        return g_anchor, None, None


class _CarryOut(torch.autograd.Function):
    """Shard k (< size - 1) sends its last state to shard k+1 and returns
    it unchanged; its backward receives the gradient of what it sent and
    adds it to the state's own."""

    @staticmethod
    def forward(ctx, state, sp):
        ctx.sp = sp
        with sp.count("carry"):
            dist.broadcast(_sent(state), sp.ranks[sp.index],
                           group=sp.next_group)
        return state.view_as(state)

    @staticmethod
    def backward(ctx, grad):
        sp = ctx.sp
        got = _buffer(grad.shape, grad)
        with sp.count("carry_grad"):
            dist.broadcast(got, sp.ranks[sp.index + 1], group=sp.next_group)
        return grad + got, None


def carry_in(anchor: torch.Tensor, state: torch.Tensor,
             sp: SeqParallel) -> tuple[torch.Tensor, torch.Tensor]:
    """``(anchor, the state this shard's recurrence starts from)``: the
    state that shard k-1 carried out (``carry_out``), or ``state`` (its
    zeros) on shard 0 and under the ``"carry"`` control, where every
    shard starts as if alone.  Use the returned ``anchor`` (the tensor
    that every step reads) in place of the given one: its node sends the
    state's gradient back to shard k-1 in the backward."""
    if sp.index == 0 or "carry" in sp.local_ops:
        return anchor, state
    return _CarryIn.apply(anchor, sp, tuple(state.shape))


def carry_out(state: torch.Tensor, sp: SeqParallel) -> torch.Tensor:
    """``state`` (this shard's last) handed to shard k+1; returns it, to
    be used in its place: the node that receives its gradient from shard
    k+1 must stay on the path to the loss, or shard k+1 would wait in
    its send for ever."""
    if sp.index == sp.size - 1 or "carry" in sp.local_ops:
        return state
    return _CarryOut.apply(state, sp)
