"""ConvLSTM mask predictor (port of ``vfd_gan_tpu.models.convlstm``).

Reference models/convlstm.py:6-218: three single-layer ConvLSTMs (3 -> 16
-> 12 -> 12 hidden channels), a BatchNorm after each, a 3x3x3 head conv
without bias and a float32 sigmoid.  Gate math (convlstm.py:42-58):
``conv(concat(x, h))`` split into ``(i, f, o, g)`` in that channel order;
``c' = sigmoid(f) c + sigmoid(i) tanh(g)``, ``h' = sigmoid(o) tanh(c')``.

As in the JAX model, ``conv(concat(x, h), K) = conv(x, Kx) + conv(h, Kh)``:
the gate weight is split along its input channels, the input half runs
as one ``(B*T)``-batched 3x3 conv before the recurrence and only the hidden
half runs inside it, T sequential convs per layer.  Both run on
:func:`vfd_gan_tpu_torch.ops.spatial_conv.conv3x3` (the hand-written CUDA
kernel on the card, forward and dx), channel-last; the video is permuted
to NCDHW only at the BatchNorms and the head.

Each layer keeps the reference's one gate weight,
``clstm{i}.cell_list.0.conv.weight`` in ``nn.Conv2d`` layout ``(4h,
cin + h, 3, 3)`` (bias-free, PyTorch's default init: the reference's
``weights_init`` skips Conv2d), and slices it in ``forward``.

``dtype`` (JAX models/convlstm.py:54-89): the gate convs run in it, the
input cast to it and the gate weight's halves cast to it for each conv's
products; the initial hidden and cell states are zeros of ``dtype``, so
in bfloat16 the cell state and every gate stay bfloat16 through the
recurrence.  The BatchNorms return ``dtype``; the head's sigmoid is
float32.  The weights' gradients are float32 sums, rounded to bfloat16
nowhere: the gate weight's come back from each conv in float32 and add
up in float32 over the T steps, and the head's is one float32 matmul of
its widened operands (``head_weight_grad``).  So under ``--sp`` the
shards' partial sums add up to the unsharded sum to float32 round-off.
This departs from JAX's bfloat16 gradient sums on every path: the JAX
layer casts its kernels to bfloat16 and sums their gradients there.  A
sum of bfloat16 partial sums parts from the whole sum's rounding by
~0.2%, and a sharded bfloat16 step read 0.24% from the unsharded one on
an H100, where two unsharded runs lie 0.007% apart (``PERF.md``).

Under ``--sp`` (``parallel.mesh.SeqParallel`` bound as ``sp``) the clip
is this rank's frames.  The input half of each layer's gates is
frame-local; the recurrence is chained along the row: a shard starts
from the ``(h, c)`` that the shard before carried out of its last frame
(``sp.carry_in``; zeros on shard 0), runs its frames and hands its last
``(h, c)`` on (``sp.carry_out``), and the state's gradient passes back
along the chain in the backward.  So each rank launches one input-half
conv and T/sp hidden-half convs a layer.  The BatchNorms take their
statistics over the grid; the 3x3x3 head takes one halo frame a side.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from vfd_gan_tpu_torch.models.layers import (
    VideoBatchNorm,
    float32_or_wider,
    frame_shards,
    make_conv3d,
)
from vfd_gan_tpu_torch.ops.image import to_channel_first, to_channel_last
from vfd_gan_tpu_torch.ops.spatial_conv import conv3x3
from vfd_gan_tpu_torch.utils.init import torch_default_

HIDDEN = (16, 12, 12)


def head_weight_grad(x: torch.Tensor, dy: torch.Tensor,
                     padding) -> torch.Tensor:
    """``dw (1, C, 3, 3, 3)`` of ``conv3d(x, w, padding=padding)``, one
    output channel, from ``x (B, C, T, H, W)`` and ``dy (B, 1, T', H',
    W')``: float32 sums of the widened operands.  With one output channel
    it is one batched matmul, a row of the padded input (channel-last)
    against the same row of the 27 windows of ``dy`` padded by 2, each a
    tap in reverse.  cuDNN's float32 wgrad at the head's shape took 29.9 ms
    of a 94 ms b8 step on an H100, this 0.2 ms (``PERF.md``)."""
    pt, ph, pw = padding
    xp = F.pad(x.permute(0, 2, 3, 4, 1).float(),
               (0, 0, pw, pw, ph, ph, pt, pt))
    b, tp, hp, wp, c = xp.shape
    # windows[b, i, j, k, t, h, w] = dy[b, t + i - 2, h + j - 2, w + k - 2]
    windows = F.pad(dy[:, 0].float(), (2, 2, 2, 2, 2, 2)).unfold(
        1, tp, 1).unfold(2, hp, 1).unfold(3, wp, 1)
    rows = windows.permute(0, 4, 5, 6, 1, 2, 3).reshape(-1, wp, 27)
    dw = torch.bmm(xp.reshape(-1, wp, c).transpose(1, 2), rows).sum(0)
    return dw.reshape(1, c, 3, 3, 3).flip(2, 3, 4)


class _Float32WeightGrad(torch.autograd.Function):
    """``conv3d(x, weight)`` with ``padding`` in ``x``'s bfloat16, as the
    bias-free ``Conv3d`` computes it (``models/layers.py``), and the
    input's gradient as autograd takes it there; the weight's gradient is
    :func:`head_weight_grad`, a float32 sum not rounded to bfloat16 (the
    head's, below)."""

    @staticmethod
    def forward(ctx, x, weight, padding):
        w = weight.to(x.dtype)
        ctx.save_for_backward(x, w)
        ctx.padding = padding
        if x.device.type == "cpu":
            # Conv3d's CPU form: float32 sums of the rounded operands
            return F.conv3d(x.float(), w.float(), None, 1, padding).to(
                x.dtype)
        return F.conv3d(x, w, None, 1, padding)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            ops = (dy, x, w) if x.device.type != "cpu" else (
                dy.float(), x.float(), w.float())
            dx = torch.ops.aten.convolution_backward(
                *ops, None, (1, 1, 1), ctx.padding, (1, 1, 1), False,
                (0, 0, 0), 1, (True, False, False))[0].to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = head_weight_grad(x, dy, ctx.padding)
        return dx, dw, None


class ConvLSTMCell(nn.Module):
    """Holds the gate weight under the reference's name ``conv``."""

    def __init__(self, cin: int, hidden: int, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv = nn.Conv2d(cin + hidden, 4 * hidden, 3, padding=1,
                              bias=False, device=device)
        if generator is not None:
            torch_default_(self.conv.weight, (cin + hidden) * 9, generator)


class ConvLSTMLayer(nn.Module):
    """One ConvLSTM layer over a clip: channel-last ``(B, T, H, W, Cin)``
    -> every hidden state ``(B, T, H, W, hidden)``; under ``--sp`` over
    this rank's frames, the recurrence chained along the row."""

    # a parallel.mesh.SeqParallel (--sp): x is this rank's frames
    sp = None

    def __init__(self, cin: int, hidden: int, *,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.hidden = hidden
        self.dtype = dtype
        self.cell_list = nn.ModuleList([ConvLSTMCell(
            cin, hidden, device=device, generator=generator)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h, w, cin = x.shape
        hid = self.hidden
        if self.dtype != torch.float32:
            x = x.to(self.dtype)
        # (4h, cin + h, 3, 3) -> the (3, 3, I, 4h) halves of the JAX kernel,
        # kept in the weight's dtype: conv3x3 casts them to x's for its
        # products and returns their gradients in the weight's, so the T
        # steps' gradients of the hidden half add up unrounded
        weight = self.cell_list[0].conv.weight.permute(2, 3, 1, 0)
        kx = weight[:, :, :cin].contiguous()
        kh = weight[:, :, cin:].contiguous()
        xg = conv3x3(x.reshape(b * t, h, w, cin), kx).reshape(
            b, t, h, w, 4 * hid)
        sp = frame_shards(self)
        if sp is None:
            hcur = x.new_zeros((b, h, w, hid))
            ccur = x.new_zeros((b, h, w, hid))
        else:
            # (h, c) from the shard before, stacked for one hand-off
            xg, state = sp.carry_in(xg, x.new_zeros((2, b, h, w, hid)))
            hcur, ccur = state.unbind(0)
        outs = []
        # unbind, not xg[:, step]: the backward of one unbind stacks the T
        # gradients once, where T indexings would each fill and add a
        # gradient of xg's full size
        for xg_t in xg.unbind(1):
            gates = xg_t + conv3x3(hcur, kh)
            i, f, o, g = gates.split(hid, dim=-1)
            ccur = torch.sigmoid(f) * ccur + torch.sigmoid(i) * torch.tanh(g)
            hcur = torch.sigmoid(o) * torch.tanh(ccur)
            outs.append(hcur)
        if sp is not None:
            # the last h handed on is the one the layer returns: its node
            # then stays on the path to the loss
            outs[-1] = sp.carry_out(torch.stack([hcur, ccur]))[0]
        return torch.stack(outs, dim=1)


class ConvLSTMModel(nn.Module):
    """The 3-layer stack with inter-layer BN and the sigmoid mask head;
    NCDHW ``(B, 3, T, H, W)`` -> ``(B, 1, T, H, W)``."""

    # a parallel.mesh.SeqParallel (--sp): x is this rank's frames
    sp = None

    def __init__(self, *, dtype: torch.dtype = torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = {"dtype": dtype, "device": device, "generator": generator}
        widths = (3,) + HIDDEN
        for i, hid in enumerate(HIDDEN):
            setattr(self, f"clstm{i + 1}",
                    ConvLSTMLayer(widths[i], hid, **kw))
            setattr(self, f"bn{i + 1}", VideoBatchNorm(hid, **kw))
        self.conv_last = make_conv3d(HIDDEN[-1], 1, (3, 3, 3), (1, 1, 1),
                                     bias=False, device=device,
                                     generator=generator)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """Mask video ``(B, 1, T, H, W)``; ``generator`` is unused (the
        model has no dropout) and taken for the engines' common call."""
        sp = frame_shards(self)
        y = to_channel_last(x)
        for i in range(1, 4):
            y = getattr(self, f"clstm{i}")(y)
            # the BN sees an NCDHW view of the channel-last hidden states
            # (under --sp the rank's frames: statistics over the grid)
            y = to_channel_last(getattr(self, f"bn{i}")(to_channel_first(y)))
        y = to_channel_first(y)
        head = self.conv_last
        pad = head.padding
        if sp is not None:
            # the 3x3x3 head: one halo frame a side, SAME over H and W
            y, pad = sp.halo(y, 1), (0, *pad[1:])
        if y.dtype == head.weight.dtype or not torch.is_grad_enabled():
            y = head(y) if sp is None else head.valid_t(y)
        else:
            y = _Float32WeightGrad.apply(y, head.weight, pad)
        return torch.sigmoid(float32_or_wider(y))
