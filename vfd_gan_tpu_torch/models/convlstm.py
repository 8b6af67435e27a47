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
input cast to it and the gate weight's halves cast once per forward; the
initial hidden and cell states are zeros of ``dtype``, so in bfloat16 the
cell state and every gate stay bfloat16 through the recurrence.  The
BatchNorms return ``dtype``; the head's sigmoid is float32.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from vfd_gan_tpu_torch.models.layers import (
    VideoBatchNorm,
    float32_or_wider,
    make_conv3d,
)
from vfd_gan_tpu_torch.ops.image import to_channel_first, to_channel_last
from vfd_gan_tpu_torch.ops.spatial_conv import conv3x3
from vfd_gan_tpu_torch.utils.init import torch_default_

HIDDEN = (16, 12, 12)


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
    -> every hidden state ``(B, T, H, W, hidden)``."""

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
        # cast to x's dtype once, as the JAX layer casts its kernel: the T
        # steps' gradients of the hidden half add up in that dtype
        weight = self.cell_list[0].conv.weight.permute(2, 3, 1, 0)
        kx = weight[:, :, :cin].to(x.dtype).contiguous()
        kh = weight[:, :, cin:].to(x.dtype).contiguous()
        xg = conv3x3(x.reshape(b * t, h, w, cin), kx).reshape(
            b, t, h, w, 4 * hid)
        hcur = x.new_zeros((b, h, w, hid))
        ccur = x.new_zeros((b, h, w, hid))
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
        return torch.stack(outs, dim=1)


class ConvLSTMModel(nn.Module):
    """The 3-layer stack with inter-layer BN and the sigmoid mask head;
    NCDHW ``(B, 3, T, H, W)`` -> ``(B, 1, T, H, W)``."""

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
        y = to_channel_last(x)
        for i in range(1, 4):
            y = getattr(self, f"clstm{i}")(y)
            # the BN sees an NCDHW view of the channel-last hidden states
            y = to_channel_last(getattr(self, f"bn{i}")(to_channel_first(y)))
        return torch.sigmoid(
            float32_or_wider(self.conv_last(to_channel_first(y))))
