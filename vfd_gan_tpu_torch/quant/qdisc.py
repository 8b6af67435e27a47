"""Int8 straight-through convolutions for the discriminator's training
forwards, ``--int8_disc`` (port of ``vfd_gan_tpu.quant.qdisc``).

* forward: symmetric int8, the activation per tensor with a dynamic
  absmax scale (computed in the step, no calibration; float32, so a
  bfloat16 input is quantised from float32 as ``jnp`` promotes it), the
  weight per output channel in its own dtype; int32 sums
  (``ops/int8.py``), dequantised in float32 and returned in the input's
  dtype;
* backward: straight-through, the float conv's VJP at the unquantised
  operands (``aten.convolution_backward``, what autograd runs for
  ``F.conv3d``; on the CPU below float32 from float32 copies, as
  ``models/layers.Conv3d`` computes there), so D's gradients are exactly
  the float conv's where the forward would have been without
  quantisation.

Under ``--dp`` (an active ``parallel.mesh.DataParallel``) the
activation's absmax is the global tensor's: one all-reduced MAX before
the quantiser, outside autograd (the backward is the float conv's).  The
per-channel weight scales are equal on every rank already.

In the MyGAN step G's loss has no D term (the adversarial value is
detached telemetry), so quantising D changes only D's trajectory and the
loss telemetry, never G's update or the scored masks.
"""

from __future__ import annotations

import torch

from vfd_gan_tpu_torch.quant.qmygan import conv_i8, quantize_weight


def _dyn_scale(x: torch.Tensor, dp=None) -> torch.Tensor:
    """Per-tensor absmax / 127 in float32 (1 for an all-zero tensor); the
    absmax over the ranks under an active ``dp``."""
    absmax = x.detach().float().abs().amax()
    if dp is not None and dp.synced("absmax"):
        absmax = dp.all_reduce_max_(absmax.reshape(1))[0]
    return torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))


def _float_conv_grads(x, w, g, stride, padding):
    cpu_low = x.device.type == "cpu" and x.dtype not in (torch.float32,
                                                         torch.float64)
    if cpu_low:
        x, w, g = x.float(), w.float(), g.float()
    dx, dw, _ = torch.ops.aten.convolution_backward(
        g, x, w, None, list(stride), list(padding), [1, 1, 1], False,
        [0, 0, 0], 1, [True, True, False])
    return dx, dw


class _QConv3d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, padding, dp):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding = stride, padding
        w_q, s_w = quantize_weight(w)
        return conv_i8(x, _dyn_scale(x, dp), w_q, s_w, stride=stride,
                       padding=padding).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = _float_conv_grads(x, w, g.to(x.dtype), ctx.stride,
                                   ctx.padding)
        return dx.to(x.dtype), dw.to(w.dtype), None, None, None


def qconv3d(x: torch.Tensor, weight: torch.Tensor, stride=(1, 1, 1),
            padding=(0, 0, 0), dp=None) -> torch.Tensor:
    """Int8 forward / float-STE backward of ``F.conv3d(x, weight, None,
    stride, padding)`` (NCDHW, symmetric padding); ``dp``: the group whose
    global tensor sets the activation scale."""
    return _QConv3d.apply(x, weight, tuple(stride), tuple(padding), dp)


def qspatial_conv(x: torch.Tensor, weight: torch.Tensor, stride: int,
                  pad: int) -> torch.Tensor:
    """The spatial ``(Cout, Cin, 1, kh, kw)`` conv with symmetric ``pad``
    (JAX ``qspatial_conv``)."""
    return qconv3d(x, weight, (1, stride, stride), (0, pad, pad))


def qtemporal_conv(x: torch.Tensor, weight: torch.Tensor,
                   pad: int) -> torch.Tensor:
    """The stride-1 temporal ``(Cout, Cin, kt, 1, 1)`` conv (JAX
    ``qtemporal_conv``)."""
    return qconv3d(x, weight, (1, 1, 1), (pad, 0, 0))
