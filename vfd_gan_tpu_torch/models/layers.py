"""Building blocks of the port's models (port of ``vfd_gan_tpu.models.layers``).

NCDHW ``(B, C, T, H, W)`` input.  Submodule names are the reference's, so
``state_dict`` keys match the ``.pth`` files the reference and
``vfd_gan_tpu.utils.torch_export`` write:

* ``STConv``       <- models/spatiotempconv.py:7-65 (R(2+1)D factored conv):
  ``spatial_conv``, ``bn`` (the mid BN), ``temporal_conv``
* ``GenConvBlock`` <- models/mygannet.py:13-28: ``conv`` (STConv), ``bn``
* ``DiscConvBlock``<- models/mygannet.py:104-116 (NetdConv): the same
  submodules, any kernel, LeakyReLU at torch's default slope 0.01
* ``TorchLinear``: ``nn.Linear`` with the reference's init (the
  reference's ``weights_init`` skips Linear layers, so PyTorch's default
  U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias)
* ``VideoBatchNorm``, ``FrameBatchNorm``, ``BatchNorm1d``: torch's
  BatchNorms (3-D, 2-D, 1-D) with eps 1e-5 and momentum 0.1, whose running
  statistics the eval forward uses.
* ``Conv3d``, ``Conv2d``, ``ConvTranspose3d``, ``ConvTranspose2d``: torch's
  convolutions, casting their weight and bias to their input's dtype;
  ``QConv3d``, the int8 straight-through ``Conv3d`` of ``--int8_disc``.
* ``dropout``: flax ``nn.Dropout``'s function with masks drawn from a
  ``torch.Generator``.
* ``frame_shards``, ``upsample2x_sp``: the ``--sp`` nets' (MyGAN's,
  the AutoEncoder's, AnoGAN's, the ConvLSTM's) binding to their
  ``SeqParallel`` and x2 upsample of a rank's frames.

Under ``--tp`` (a ``parallel.mesh.TensorParallel`` bound as ``tp``:
``STConv``, the two conv blocks, ``TorchLinear``) a conv, and a Linear,
whose output channels split holds the rank's slice of its weight and bias
(``parallel/tensor.StateShards``), and so does the BatchNorm after it;
each such segment runs column-parallel (``parallel/tensor.column``):
``STConv`` gathers after its ``relu(bn(spatial))``, the blocks after
their outer BatchNorm and LeakyReLU, so every tensor between segments is
whole on every tp rank.

Compute dtype, as the JAX modules' ``dtype`` field sets it (bfloat16 is
the trainer's default): parameters and running statistics stay float32;
every conv and pool runs in its input's dtype (so a net's first conv, fed
float32 clips, runs in float32); a BatchNorm computes its statistics and
normalises in float32 and returns the model's ``dtype`` (so the net runs
in ``dtype`` from its first BatchNorm on); ``TorchLinear`` runs in
``dtype``.  Gradients reach the float32 parameters through the casts.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from vfd_gan_tpu_torch.ops.convs import r2plus1d_mid_channels
from vfd_gan_tpu_torch.ops.resize import _resize_axis
from vfd_gan_tpu_torch.parallel import tensor
from vfd_gan_tpu_torch.quant.qdisc import qconv3d
from vfd_gan_tpu_torch.utils.init import bn_scale_, dcgan_normal_, torch_default_


def float32_or_wider(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or as it is in float64: the cast of the float32
    heads and losses, which leaves a float64 run (the equivalence checks'
    precision, ``tools/dp_equivalence.py``) in float64."""
    return x if x.dtype == torch.float64 else x.float()


class _DtypeBatchNorm:
    """A torch BatchNorm (eps 1e-5, momentum 0.1, unbiased running
    variance: JAX ``TorchBatchNorm``'s semantics) with scale ~ N(1, 0.02):
    float32 statistics and normalisation (a bfloat16 input is read as
    float32 by torch's mixed-dtype BatchNorm), the result in ``dtype``
    (models/layers.py:143-144 of the JAX package).

    Bound to an active ``parallel.mesh.DataParallel`` (``dp``), a
    train-mode forward takes its statistics over the ranks' global batch
    in JAX's two-pass form (models/layers.py:113-134 of the JAX package):
    the sum and the element count summed over the ranks give the mean,
    then the summed ``(x - mean)^2`` the variance, the count the unbiased
    running variance.  Both sums are ``DataParallel.bn_sum``, whose
    backward sums the gradient over the ranks: without it each rank would
    differentiate its own loss alone."""

    dp = None

    def __init__(self, features: int, *, dtype: torch.dtype = torch.float32,
                 device=None, generator: torch.Generator | None = None):
        super().__init__(features, eps=1e-5, momentum=0.1, device=device)
        self.dtype = dtype
        if generator is not None:
            bn_scale_(self.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dp = self.dp
        if self.training and dp is not None and dp.active \
                and dp.bn_stats != "local":
            y = self._global_batch(x, dp)
        else:
            y = super().forward(x)
        if self.dtype != torch.float32:
            return y.to(self.dtype)
        return y

    def _global_batch(self, x: torch.Tensor, dp) -> torch.Tensor:
        xf = x if x.dtype in (torch.float32, torch.float64) else x.float()
        c = xf.shape[1]
        axes = [0, *range(2, xf.dim())]
        shape = (1, c) + (1,) * (xf.dim() - 2)
        sums = dp.bn_sum(torch.cat(
            [xf.sum(axes), xf.new_full((1,), xf.numel() // c)]))
        n = sums[c]
        d = xf - (sums[:c] / n).view(shape)
        var = dp.bn_sum((d * d).sum(axes)) / n
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(sums[:c] / n, alpha=m)
            self.running_var.mul_(1 - m).add_(var * (n / (n - 1)), alpha=m)
            self.num_batches_tracked.add_(1)
        return d * torch.rsqrt(var + self.eps).view(shape) \
            * self.weight.view(shape) + self.bias.view(shape)


class VideoBatchNorm(_DtypeBatchNorm, nn.BatchNorm3d):
    """BatchNorm over (B, T, H, W) per channel of an NCDHW video."""


class FrameBatchNorm(_DtypeBatchNorm, nn.BatchNorm2d):
    """BatchNorm over (N, H, W) per channel of NCHW frames (GANomaly's
    ``VideoBatchNorm`` on ``(N, H, W, C)`` frames in JAX)."""


class BatchNorm1d(_DtypeBatchNorm, nn.BatchNorm1d):
    """BatchNorm over the batch per feature of ``(B, F)`` (AnoGAN's
    ``fc_bn``, a ``TorchBatchNorm`` in JAX)."""


class _InputDtypeConv:
    """A torch convolution in its input's dtype: the float32 weight and
    bias are cast to it, as the JAX convolutions cast their kernels
    (``ops/convs.py``); their gradients come back float32.

    Below float32 the sums are rounded to the input's dtype, as an XLA
    convolution in that dtype stores them.  A bias-free conv returns them
    so.  A bias is added to them in float32 and the result stays float32,
    as XLA adds ``y + bias.astype(y.dtype)`` inside the fusion that reads
    it and rounds only what that fusion stores; each reader of a biased
    conv rounds or widens as JAX does (a BatchNorm computes in float32 and
    returns its dtype, a head is float32, the AutoEncoder's residual is
    cast to its block input's dtype, a conv reads it in its own dtype).
    Measured against JAX in bfloat16 (tests/test_torch_port_bf16_nets.py):
    rounding the biased sum puts MyGAN's Generator twice as far from JAX's
    as JAX's own bfloat16 noise, eval and train; leaving bias-free sums
    unrounded does not bring the AutoEncoder's train forward within 2^-7
    of JAX's and takes Xception's out of it.  A subclass gives the torch
    function as ``_conv(x, weight, bias)``.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._in_dtype(x, self._conv)

    def _in_dtype(self, x: torch.Tensor, conv) -> torch.Tensor:
        """``conv(x, weight, bias)`` in ``x``'s dtype, as above."""
        if x.dtype in (torch.float32, torch.float64):
            return conv(x, self.weight, self.bias)
        w = self.weight.to(x.dtype)
        if x.device.type == "cpu":
            # the same function from float32 kernels: products of the
            # rounded operands and float32 sums, rounded once.  oneDNN's
            # bfloat16 conv3d returned NaN weight gradients now and then
            # on one x86 host, where 3 taps outreach a 2-frame time axis
            y = conv(x.float(), w.float(), None).to(x.dtype)
        else:
            y = conv(x, w, None)
        if self.bias is None:
            return y
        return y.float() + self.bias.to(x.dtype).float().view(
            -1, *(1,) * (y.dim() - 2))


class Conv3d(_InputDtypeConv, nn.Conv3d):
    """``nn.Conv3d`` in its input's dtype (``_InputDtypeConv``)."""

    def _conv(self, x, weight, bias):
        return self._conv_forward(x, weight, bias)

    def valid_t(self, x: torch.Tensor) -> torch.Tensor:
        """The conv with no padding over T (its own over H and W): a
        frame-sharded block that holds its halo frames (``--sp``)."""
        pad = (0, *self.padding[1:])
        return self._in_dtype(x, lambda x, w, b: F.conv3d(
            x, w, b, self.stride, pad, self.dilation, self.groups))


class Conv2d(_InputDtypeConv, nn.Conv2d):
    """``nn.Conv2d`` in its input's dtype (``_InputDtypeConv``)."""

    def _conv(self, x, weight, bias):
        return self._conv_forward(x, weight, bias)


class ConvTranspose3d(_InputDtypeConv, nn.ConvTranspose3d):
    """``nn.ConvTranspose3d`` in its input's dtype (``_InputDtypeConv``)."""

    def _conv(self, x, weight, bias):
        return F.conv_transpose3d(x, weight, bias, self.stride, self.padding,
                                  self.output_padding)

    def valid_t(self, x: torch.Tensor, left: int, frames: int
                ) -> torch.Tensor:
        """This shard's ``stride * frames`` output frames of the
        transposed conv of a frame-sharded block (``--sp``): ``x`` holds
        the shard's ``frames`` frames after ``left`` halo frames, and
        behind them the halo frames that its outputs read (output frame o
        reads input frames (o + padding - k) / stride, k < 3).  The conv
        runs with no padding and no output padding over T (its own over H
        and W), and the shard's frames are cut from its output."""
        s, p = self.stride[0], self.padding[0]
        pad, out_pad = (0, *self.padding[1:]), (0, *self.output_padding[1:])
        y = self._in_dtype(x, lambda x, w, b: F.conv_transpose3d(
            x, w, b, self.stride, pad, out_pad))
        return y.narrow(2, p + s * left, s * frames)


class ConvTranspose2d(_InputDtypeConv, nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` in its input's dtype (``_InputDtypeConv``)."""

    def _conv(self, x, weight, bias):
        return F.conv_transpose2d(x, weight, bias, self.stride, self.padding,
                                  self.output_padding)


class QConv3d(Conv3d):
    """``Conv3d`` with the int8 forward and the float conv's backward of
    ``quant/qdisc.py`` (``--int8_disc``): the weight cast to the input's
    dtype as ``Conv3d`` casts it, then the bias added as ``Conv3d`` adds
    it.  Bound to a ``parallel.mesh.DataParallel`` (``dp``), the
    activation scale is the global batch's (under ``--sp`` the MAX over
    the whole grid, in a replicated segment too, where the sp peers hold
    the same frames)."""

    dp = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._q(x, self.padding)

    def valid_t(self, x: torch.Tensor) -> torch.Tensor:
        """The int8 conv with no padding over T: a frame-sharded block that
        holds its halo frames (``--sp``), quantised by the global tensor's
        scale (the halos are frames of it, the edges' zeros move no
        absmax)."""
        return self._q(x, (0, *self.padding[1:]))

    def _q(self, x: torch.Tensor, padding) -> torch.Tensor:
        y = qconv3d(x, self.weight.to(x.dtype), self.stride, padding,
                    self.dp)
        if self.bias is None:
            return y
        shape = (-1, *(1,) * (y.dim() - 2))
        if x.dtype in (torch.float32, torch.float64):
            return y + self.bias.view(shape)
        return y.float() + self.bias.to(x.dtype).float().view(shape)


def make_conv3d(cin: int, cout: int, kernel, padding=(0, 0, 0), *,
                stride=(1, 1, 1), bias: bool = True, quant: bool = False,
                device=None,
                generator: torch.Generator | None = None) -> Conv3d:
    """``Conv3d`` (``QConv3d`` with ``quant``) with the reference init
    drawn from ``generator``: kernel ~ N(0, 0.02), bias PyTorch's default
    over the kernel's fan-in."""
    conv = (QConv3d if quant else Conv3d)(
        cin, cout, tuple(kernel), stride=tuple(stride),
        padding=tuple(padding), bias=bias, device=device)
    if generator is not None:
        dcgan_normal_(conv.weight, generator)
        if bias:
            fan_in = cin * kernel[0] * kernel[1] * kernel[2]
            torch_default_(conv.bias, fan_in, generator)
    return conv


class STConv(nn.Module):
    """Factored (2+1)D convolution, stride 1 with biases: spatial (1,kh,kw)
    conv -> BN -> ReLU -> temporal (kt,1,1) conv, intermediate width from
    the R(2+1)D formula.  ``quant`` (the discriminator's under
    ``--int8_disc``) makes both convs ``QConv3d``, the spatial one only
    with symmetric spatial padding, as the JAX STConv does.

    Bound to a ``parallel.mesh.SeqParallel`` (``sp``, ``--sp``) in a
    sharded segment, the input is this rank's frames: the spatial conv is
    frame-local, and the temporal conv runs VALID over T on the block
    padded with ``pt`` halo frames a side (``sp.halo``).  Bound to a
    ``parallel.mesh.TensorParallel`` (``tp``, ``--tp``), each of the two
    convs whose output channels split runs on the rank's slice: the
    spatial one with its BatchNorm and ReLU, gathered before the temporal
    conv; the temporal one gathered by ``forward``, or left to the block
    around it (``sliced``)."""

    sp = None
    tp = None

    def __init__(self, cin: int, cout: int,
                 kernel_size: Sequence[int] = (3, 3, 3),
                 padding: Sequence[int] = (0, 0, 0), *,
                 dtype: torch.dtype = torch.float32, quant: bool = False,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        kt, kh, kw = kernel_size
        pt, ph, pw = padding
        mid = r2plus1d_mid_channels(kt, kh, kw, cin, cout)
        kw_ = {"device": device, "generator": generator}
        self.spatial_conv = make_conv3d(cin, mid, (1, kh, kw), (0, ph, pw),
                                        quant=quant and ph == pw, **kw_)
        self.bn = VideoBatchNorm(mid, dtype=dtype, **kw_)
        self.temporal_conv = make_conv3d(mid, cout, (kt, 1, 1), (pt, 0, 0),
                                         quant=quant, **kw_)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.sliced(x)
        if tensor.split(self.tp, self.temporal_conv.out_channels):
            return tensor.gather(y, self.tp)
        return y

    def sliced(self, x: torch.Tensor) -> torch.Tensor:
        """The temporal conv's output, under ``--tp`` the rank's channel
        slice where its output channels split (else whole)."""
        y = tensor.column(self.tp, self.spatial_conv.out_channels, x,
                          lambda x: F.relu(self.bn(self.spatial_conv(x))))
        if tensor.split(self.tp, self.temporal_conv.out_channels):
            y = tensor.copy_in(y, self.tp)
        pt = self.temporal_conv.padding[0]
        if self.sp is None or not self.sp.sharded or not pt:
            return self.temporal_conv(y)
        return self.temporal_conv.valid_t(self.sp.halo(y, pt))


def _block(block: nn.Module, x: torch.Tensor, slope: float) -> torch.Tensor:
    """A conv block's ``leaky_relu(bn(conv(x)), slope)``; under ``--tp``
    on the rank's channel slice where the temporal conv's outputs split,
    gathered after the activation."""
    y = F.leaky_relu(block.bn(block.conv.sliced(x)), negative_slope=slope)
    if tensor.split(block.tp, block.bn.num_features):
        return tensor.gather(y, block.tp)
    return y


class GenConvBlock(nn.Module):
    """STConv -> BN -> LeakyReLU(0.2): the generator's conv block
    (models/mygannet.py:13-28, 3x3x3 with SAME padding)."""

    tp = None

    def __init__(self, cin: int, cout: int, *,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = {"dtype": dtype, "device": device, "generator": generator}
        self.conv = STConv(cin, cout, (3, 3, 3), padding=(1, 1, 1), **kw)
        self.bn = VideoBatchNorm(cout, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _block(self, x, 0.2)


class DiscConvBlock(nn.Module):
    """STConv -> BN -> LeakyReLU(0.01): the discriminator's conv block
    (models/mygannet.py:104-116; note the default slope, not 0.2)."""

    tp = None

    def __init__(self, cin: int, cout: int, kernel_size: Sequence[int],
                 padding: Sequence[int], *,
                 dtype: torch.dtype = torch.float32, quant: bool = False,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        kw = {"dtype": dtype, "device": device, "generator": generator}
        self.conv = STConv(cin, cout, kernel_size, padding=padding,
                           quant=quant, **kw)
        self.bn = VideoBatchNorm(cout, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _block(self, x, 0.01)


def dropout(y: torch.Tensor, rate: float, training: bool,
            generator: torch.Generator | None = None,
            dp=None, frame_dim: int | None = None) -> torch.Tensor:
    """flax ``nn.Dropout``'s function: keep with probability 1 - rate and
    scale kept values by 1 / (1 - rate), the mask drawn from ``generator``
    on its device (so a CPU generator gives a card step the CPU's masks);
    inert out of training mode or at rate 0.  Under an active ``dp``
    (``parallel.mesh.DataParallel``) the global batch's mask is drawn and
    this rank's rows kept (and under ``--sp``, ``y``'s axis ``frame_dim``
    holding this rank's frames, its frames)."""
    if not training or rate == 0.0:
        return y
    if dp is not None:
        keep = dp.rand(y.shape, generator, y.device, frame_dim) >= rate
    else:
        draw = y.device if generator is None else generator.device
        keep = torch.rand(y.shape, generator=generator,
                          device=draw).to(y.device) >= rate
    return torch.where(keep, y / (1.0 - rate),
                       torch.zeros((), dtype=y.dtype, device=y.device))


def frame_shards(module: nn.Module):
    """The ``SeqParallel`` that ``module`` shards its frames over
    (``--sp``), or None: unbound, or its ``on`` off."""
    sp = module.sp
    return sp if sp is not None and sp.on else None


def upsample2x_sp(x: torch.Tensor, sp) -> torch.Tensor:
    """x2 over (T, H, W) of this shard's NCDHW frames: T on the global
    grid (``sp.upsample2x_t``), H and W local, as ``ops/resize.
    upsample_ncdhw`` computes them in ``x``'s dtype."""
    y = sp.upsample2x_t(x)
    t, h, w = y.shape[2:]
    if y.dtype in (torch.float32, torch.float64):
        # T kept (its weights are exactly 1 and 0)
        return F.interpolate(y, size=(t, 2 * h, 2 * w), mode="trilinear",
                             align_corners=True)
    return _resize_axis(_resize_axis(y, 3, 2 * h, True), 4, 2 * w, True)


class TorchLinear(nn.Linear):
    """``nn.Linear`` with PyTorch's default init drawn from ``generator``,
    run in ``dtype``: input, weight and bias cast to it, as flax ``Dense``
    with ``dtype`` and float32 parameters does.  Under ``--tp`` (``tp``)
    column-parallel where its output features split."""

    tp = None

    def __init__(self, fan_in: int, features: int, *,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__(fan_in, features, device=device)
        self.dtype = dtype
        if generator is not None:
            torch_default_(self.weight, fan_in, generator)
            torch_default_(self.bias, fan_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return tensor.column(self.tp, self.out_features, x, self._linear)

    def _linear(self, x: torch.Tensor) -> torch.Tensor:
        d = self.dtype
        if d == torch.float32:
            return super().forward(x)
        # the rounded product, then the bias, as flax adds it
        return F.linear(x.to(d), self.weight.to(d)) + self.bias.to(d)
