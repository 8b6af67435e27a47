"""Int8 post-training-quantised serving forward of the MyGAN generator,
and the machinery the four served families share (port of
``vfd_gan_tpu.quant.qmygan``).

The scheme is the JAX package's:

* weights: symmetric per-output-channel int8 (absmax / 127) of the
  BN-folded kernels (``quant/fold.py``);
* activations: symmetric per-tensor int8 at every conv input, with
  scales calibrated offline (``calibrate``: absmax / 127 over the
  calibration batches);
* products: int8 with int32 sums (``ops/int8.py``: ``torch._int_mm`` on
  the card, one GEMM per kernel tap), dequantised as
  ``sums * (s_x * s_w[out])`` in float32, then the bias added.  Zero
  padding is exact (no zero point).  Quantising divides by a 0-dim
  float32 tensor on the activation's device (CUDA would turn division by
  a host scalar into a reciprocal multiply and move ``round(x / s)``
  across a .5).

Pools, upsamples, concats, the head conv and the sigmoid stay float.

A family's mirror is one function ``_forward(pack, x, conv)`` of its
model's eval forward (NCDHW in, the ``(B, 1, T, H, W)`` mask out) through
a ``Convs``: in float mode the BN-folded float convs, recording each conv
site's input absmax (what calibration observes), in int8 mode the
quantised convs.  One function for both, so the int8 forward cannot drift
from what calibration saw.  Site names are the JAX package's.

A pack is a dict of dicts of tensors: ``w`` the folded float weights
(torch layout), ``b`` biases and BN affines, ``f`` the float head, and
after ``quantize`` ``q`` the int8 weights, ``s`` their per-channel scales
and ``act`` the activation scales (0-dim float32).  A quantised pack
keeps no float conv weight.

``build_int8_serving`` is the CLIs' entry (``infer``/``serve --quant
int8``): the served model -> an ``Int8Model`` (an ``nn.Module`` holding
the pack as buffers).  Calibration batches come from ``--calib_plist``
(one leading clip of each video) or are ``--calib_clips`` uniform
[-1, 1) clips drawn from a ``torch.Generator`` seeded 7; the JAX package
draws them from ``jax.random.key(7)``, so the default scales differ
between the packages (the same batches give the same scales).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from vfd_gan_tpu_torch.ops.convs import avg_pool_ncdhw
from vfd_gan_tpu_torch.ops.int8 import conv3d_i8
from vfd_gan_tpu_torch.ops.resize import upsample_ncdhw
from vfd_gan_tpu_torch.quant.fold import fold_generator_bn, per_out

BLOCKS = ("dconv1", "dconv2", "dconv3", "dconv4", "dconv5",
          "uconv5", "uconv4", "uconv3", "uconv2", "uconv1")
_SP, _TP = (0, 1, 1), (1, 0, 0)


def _quant(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """round(x / scale) (half to even), clipped to +-127, as int8."""
    return (x / scale).round_().clamp_(-127, 127).to(torch.int8)


def _per_channel_scale(w: torch.Tensor) -> torch.Tensor:
    """absmax / 127 over all but the first (output-channel) axis of a
    torch-layout weight; 1 for an all-zero channel."""
    absmax = w.abs().amax(dim=tuple(range(1, w.dim())))
    return torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))


def quantize_weight(w: torch.Tensor):
    """``(int8 weight, per-channel scale)`` of a torch-layout weight."""
    s = _per_channel_scale(w)
    return _quant(w, per_out(s, w)), s


def conv_i8(x: torch.Tensor, s_x: torch.Tensor, w_q: torch.Tensor,
            s_w: torch.Tensor, bias: torch.Tensor | None = None,
            stride=(1, 1, 1), padding=(0, 0, 0)) -> torch.Tensor:
    """Int8 conv of an NCDHW video by a torch-layout int8 weight ``(Cout,
    Cin, kt, kh, kw)``: ``x`` quantised by ``s_x`` (from float32), int32
    sums, dequantised by ``s_x * s_w``, ``bias`` added; float32 NCDHW out
    (a channel-last tensor seen through a permutation)."""
    cout, cin = w_q.shape[:2]
    taps = w_q.permute(2, 3, 4, 0, 1).reshape(-1, cout, cin)
    xq = _quant(x.permute(0, 2, 3, 4, 1).float(), s_x).contiguous()
    y = conv3d_i8(xq, taps, tuple(w_q.shape[2:]), tuple(stride),
                  tuple(padding)).float() * (s_x * s_w)
    if bias is not None:
        y = y + bias
    return y.permute(0, 4, 1, 2, 3)


class Convs:
    """The conv sites of one pass of a family's mirror: float mode (the
    folded float weights ``pack["w"]``; records the absmax of each site's
    input, the largest over repeated calls) or int8 mode (``conv_i8``
    with ``pack["q"]``, ``pack["s"]`` and ``pack["act"]``)."""

    def __init__(self, pack: dict, quantized: bool = False):
        self.pack = pack
        self.quantized = quantized
        self.absmax: dict[str, torch.Tensor] = {}

    def __call__(self, site: str, y: torch.Tensor, bias=None, *,
                 stride=(1, 1, 1), padding=(0, 0, 0)) -> torch.Tensor:
        p = self.pack
        if self.quantized:
            return conv_i8(y, p["act"][site], p["q"][site], p["s"][site],
                           bias, stride, padding)
        m = y.abs().amax()
        prev = self.absmax.get(site)
        self.absmax[site] = m if prev is None else torch.maximum(prev, m)
        return F.conv3d(y, p["w"][site], bias, stride, padding)


def calibrate(forward_absmax, batches) -> dict[str, float]:
    """Per-site activation scales (absmax / 127, 1 where the absmax is 0)
    over calibration batches; ``forward_absmax(batch) -> {site: absmax}``."""
    agg: dict[str, float] = {}
    for xb in batches:
        for site, v in forward_absmax(xb).items():
            agg[site] = max(agg.get(site, 0.0), float(v))
    return {site: (v / 127.0 if v > 0 else 1.0) for site, v in agg.items()}


@torch.no_grad()
def quantize(forward, pack: dict, batches) -> dict:
    """A float pack -> the lean int8 pack of ``forward``'s family: the
    activation scales calibrated over ``batches`` (NCDHW), every site's
    weight quantised, the float weights dropped."""
    def forward_absmax(xb):
        convs = Convs(pack)
        forward(pack, xb, convs)
        return convs.absmax

    scales = calibrate(forward_absmax, batches)
    device = next(iter(pack["w"].values())).device
    qs = {site: quantize_weight(w) for site, w in pack["w"].items()}
    return {"b": pack["b"], "f": pack["f"],
            "q": {site: q for site, (q, _) in qs.items()},
            "s": {site: s for site, (_, s) in qs.items()},
            "act": {site: torch.tensor(v, dtype=torch.float32, device=device)
                    for site, v in scales.items()}}


def fold_generator(sd: dict) -> dict:
    """A ``Generator`` ``state_dict`` -> its float pack: the convs of
    ``fold_generator_bn`` (each block's mid BN folded into the spatial
    conv, its block BN into the temporal conv); the head stays float."""
    folded = fold_generator_bn(sd)
    pack = {"w": {}, "b": {}, "f": {"head": sd["conv_last.weight"]}}
    for name in BLOCKS:
        for site, conv in ((f"{name}:sp", "conv.spatial_conv"),
                           (f"{name}:tp", "conv.temporal_conv")):
            pack["w"][site] = folded[f"{name}.{conv}.weight"]
            pack["b"][site] = folded[f"{name}.{conv}.bias"]
    return pack


def _forward(pack: dict, x: torch.Tensor, conv: Convs) -> torch.Tensor:
    """The Generator's eval forward (models/mygan.py) through ``conv``."""
    b = pack["b"]

    def block(name, y):
        y = F.relu(conv(f"{name}:sp", y, b[f"{name}:sp"], padding=_SP))
        y = conv(f"{name}:tp", y, b[f"{name}:tp"], padding=_TP)
        return F.leaky_relu(y, 0.2)

    d1 = block("dconv1", x)
    d2 = block("dconv2", avg_pool_ncdhw(d1, 2))
    d3 = block("dconv3", avg_pool_ncdhw(d2, 2))
    d4 = block("dconv4", avg_pool_ncdhw(d3, 2))
    y = upsample_ncdhw(block("uconv5", block("dconv5",
                                             avg_pool_ncdhw(d4, 2))))
    y = upsample_ncdhw(block("uconv4", torch.cat([y, d4], 1)))
    y = upsample_ncdhw(block("uconv3", torch.cat([y, d3], 1)))
    y = upsample_ncdhw(block("uconv2", torch.cat([y, d2], 1)))
    y = block("uconv1", torch.cat([y, d1], 1))
    return torch.sigmoid(F.conv3d(y, pack["f"]["head"], padding=1).float())


def forward_folded(pack: dict, x: torch.Tensor) -> torch.Tensor:
    """The BN-folded float forward of a float pack (the mirror's float
    mode)."""
    return _forward(pack, x, Convs(pack))


def quantize_generator(sd: dict, batches) -> dict:
    """A ``Generator`` ``state_dict`` -> its int8 pack."""
    return quantize(_forward, fold_generator(sd), batches)


def generator_forward_int8(pack: dict, x: torch.Tensor) -> torch.Tensor:
    """The quantised forward: NCDHW video -> ``(B, 1, T, H, W)`` mask."""
    return _forward(pack, x, Convs(pack, quantized=True))


class Int8Model(nn.Module):
    """A family's int8 serving forward as a module: the pack's tensors are
    buffers (``group/site``), so the model moves with ``.to()`` and serves
    wherever a float model does."""

    def __init__(self, forward, pack: dict):
        super().__init__()
        self._forward = forward
        self._sites = {group: list(d) for group, d in pack.items()}
        for group, d in pack.items():
            for site, t in d.items():
                self.register_buffer(f"{group}/{site}", t)

    def pack(self) -> dict:
        return {group: {site: getattr(self, f"{group}/{site}")
                        for site in sites}
                for group, sites in self._sites.items()}

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """NCDHW video -> ``(B, 1, T, H, W)`` mask; ``generator`` is unused
        (eval mode), taken for the float models' common call."""
        return self._forward(self.pack(), x,
                             Convs(self.pack(), quantized=True))


def calibration_batches(isize: int, nfr: int, device, calib_plist: str = "",
                        calib_clips: int = 8) -> list[torch.Tensor]:
    """NCDHW ``(1, 3, nfr, isize, isize)`` calibration clips in [-1, 1]:
    the leading clip of each video in ``calib_plist``, decoded as
    ``/predict_video`` does, else ``calib_clips`` uniform draws from a
    ``torch.Generator`` seeded 7."""
    if calib_plist:
        from vfd_gan_tpu_torch.data.video_io import read_clip

        with open(calib_plist) as f:
            paths = [ln.strip() for ln in f if ln.strip()]
        clips = [torch.from_numpy(
            read_clip(p, 0, nfr, resize_to=(isize, isize)).astype(np.float32)
            / 255.0 * 2.0 - 1.0)[None] for p in paths]
    else:
        g = torch.Generator().manual_seed(7)
        clips = [torch.rand((1, nfr, isize, isize, 3), generator=g) * 2.0
                 - 1.0 for _ in range(calib_clips)]
    return [c.permute(0, 4, 1, 2, 3).contiguous().to(device) for c in clips]


def build_int8_serving(model: nn.Module, *, isize: int, nfr: int,
                       calib_plist: str = "",
                       calib_clips: int = 8) -> Int8Model:
    """A served float model (MyGAN ``Generator``, the c2plus1d
    ``AutoEncoder``, ``Xception3D`` or ``ConvLSTMModel``) -> its int8
    serving model on the same device, calibrated as the module docstring
    says.  Any other model exits, as the JAX CLI does; so does an
    ``--moe_experts`` Xception, whose MoE block the JAX package's int8
    Xception would silently drop."""
    from vfd_gan_tpu_torch.models.convlstm import ConvLSTMModel
    from vfd_gan_tpu_torch.models.mygan import Generator
    from vfd_gan_tpu_torch.models.stcnn import AutoEncoder
    from vfd_gan_tpu_torch.models.xception3d import Xception3D
    from vfd_gan_tpu_torch.quant import qclstm, qstcnn, qxception

    families = {Generator: (fold_generator, _forward),
                AutoEncoder: (qstcnn.fold_autoencoder, qstcnn._forward),
                Xception3D: (qxception.fold_xception, qxception._forward),
                ConvLSTMModel: (qclstm.fold_convlstm, qclstm._forward)}
    if type(model) not in families:
        raise SystemExit(
            "--quant int8 supports mygan-generator, c2plus1d (AutoEncoder), "
            f"xception and clstm checkpoints (got {type(model).__name__})")
    if getattr(model, "moe", None) is not None:
        raise SystemExit(
            "--quant int8: an --moe_experts Xception has no int8 form (the "
            "JAX package's int8 Xception ignores the MoE block; ROADMAP.md "
            "queue 3)")
    fold, forward = families[type(model)]
    sd = {k: v.detach().float() for k, v in model.state_dict().items()
          if v.is_floating_point()}
    device = next(iter(sd.values())).device
    pack = quantize(forward, fold(sd), calibration_batches(
        isize, nfr, device, calib_plist, calib_clips))
    return Int8Model(forward, pack).eval()
