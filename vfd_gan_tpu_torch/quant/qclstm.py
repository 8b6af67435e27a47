"""Int8 PTQ serving forward of the ConvLSTM mask predictor, clstm (port of
``vfd_gan_tpu.quant.qclstm``).

The per-timestep 4-gate conv over ``concat(x_t, h)``, where the FLOPs
are, runs int8 (the scheme of ``quant/qmygan.py``): per-output-channel
int8 weights and one calibrated activation scale per layer for the concat
plane, whose absmax is tracked over every timestep of the calibration
clips (so the recurrent hidden states are inside the range).  The
inter-layer BatchNorms cannot fold into the gate convs (only the x part
of the concat is normalised), so they stay explicit float32 affines.  The
12 -> 1 head conv stays float.

The mirror follows the reference's cell (gates ``i, f, o, g`` of one conv
over the concat, models/convlstm.py of the JAX package): the port's
model splits that conv into an input half and a hidden half, which is
the same function; the mirror keeps the concat, as the JAX mirror does,
since the concat is the int8 site.  Sites: ``l1``, ``l2``, ``l3``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vfd_gan_tpu_torch.quant.fold import bn_affine
from vfd_gan_tpu_torch.quant.qmygan import Convs, quantize

N_LAYERS = 3


def fold_convlstm(sd: dict) -> dict:
    """A ``ConvLSTMModel`` ``state_dict`` -> its float pack: each layer's
    gate weight as a ``(4h, cin + h, 1, k, k)`` conv3d weight, each BN as
    an affine."""
    pack = {"w": {}, "b": {}, "f": {"head": sd["conv_last.weight"]}}
    for i in range(1, N_LAYERS + 1):
        w = sd[f"clstm{i}.cell_list.0.conv.weight"]
        pack["w"][f"l{i}"] = w[:, :, None]
        pack["b"][f"l{i}:g"], pack["b"][f"l{i}:b"] = bn_affine(sd, f"bn{i}")
    return pack


def _forward(pack: dict, x: torch.Tensor, conv: Convs) -> torch.Tensor:
    """The ConvLSTM's eval forward through ``conv``."""
    for i in range(1, N_LAYERS + 1):
        site = f"l{i}"
        weight = pack["w" if not conv.quantized else "q"][site]
        hid, k = weight.shape[0] // 4, weight.shape[-1]
        b, _, t, h, w = x.shape
        hcur = x.new_zeros((b, hid, h, w), dtype=torch.float32)
        ccur = torch.zeros_like(hcur)
        hs = []
        for step in range(t):
            z = torch.cat([x[:, :, step].float(), hcur], 1)[:, :, None]
            gates = conv(site, z, padding=(0, k // 2, k // 2))[:, :, 0]
            ig, fg, og, gg = gates.split(hid, dim=1)
            ccur = torch.sigmoid(fg) * ccur + torch.sigmoid(ig) * torch.tanh(gg)
            hcur = torch.sigmoid(og) * torch.tanh(ccur)
            hs.append(hcur)
        g, c = pack["b"][f"{site}:g"], pack["b"][f"{site}:b"]
        x = torch.stack(hs, 2) * g.view(-1, 1, 1, 1) + c.view(-1, 1, 1, 1)
    return torch.sigmoid(F.conv3d(x, pack["f"]["head"], padding=1).float())


def convlstm_forward_float(pack: dict, x: torch.Tensor) -> torch.Tensor:
    """The float mirror of the model's eval forward."""
    return _forward(pack, x, Convs(pack))


def quantize_convlstm(sd: dict, batches) -> dict:
    return quantize(_forward, fold_convlstm(sd), batches)


def convlstm_forward_int8(pack: dict, x: torch.Tensor) -> torch.Tensor:
    return _forward(pack, x, Convs(pack, quantized=True))
