"""Int8 PTQ serving forward of Xception-3D (port of
``vfd_gan_tpu.quant.qxception``).

The scheme of ``quant/qmygan.py``.  Inside an ``XceptionBlock`` and after
the two head SepaConvs a BN follows a ReLU, so it cannot fold into a conv:
those BNs stay their exact inference affine ``y * g + b``.  BNs that
follow a conv directly (the two stem convs, every skip's ``skipbn``, the
four decoder convs) fold into its weight.  Every conv but the 1-channel
head (with bias) is an int8 site; the head and the sigmoid stay float.
The mirror follows ``Xception3D.forward`` (models/xception3d.py) in eval
mode; sites keep the JAX names (``stem1``, ``entry1:sepa1:sp``,
``middle3:sepa2:pt``, ``exit:skip``, ``head1:sp``, ``deconv2``, ...).  An
``--moe_experts`` model has no int8 form (``build_int8_serving`` exits).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vfd_gan_tpu_torch.ops.resize import upsample_ncdhw
from vfd_gan_tpu_torch.quant.fold import bn_affine, per_out
from vfd_gan_tpu_torch.quant.qmygan import Convs, quantize

# (JAX name, port module, reps, stride, start_with_relu, has_skip, the
# SepaConv and BN indices in its ``rep``)
BLOCKS = ([(f"entry{i}", f"block{i}", 2, 2, False, True, (0, 3), (1, 4))
           for i in (1, 2, 3)]
          + [(f"middle{i}", f"block{i + 3}", 3, 1, True, False, (1, 4, 7),
              (2, 5, 8)) for i in range(1, 9)]
          + [("exit", "block12", 2, 1, True, True, (1, 4), (2, 5))])
_SP = (0, 1, 1)


def fold_xception(sd: dict) -> dict:
    """An ``Xception3D`` ``state_dict`` -> its float pack: folded convs in
    ``w``/``b``, post-ReLU BN affines as ``b["<site>:g"]``/``b["<site>:b"]``,
    SepaConv weights as they are (bias-free)."""
    pack = {"w": {}, "b": {},
            "f": {"head": sd["conv_last.weight"],
                  "head_b": sd["conv_last.bias"]}}

    def fold(site, conv, bn):
        g, b = bn_affine(sd, bn)
        w = sd[f"{conv}.weight"]
        pack["w"][site] = w * per_out(g, w)
        pack["b"][site] = b

    def affine(site, bn):
        pack["b"][f"{site}:g"], pack["b"][f"{site}:b"] = bn_affine(sd, bn)

    def sepa(site, mod):
        pack["w"][f"{site}:sp"] = sd[f"{mod}.conv1.weight"]
        pack["w"][f"{site}:pt"] = sd[f"{mod}.pointwise.weight"]

    fold("stem1", "conv1", "bn1")
    fold("stem2", "conv2", "bn2")
    for name, mod, _, _, _, has_skip, sepas, bns in BLOCKS:
        for i, (si, bi) in enumerate(zip(sepas, bns), start=1):
            sepa(f"{name}:sepa{i}", f"{mod}.rep.{si}")
            affine(f"{name}:aff{i}", f"{mod}.rep.{bi}")
        if has_skip:
            fold(f"{name}:skip", f"{mod}.skip", f"{mod}.skipbn")
    for h, mod, bn in (("head1", "conv3", "bn3"), ("head2", "conv4", "bn4")):
        sepa(h, mod)
        affine(f"{h}_aff", bn)
    for i in range(1, 5):
        fold(f"deconv{i}", f"uconv{i}.conv", f"uconv{i}.bn")
    return pack


def _forward(pack: dict, x: torch.Tensor, conv: Convs) -> torch.Tensor:
    """Xception3D's eval forward through ``conv``."""
    b = pack["b"]

    def affine(site, y):
        g, c = b[f"{site}:g"], b[f"{site}:b"]
        return y * g.view(-1, 1, 1, 1) + c.view(-1, 1, 1, 1)

    def sepa(site, y):
        y = F.relu(conv(f"{site}:sp", y, padding=_SP))
        return F.relu(conv(f"{site}:pt", y))

    y = F.relu(conv("stem1", x, b["stem1"], stride=(1, 2, 2), padding=_SP))
    y = F.relu(conv("stem2", y, b["stem2"], padding=_SP))
    for name, _, reps, stride, swr, has_skip, _, _ in BLOCKS:
        y0 = y
        for i in range(1, reps + 1):
            if i > 1 or swr:
                y = F.relu(y)
            y = affine(f"{name}:aff{i}", sepa(f"{name}:sepa{i}", y))
        if stride != 1:
            y = F.max_pool3d(y, (1, 3, 3), (1, stride, stride), (0, 1, 1))
        if has_skip:
            y0 = conv(f"{name}:skip", y0, b[f"{name}:skip"],
                      stride=(1, stride, stride))
        y = y + y0
    for h in ("head1", "head2"):
        y = F.relu(affine(f"{h}_aff", sepa(h, y)))
    for i in range(1, 5):
        y = F.leaky_relu(conv(f"deconv{i}", y, b[f"deconv{i}"], padding=_SP),
                         0.2)
        y = upsample_ncdhw(y, (1, 2, 2))
    y = F.conv3d(y, pack["f"]["head"], pack["f"]["head_b"], padding=_SP)
    return torch.sigmoid(y.float())


def forward_folded(pack: dict, x: torch.Tensor) -> torch.Tensor:
    return _forward(pack, x, Convs(pack))


def quantize_xception(sd: dict, batches) -> dict:
    return quantize(_forward, fold_xception(sd), batches)


def xception_forward_int8(pack: dict, x: torch.Tensor) -> torch.Tensor:
    return _forward(pack, x, Convs(pack, quantized=True))
