"""Int8 PTQ serving forward of the (2+1)D AutoEncoder, "c2plus1d" (port of
``vfd_gan_tpu.quant.qstcnn``).

The scheme of ``quant/qmygan.py``.  Inference BNs fold into the bias-free
convs before them as a weight scale and a bias: ``bn1`` into the spatial
``spaceconv``, ``bn2`` into the temporal ``pointwise``.  The residual
1x1x1 projection (``conv``, with its bias; the JAX package's ``_proj_i8``
einsum) and the 3x3x3 fuse (``conv_last`` of a block, no bias; JAX's
``_conv3d_i8``) are int8 sites too; the model's 64 -> 1 head stays float.
The mirror follows ``C2Plus1dBlock``/``AutoEncoder.forward``
(models/stcnn.py) in eval mode: residual projection, pool and upsample
placement, concat order.  Sites keep the JAX block names ``down1..4``,
``up1..4``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vfd_gan_tpu_torch.ops.convs import avg_pool_ncdhw
from vfd_gan_tpu_torch.ops.resize import upsample_ncdhw
from vfd_gan_tpu_torch.quant.fold import bn_affine, per_out
from vfd_gan_tpu_torch.quant.qmygan import Convs, quantize

# JAX block name -> the port's module
BLOCKS = {**{f"down{i}": f"down_sep{i}" for i in range(1, 5)},
          **{f"up{i}": f"up_sep{i}" for i in range(1, 5)}}


def fold_autoencoder(sd: dict) -> dict:
    """An ``AutoEncoder`` ``state_dict`` -> its float pack."""
    pack = {"w": {}, "b": {}, "f": {"head": sd["conv_last.weight"]}}
    for name, mod in BLOCKS.items():
        for tag, conv, bn in (("sp", "spaceconv", "bn1"),
                              ("tp", "pointwise", "bn2")):
            g, b = bn_affine(sd, f"{mod}.{bn}")
            w = sd[f"{mod}.{conv}.weight"]
            pack["w"][f"{name}:{tag}"] = w * per_out(g, w)
            pack["b"][f"{name}:{tag}"] = b
        pack["w"][f"{name}:proj"] = sd[f"{mod}.conv.weight"]
        pack["b"][f"{name}:proj"] = sd[f"{mod}.conv.bias"]
        pack["w"][f"{name}:fuse"] = sd[f"{mod}.conv_last.weight"]
    return pack


def _forward(pack: dict, x: torch.Tensor, conv: Convs) -> torch.Tensor:
    """The AutoEncoder's eval forward through ``conv``."""
    b = pack["b"]

    def block(name, y, down):
        residual = y
        y = F.relu(conv(f"{name}:sp", y, b[f"{name}:sp"], padding=(0, 1, 1)))
        y = F.relu(conv(f"{name}:tp", y, b[f"{name}:tp"], padding=(1, 0, 0)))
        if down:
            y = avg_pool_ncdhw(y, 2)
        else:
            y = upsample_ncdhw(y)
            residual = upsample_ncdhw(residual)  # dropout: eval identity
        residual = conv(f"{name}:proj", residual, b[f"{name}:proj"])
        if down:
            residual = avg_pool_ncdhw(residual, 2)
        return conv(f"{name}:fuse", torch.cat([y, residual], 1),
                    padding=(1, 1, 1))

    d1 = block("down1", x, True)
    d2 = block("down2", d1, True)
    d3 = block("down3", d2, True)
    d4 = block("down4", d3, True)
    u = block("up1", d4, False)
    u = block("up2", torch.cat([u, d3], 1), False)
    u = block("up3", torch.cat([u, d2], 1), False)
    u = block("up4", torch.cat([u, d1], 1), False)
    return torch.sigmoid(F.conv3d(u, pack["f"]["head"], padding=1).float())


def forward_folded(pack: dict, x: torch.Tensor) -> torch.Tensor:
    return _forward(pack, x, Convs(pack))


def quantize_autoencoder(sd: dict, batches) -> dict:
    return quantize(_forward, fold_autoencoder(sd), batches)


def autoencoder_forward_int8(pack: dict, x: torch.Tensor) -> torch.Tensor:
    return _forward(pack, x, Convs(pack, quantized=True))
