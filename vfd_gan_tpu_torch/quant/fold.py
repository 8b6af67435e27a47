"""Fold inference-mode BatchNorm into the MyGAN generator's convs (port of
``vfd_gan_tpu.quant.fold``).

Every ``GenConvBlock`` is ``spatial_conv(+bias) -> BN -> relu ->
temporal_conv(+bias) -> BN -> leaky_relu``.  In inference mode a BN is the
affine ``y = (x - mu) g + beta`` with ``g = weight * rsqrt(var + eps)``,
which composes exactly into the conv before it::

    W' = W * g[out]          b' = b * g + (beta - mu * g)

``fold_generator_bn`` returns a ``state_dict`` for the same ``Generator``:
the conv weights and biases carry the BN affines and each folded BN is the
identity (weight 1, bias 0, mean 0, var 1 - eps, so ``rsqrt(var + eps)``
is 1).  The folded model's eval forward is the unfolded one's to float32
rounding.  Inference only: a train-mode forward would compute batch
statistics of the rescaled activations.
"""

from __future__ import annotations

import torch

EPS = 1e-5   # the port's BatchNorms' eps (models/layers.py)


def bn_affine(sd: dict, prefix: str):
    """``(g, b)`` of the BN ``prefix`` of ``state_dict`` ``sd``: its eval
    forward is ``x * g + b`` per channel."""
    g = sd[f"{prefix}.weight"] * torch.rsqrt(sd[f"{prefix}.running_var"]
                                             + EPS)
    return g, sd[f"{prefix}.bias"] - sd[f"{prefix}.running_mean"] * g


def per_out(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``g`` (Cout,) shaped to scale a torch-layout weight ``(Cout, ...)``."""
    return g.view(-1, *(1,) * (w.dim() - 1))


def _identity_bn(sd: dict, prefix: str) -> None:
    feat = sd[f"{prefix}.weight"]
    sd[f"{prefix}.weight"] = torch.ones_like(feat)
    sd[f"{prefix}.bias"] = torch.zeros_like(feat)
    sd[f"{prefix}.running_mean"] = torch.zeros_like(feat)
    sd[f"{prefix}.running_var"] = torch.full_like(feat, 1.0 - EPS)


def fold_generator_bn(sd: dict) -> dict:
    """BN-fold a ``Generator`` ``state_dict``: each block's mid BN into its
    spatial conv and its block BN into its temporal conv."""
    out = dict(sd)
    for name in {k.split(".")[0] for k in sd if k.startswith(("dconv",
                                                                "uconv"))}:
        for conv, bn in (("conv.spatial_conv", "conv.bn"),
                         ("conv.temporal_conv", "bn")):
            g, b = bn_affine(sd, f"{name}.{bn}")
            w = sd[f"{name}.{conv}.weight"]
            out[f"{name}.{conv}.weight"] = w * per_out(g, w)
            out[f"{name}.{conv}.bias"] = sd[f"{name}.{conv}.bias"] * g + b
            _identity_bn(out, f"{name}.{bn}")
    return out
