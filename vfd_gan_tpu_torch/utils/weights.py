"""The weight bridge: JAX MyGAN variables -> the port's ``state_dict``.

Numpy only, so it runs where jax is absent: the JAX
``{"params", "batch_stats"}`` tree, given as (or convertible to) numpy
arrays, becomes reference NetG / NetD ``state_dict`` keys and torch
layouts.  The same rules as
``vfd_gan_tpu.utils.torch_export.mygan_generator_to_torch`` and
``mygan_dualdisc_to_torch``, restated because importing that package pulls
in jax:

* spatial kernel ``(kh, kw, I, O)``  -> Conv3d ``(O, I, 1, kh, kw)``
* temporal kernel ``(kt, I, O)``     -> Conv3d ``(O, I, kt, 1, 1)``
* full kernel ``(kt, kh, kw, I, O)`` -> Conv3d ``(O, I, kt, kh, kw)``
* BN ``scale/bias/mean/var`` -> ``weight/bias/running_mean/running_var``,
  plus a zero ``num_batches_tracked``.
* Dense kernel ``(I, O)`` -> Linear ``(O, I)``, its input axis permuted
  from JAX's channel-last flatten ``(*spatial, C)`` to the NCDHW flatten
  ``(C, *spatial)`` of the pooled features.  Without the permutation every
  conv matches and the score is still wrong.
"""

from __future__ import annotations

import numpy as np

GENERATOR_BLOCKS = ("dconv1", "dconv2", "dconv3", "dconv4", "dconv5",
                    "uconv5", "uconv4", "uconv3", "uconv2", "uconv1")


def _f32(x) -> np.ndarray:
    return np.asarray(x).astype(np.float32, copy=False)


def _bn(out: dict, prefix: str, p: dict, s: dict) -> None:
    # flax nests each BN's variables under "BatchNorm_0"
    p, s = p.get("BatchNorm_0", p), s.get("BatchNorm_0", s)
    out[f"{prefix}.weight"] = _f32(p["scale"])
    out[f"{prefix}.bias"] = _f32(p["bias"])
    out[f"{prefix}.running_mean"] = _f32(s["mean"])
    out[f"{prefix}.running_var"] = _f32(s["var"])
    out[f"{prefix}.num_batches_tracked"] = np.asarray(0, np.int64)


def _gen_block(out: dict, prefix: str, p: dict, s: dict) -> None:
    st, ss = p["stconv"], s["stconv"]
    out[f"{prefix}.conv.spatial_conv.weight"] = \
        _f32(st["spatial_kernel"]).transpose(3, 2, 0, 1)[:, :, None]
    out[f"{prefix}.conv.spatial_conv.bias"] = _f32(st["spatial_bias"])
    out[f"{prefix}.conv.temporal_conv.weight"] = \
        _f32(st["temporal_kernel"]).transpose(2, 1, 0)[:, :, :, None, None]
    out[f"{prefix}.conv.temporal_conv.bias"] = _f32(st["temporal_bias"])
    _bn(out, f"{prefix}.conv.bn", st["mid_bn"], ss["mid_bn"])
    _bn(out, f"{prefix}.bn", p["bn"], s["bn"])


def generator_state_dict(variables: dict) -> dict[str, np.ndarray]:
    """JAX ``Generator`` variables -> reference NetG ``state_dict`` (numpy)."""
    p, s = variables["params"], variables["batch_stats"]
    out: dict = {}
    for name in GENERATOR_BLOCKS:
        _gen_block(out, name, p[name], s[name])
    out["conv_last.weight"] = _f32(p["head_kernel"]).transpose(4, 3, 0, 1, 2)
    return out


def linear_to_torch(kernel, pre_flatten_shape=None) -> np.ndarray:
    """Dense kernel ``(I, O)`` -> Linear weight ``(O, I)``;
    ``pre_flatten_shape`` is the NCDHW ``(C, d1, d2, ...)`` shape of the
    flattened features (torch_export.linear_to_torch)."""
    w = _f32(kernel).T                                  # (O, I)
    if pre_flatten_shape is not None:
        o = w.shape[0]
        c, *spatial = pre_flatten_shape
        nd = len(pre_flatten_shape)
        w = w.reshape(o, *spatial, c)                   # (O, d1, ..., C)
        w = w.transpose((0, nd, *range(1, nd)))         # (O, C, d1, ...)
        w = w.reshape(o, -1)
    return w


def dualdisc_state_dict(variables: dict) -> dict[str, np.ndarray]:
    """JAX ``DualDisc`` variables -> reference NetD ``state_dict`` (numpy).

    The pooled geometry comes from the weights themselves: the branch's
    last block gives C, the Linear's input size C x (the rest), which is
    ``(C, 1, s, s)`` for the spatial branch (global temporal pool) and
    ``(C, t, 1, 1)`` for the temporal one (global spatial pool).  At the
    reference's 16 x 128 x 128 this is exactly
    ``torch_export.mygan_dualdisc_to_torch``."""
    p, s = variables["params"], variables["batch_stats"]
    out: dict = {}
    for branch, n_blocks in (("spatdisc", 6), ("tempdisc", 3)):
        bp, bs = p[branch], s[branch]
        for i in range(1, n_blocks + 1):
            _gen_block(out, f"{branch}.dconv{i}", bp[f"dconv{i}"],
                       bs[f"dconv{i}"])
        c = np.asarray(
            bp[f"dconv{n_blocks}"]["stconv"]["temporal_kernel"]).shape[-1]
        dense = bp["linear"]["Dense_0"]
        rest = np.asarray(dense["kernel"]).shape[0] // c
        if branch == "spatdisc":
            side = int(round(rest ** 0.5))
            pre = (c, 1, side, side)
        else:
            pre = (c, rest, 1, 1)
        out[f"{branch}.linear.weight"] = linear_to_torch(dense["kernel"], pre)
        out[f"{branch}.linear.bias"] = _f32(dense["bias"])
    return out
