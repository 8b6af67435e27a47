"""The weight bridge: JAX ``Generator`` variables -> the port's ``state_dict``.

Numpy only, so it runs where jax is absent: the JAX
``{"params", "batch_stats"}`` tree, given as (or convertible to) numpy
arrays, becomes reference NetG ``state_dict`` keys and torch layouts.  The
same rules as ``vfd_gan_tpu.utils.torch_export.mygan_generator_to_torch``,
restated because importing that package pulls in jax:

* spatial kernel ``(kh, kw, I, O)``  -> Conv3d ``(O, I, 1, kh, kw)``
* temporal kernel ``(kt, I, O)``     -> Conv3d ``(O, I, kt, 1, 1)``
* full kernel ``(kt, kh, kw, I, O)`` -> Conv3d ``(O, I, kt, kh, kw)``
* BN ``scale/bias/mean/var`` -> ``weight/bias/running_mean/running_var``,
  plus a zero ``num_batches_tracked``.
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
