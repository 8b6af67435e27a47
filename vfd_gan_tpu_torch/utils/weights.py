"""The weight bridge: JAX model variables -> the port's ``state_dict``.

Numpy only, so it runs where jax is absent: the JAX
``{"params", "batch_stats"}`` tree, given as (or convertible to) numpy
arrays, becomes reference NetG / NetD ``state_dict`` keys and torch
layouts.  The same rules as
``vfd_gan_tpu.utils.torch_export`` (``mygan_generator_to_torch``,
``mygan_dualdisc_to_torch``, ``stcnn_autoencoder_to_torch``,
``convlstm_to_torch``, ``xception_to_torch``), restated because importing
that package pulls in jax:

* spatial kernel ``(kh, kw, I, O)``  -> Conv3d ``(O, I, 1, kh, kw)``
* temporal kernel ``(kt, I, O)``     -> Conv3d ``(O, I, kt, 1, 1)``
* full kernel ``(kt, kh, kw, I, O)`` -> Conv3d ``(O, I, kt, kh, kw)``
* 2-D kernel ``(kh, kw, I, O)``      -> Conv2d ``(O, I, kh, kw)`` (ConvLSTM)
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


def _spatial(k) -> np.ndarray:
    return _f32(k).transpose(3, 2, 0, 1)[:, :, None]


def _temporal(k) -> np.ndarray:
    return _f32(k).transpose(2, 1, 0)[:, :, :, None, None]


def _full(k) -> np.ndarray:
    return _f32(k).transpose(4, 3, 0, 1, 2)


def _gen_block(out: dict, prefix: str, p: dict, s: dict) -> None:
    st, ss = p["stconv"], s["stconv"]
    out[f"{prefix}.conv.spatial_conv.weight"] = _spatial(st["spatial_kernel"])
    out[f"{prefix}.conv.spatial_conv.bias"] = _f32(st["spatial_bias"])
    out[f"{prefix}.conv.temporal_conv.weight"] = \
        _temporal(st["temporal_kernel"])
    out[f"{prefix}.conv.temporal_conv.bias"] = _f32(st["temporal_bias"])
    _bn(out, f"{prefix}.conv.bn", st["mid_bn"], ss["mid_bn"])
    _bn(out, f"{prefix}.bn", p["bn"], s["bn"])


def generator_state_dict(variables: dict) -> dict[str, np.ndarray]:
    """JAX ``Generator`` variables -> reference NetG ``state_dict`` (numpy)."""
    p, s = variables["params"], variables["batch_stats"]
    out: dict = {}
    for name in GENERATOR_BLOCKS:
        _gen_block(out, name, p[name], s[name])
    out["conv_last.weight"] = _full(p["head_kernel"])
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


def autoencoder_state_dict(variables: dict) -> dict[str, np.ndarray]:
    """JAX ``AutoEncoder`` ("c2plus1d") variables -> reference AutoEncoder
    ``state_dict`` (numpy; torch_export.stcnn_autoencoder_to_torch)."""
    p, s = variables["params"], variables["batch_stats"]
    out: dict = {}
    for ours, ref in (("down1", "down_sep1"), ("down2", "down_sep2"),
                      ("down3", "down_sep3"), ("down4", "down_sep4"),
                      ("up1", "up_sep1"), ("up2", "up_sep2"),
                      ("up3", "up_sep3"), ("up4", "up_sep4")):
        bp, bs = p[ours], s[ours]
        out[f"{ref}.spaceconv.weight"] = _spatial(bp["space_kernel"])
        out[f"{ref}.pointwise.weight"] = _temporal(bp["time_kernel"])
        out[f"{ref}.conv.weight"] = _full(bp["proj_kernel"])
        out[f"{ref}.conv.bias"] = _f32(bp["proj_bias"])
        out[f"{ref}.conv_last.weight"] = _full(bp["fuse_kernel"])
        _bn(out, f"{ref}.bn1", bp["bn1"], bs["bn1"])
        _bn(out, f"{ref}.bn2", bp["bn2"], bs["bn2"])
    out["conv_last.weight"] = _full(p["head_kernel"])
    return out


def convlstm_state_dict(variables: dict) -> dict[str, np.ndarray]:
    """JAX ``ConvLSTMModel`` variables -> reference ConvLSTM ``state_dict``
    (numpy; torch_export.convlstm_to_torch)."""
    p, s = variables["params"], variables["batch_stats"]
    out: dict = {}
    for i in (1, 2, 3):
        out[f"clstm{i}.cell_list.0.conv.weight"] = _f32(
            p[f"clstm{i}"]["gate_kernel"]).transpose(3, 2, 0, 1)
        _bn(out, f"bn{i}", p[f"bn{i}"], s[f"bn{i}"])
    out["conv_last.weight"] = _full(p["head_kernel"])
    return out


# ``block{i}.rep`` indices of each Xception block flavour: (SepaConv
# indices, BN indices), from the reference's Sequential (entry blocks start
# without a ReLU; middle and exit blocks start with one)
XCEPTION_REPS = {"entry": ((0, 3), (1, 4)), "middle": ((1, 4, 7), (2, 5, 8)),
                 "exit": ((1, 4), (2, 5))}


def xception_state_dict(variables: dict) -> dict[str, np.ndarray]:
    """JAX ``Xception3D`` variables -> reference Xception ``state_dict``
    (numpy; torch_export.xception_to_torch)."""
    p, s = variables["params"], variables["batch_stats"]
    out: dict = {}

    def sepa(prefix: str, sp: dict) -> None:
        out[f"{prefix}.conv1.weight"] = _spatial(sp["space_kernel"])
        out[f"{prefix}.pointwise.weight"] = _spatial(sp["point_kernel"])

    def block(ours: str, ref: str, flavour: str, has_skip: bool) -> None:
        bp, bs = p[ours], s[ours]
        for j, (si, bi) in enumerate(zip(*XCEPTION_REPS[flavour]), start=1):
            sepa(f"{ref}.rep.{si}", bp[f"sepa{j}"])
            _bn(out, f"{ref}.rep.{bi}", bp[f"bn{j}"], bs[f"bn{j}"])
        if has_skip:
            out[f"{ref}.skip.weight"] = _spatial(bp["skip_kernel"])
            _bn(out, f"{ref}.skipbn", bp["skip_bn"], bs["skip_bn"])

    out["conv1.weight"] = _spatial(p["stem1_kernel"])
    out["conv2.weight"] = _spatial(p["stem2_kernel"])
    _bn(out, "bn1", p["stem1_bn"], s["stem1_bn"])
    _bn(out, "bn2", p["stem2_bn"], s["stem2_bn"])
    for i in (1, 2, 3):
        block(f"entry{i}", f"block{i}", "entry", True)
    for i in range(8):
        block(f"middle{i + 1}", f"block{i + 4}", "middle", False)
    block("exit", "block12", "exit", True)
    sepa("conv3", p["head1"])
    sepa("conv4", p["head2"])
    _bn(out, "bn3", p["head1_bn"], s["head1_bn"])
    _bn(out, "bn4", p["head2_bn"], s["head2_bn"])
    for i in (1, 2, 3, 4):
        out[f"uconv{i}.conv.weight"] = _spatial(p[f"deconv{i}"]["kernel"])
        _bn(out, f"uconv{i}.bn", p[f"deconv{i}"]["bn"], s[f"deconv{i}"]["bn"])
    out["conv_last.weight"] = _spatial(p["head_kernel"])
    out["conv_last.bias"] = _f32(p["head_bias"])
    return out
