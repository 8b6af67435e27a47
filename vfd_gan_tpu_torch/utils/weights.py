"""The weight bridge: JAX model variables -> the port's ``state_dict``.

Numpy only, so it runs where jax is absent: the JAX
``{"params", "batch_stats"}`` tree, given as (or convertible to) numpy
arrays, becomes reference NetG / NetD ``state_dict`` keys and torch
layouts.  The same rules as
``vfd_gan_tpu.utils.torch_export`` (``mygan_generator_to_torch``,
``mygan_dualdisc_to_torch``, ``stcnn_autoencoder_to_torch``,
``convlstm_to_torch``, ``xception_to_torch``,
``anogan_{generator,discriminator}_to_torch``), restated because importing
that package pulls in jax; GANomaly, which has no reference ``.pth``
layout, maps onto the port's own names:

* spatial kernel ``(kh, kw, I, O)``  -> Conv3d ``(O, I, 1, kh, kw)``
* temporal kernel ``(kt, I, O)``     -> Conv3d ``(O, I, kt, 1, 1)``
* full kernel ``(kt, kh, kw, I, O)`` -> Conv3d ``(O, I, kt, kh, kw)``
* 2-D kernel ``(kh, kw, I, O)``      -> Conv2d ``(O, I, kh, kw)`` (ConvLSTM,
  GANomaly)
* transposed kernels ``(k..., I, O)`` -> ConvTranspose ``(I, O, k...)``
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
    (numpy; torch_export.xception_to_torch).

    An ``--moe_experts`` model's ``params["moe"]`` (no reference layout,
    and ``xception_to_torch`` drops it) keeps its JAX names and layouts
    under the port's ``moe.`` prefix: ``moe.router (C, E)``,
    ``moe.experts_w1`` / ``moe.experts_w2`` ``(E, C, C)`` and
    ``moe.experts_b1`` / ``moe.experts_b2`` ``(E, C)``
    (``models/moe_block.py``)."""
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
    for name, v in p.get("moe", {}).items():
        out[f"moe.{name}"] = _f32(v)
    return out


def _transpose3d(k) -> np.ndarray:
    """``(kt, kh, kw, Cin, Cout)`` -> ConvTranspose3d ``(Cin, Cout, kt, kh,
    kw)`` (torch_export.transpose_to_conv3d_transpose)."""
    return _f32(k).transpose(3, 4, 0, 1, 2)


def anogan_generator_state_dict(variables: dict, nfr: int = 16,
                                isize: int = 128) -> dict[str, np.ndarray]:
    """JAX ``AnoGenerator`` variables -> reference AnoGAN NetG
    ``state_dict`` (numpy; torch_export.anogan_generator_to_torch).  The
    seed Linear's features and its BatchNorm1d are permuted from JAX's
    (T, H, W, C) reshape order to torch's (C, T, H, W)."""
    p, s = variables["params"], variables["batch_stats"]
    t0, s0 = nfr // 8, isize // 8
    perm = np.arange(512 * t0 * s0 * s0).reshape(512, t0, s0, s0) \
        .transpose(1, 2, 3, 0).ravel()
    inv = np.argsort(perm)
    dense = p["fc"]["Dense_0"]
    out: dict = {"layer1.0.weight": _f32(dense["kernel"])[:, inv].T,
                 "layer1.0.bias": _f32(dense["bias"])[inv]}
    _bn(out, "layer1.1", {k: _f32(v)[inv] for k, v in p["fc_bn"].items()},
        {k: _f32(v)[inv] for k, v in s["fc_bn"].items()})
    for i, (name, (tk, ck, bk)) in enumerate((
            ("up1", ("layer2.1", "layer2.2", "layer2.3")),
            ("up2", ("layer2.6", "layer2.7", "layer2.8")),
            ("up3", ("layer3.1", "layer3.2", "layer3.3")),
            ("up4", ("layer3.6", "layer3.7", None))), start=1):
        out[f"{tk}.weight"] = _transpose3d(p[f"{name}_tkernel"])
        out[f"{tk}.bias"] = _f32(p[f"{name}_tbias"])
        out[f"{ck}.weight"] = _full(p[f"{name}_ckernel"])
        out[f"{ck}.bias"] = _f32(p[f"{name}_cbias"])
        if bk is not None:
            _bn(out, bk, p[f"bn{i}"], s[f"bn{i}"])
    return out


def anogan_discriminator_state_dict(variables: dict,
                                    nfr: int = 16) -> dict[str, np.ndarray]:
    """JAX ``AnoDiscriminator`` variables -> reference AnoGAN NetD
    ``state_dict`` (numpy; torch_export.anogan_discriminator_to_torch).
    The pooled features are ``(256, nfr / 8, s, s)``; torch_export
    hardcodes their time axis to 2, which is right at nfr 16 only."""
    p, s = variables["params"], variables["batch_stats"]
    out: dict = {}
    for ours, ref in (("conv1", "layer1.0"), ("conv2", "layer1.3"),
                      ("conv3", "layer1.4"), ("conv4", "layer2.0"),
                      ("conv5", "layer2.1"), ("conv6", "layer2.5")):
        out[f"{ref}.weight"] = _full(p[f"{ours}_kernel"])
        out[f"{ref}.bias"] = _f32(p[f"{ours}_bias"])
    for ours, ref in (("bn1", "layer1.1"), ("bn2", "layer1.5"),
                      ("bn3", "layer2.2"), ("bn4", "layer2.6")):
        _bn(out, ref, p[ours], s[ours])
    dense = p["fc"]["Dense_0"]
    t = nfr // 8
    side = int(round((np.asarray(dense["kernel"]).shape[0] // (256 * t))
                     ** 0.5))
    out["fc.0.weight"] = linear_to_torch(dense["kernel"], (256, t, side, side))
    out["fc.0.bias"] = _f32(dense["bias"])
    return out


def _conv2d(k) -> np.ndarray:
    """``(kh, kw, Cin, Cout)`` -> Conv2d ``(Cout, Cin, kh, kw)``."""
    return _f32(k).transpose(3, 2, 0, 1)


def _transpose2d(k) -> np.ndarray:
    """``(kh, kw, Cin, Cout)`` -> ConvTranspose2d ``(Cin, Cout, kh, kw)``."""
    return _f32(k).transpose(2, 3, 0, 1)


def _dcgan_block(out: dict, prefix: str, kernel, p: dict, s: dict) -> None:
    out[f"{prefix}.conv.weight"] = kernel
    _bn(out, f"{prefix}.bn", p, s)


def _dcgan_encoder(out: dict, prefix: str, p: dict, s: dict) -> None:
    out[f"{prefix}.stem.weight"] = _conv2d(p["stem_kernel"])
    t = 0
    while f"extra{t}_kernel" in p:
        _dcgan_block(out, f"{prefix}.extra.{t}",
                     _conv2d(p[f"extra{t}_kernel"]), p[f"extra{t}_bn"],
                     s[f"extra{t}_bn"])
        t += 1
    i = 0
    while f"pyr{i}_kernel" in p:
        _dcgan_block(out, f"{prefix}.pyramid.{i}",
                     _conv2d(p[f"pyr{i}_kernel"]), p[f"pyr{i}_bn"],
                     s[f"pyr{i}_bn"])
        i += 1
    if "final_kernel" in p:
        out[f"{prefix}.final.weight"] = _conv2d(p["final_kernel"])


def ganomaly_generator_state_dict(variables: dict) -> dict[str, np.ndarray]:
    """JAX ``GanomalyGenerator`` variables -> the port's
    ``GanomalyGenerator`` ``state_dict`` (numpy; the reference has no
    trained GANomaly, so the names are the port's own)."""
    p, s = variables["params"], variables["batch_stats"]
    out: dict = {}
    _dcgan_encoder(out, "enc1", p["enc1"], s["enc1"])
    dp, ds = p["dec"], s["dec"]
    _dcgan_block(out, "dec.stem", _transpose2d(dp["stem_kernel"]),
                 dp["stem_bn"], ds["stem_bn"])
    i = 0
    while f"pyr{i}_kernel" in dp:
        _dcgan_block(out, f"dec.pyramid.{i}",
                     _transpose2d(dp[f"pyr{i}_kernel"]), dp[f"pyr{i}_bn"],
                     ds[f"pyr{i}_bn"])
        i += 1
    t = 0
    while f"extra{t}_kernel" in dp:
        _dcgan_block(out, f"dec.extra.{t}", _conv2d(dp[f"extra{t}_kernel"]),
                     dp[f"extra{t}_bn"], ds[f"extra{t}_bn"])
        t += 1
    out["dec.final.weight"] = _transpose2d(dp["final_kernel"])
    _dcgan_encoder(out, "enc2", p["enc2"], s["enc2"])
    return out


def ganomaly_discriminator_state_dict(variables: dict
                                      ) -> dict[str, np.ndarray]:
    """JAX ``GanomalyDiscriminator`` variables -> the port's
    ``GanomalyDiscriminator`` ``state_dict`` (numpy)."""
    p, s = variables["params"], variables["batch_stats"]
    out: dict = {}
    _dcgan_encoder(out, "trunk", p["trunk"], s["trunk"])
    out["classifier.weight"] = _conv2d(p["cls_kernel"])
    return out
