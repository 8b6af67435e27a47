"""The port's ``quant/`` and int8 products against the JAX package's on the
CPU.

* Integer sums: every int8 conv form of the JAX package (the spatial conv
  at stride 1 and 2, the temporal shifted GEMMs, the 1x1x1 projection,
  the 3x3x3 fuse, the ConvLSTM gate conv) gives int32 sums that the
  port's ``ops/int8.conv3d_i8`` equals bit for bit on the same int8
  operands; the JAX function is run at scale 1 (its float32 output is
  then its int32 sums, exact below 2^24).  With real scales and a bias
  only the float32 dequantisation differs: 1e-6 relative.
* ``fold_generator_bn``: the folded Generator's eval forward within 2e-4
  of the unfolded one (``tests/test_quant.py``'s bound), its BNs the
  identity.
* Each served family (MyGAN at ngf 4, c2plus1d at 32^2, Xception at
  xwidth 1/16, the ConvLSTM at 16^2), from JAX's randomised-BN variables
  bridged to the port (``utils/weights.py``):
  - the float mirror equals JAX's mirror (``tests/test_quant.py``'s
    tolerances: MyGAN 1e-5, clstm 2e-5, the others 2e-4);
  - with the same explicit calibration batches, the activation scales
    equal JAX's within 1e-5 relative (the float mirrors' rounding), the
    weight scales within 1e-6 relative, and the int8 weights equal JAX's
    but for at most ``WEIGHT_FLIPS`` of them, each by 1: XLA's float32
    ``rsqrt`` on the CPU rounds its last bit otherwise than
    ``torch.rsqrt`` on many values, so a folded weight can sit one ulp
    across a .5 of the int8 grid (measured: 2 of 1.3M in c2plus1d, none
    elsewhere);
  - with JAX's int8 weights and scales put into the port's pack (equal
    operands and scales), the int8 forward equals JAX's int8 forward
    within ``INT8_ATOL``.  The two float32 chains round pools and
    upsamples differently, and a value one ulp apart can round to the
    other int8 at the next site; in c2plus1d such flips come late and
    spread through its last blocks (``INT8_ATOL`` below; its mean error
    is held too);
  - the int8 forward tracks the float forward within JAX's bounds (max
    0.12, Xception 0.2; mean 0.02).
* ``build_int8_serving`` refuses a family that is not served, and an
  ``--moe_experts`` Xception; ``int8_matmul`` takes only int8.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfd_gan_tpu.models.convlstm import ConvLSTMModel as JaxConvLSTM
from vfd_gan_tpu.models.mygan import Generator as JaxGenerator
from vfd_gan_tpu.models.stcnn import AutoEncoder as JaxAutoEncoder
from vfd_gan_tpu.models.xception3d import Xception3D as JaxXception
from vfd_gan_tpu.quant import qclstm as jqclstm
from vfd_gan_tpu.quant import qmygan as jqmygan
from vfd_gan_tpu.quant import qstcnn as jqstcnn
from vfd_gan_tpu.quant import qxception as jqxception
from vfd_gan_tpu.quant.fold import fold_generator_bn as jax_fold
from vfd_gan_tpu_torch.models.mygan import Generator
from vfd_gan_tpu_torch.models.xception3d import Xception3D
from vfd_gan_tpu_torch.ops.image import to_channel_first, to_channel_last
from vfd_gan_tpu_torch.ops.int8 import conv3d_i8, int8_matmul
from vfd_gan_tpu_torch.quant import (
    build_int8_serving,
    fold_generator_bn,
    qclstm,
    qmygan,
    qstcnn,
    qxception,
)
from vfd_gan_tpu_torch.utils import weights
from test_torch_port_threads import one_torch_thread  # noqa: F401

# the int8 forward with equal operands and scales against JAX's, max and
# mean: MyGAN, Xception and the ConvLSTM measured 6.0e-8 at most;
# c2plus1d, where rounding flips late int8 inputs (module docstring),
# 1.24e-3 and 6.2e-5
INT8_ATOL = {"mygan": (1e-5, 1e-6), "c2plus1d": (5e-3, 2e-4),
             "xception": (1e-5, 1e-6), "clstm": (1e-5, 1e-6)}
# the share of int8 weights that may differ from JAX's, each by 1
WEIGHT_FLIPS = 1e-5


def _i8(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


def _taps(w_i8):
    """A JAX ``(k..., I, O)`` int8 kernel -> the port's ``(taps, O, I)``."""
    w = np.asarray(w_i8)
    return torch.from_numpy(np.ascontiguousarray(
        w.reshape(-1, *w.shape[-2:]).transpose(0, 2, 1)))


def _cl(x):
    """A channel-last numpy video as an NCDHW torch tensor."""
    return to_channel_first(torch.from_numpy(np.asarray(x)))


# form -> (JAX function of (x, s_x, w, s_w, bias) on channel-last x, the
# port's (kernel, stride, padding), x shape, JAX kernel shape)
FORMS = {
    "spatial_s1": (lambda x, sx, w, sw, b: jqmygan._spatial_conv_i8(
        x, sx, w, sw, b), ((1, 3, 3), (1, 1, 1), (0, 1, 1)),
        (2, 3, 9, 10, 5), (3, 3, 5, 21)),
    "spatial_s2": (lambda x, sx, w, sw, b: jqmygan._spatial_conv_i8(
        x, sx, w, sw, b, stride=2, padding=1),
        ((1, 3, 3), (1, 2, 2), (0, 1, 1)), (2, 2, 9, 12, 3), (3, 3, 3, 8)),
    "temporal": (jqmygan._temporal_conv_i8,
                 ((3, 1, 1), (1, 1, 1), (1, 0, 0)), (2, 5, 4, 3, 21),
                 (3, 21, 13)),
    "proj": (jqstcnn._proj_i8, ((1, 1, 1), (1, 1, 1), (0, 0, 0)),
             (2, 4, 3, 5, 19), (1, 1, 1, 19, 10)),
    "fuse": (lambda x, sx, w, sw, b: jqstcnn._conv3d_i8(x, sx, w, sw) + b,
             ((3, 3, 3), (1, 1, 1), (1, 1, 1)), (1, 4, 6, 5, 12),
             (3, 3, 3, 12, 9)),
    "clstm_gate": (lambda x, sx, w, sw, b: jqclstm._gate_conv_i8(
        x[:, 0], sx, w, sw)[:, None] + b, ((1, 3, 3), (1, 1, 1), (0, 1, 1)),
        (2, 1, 7, 6, 19), (3, 3, 19, 64)),
}


@pytest.mark.parametrize("form", list(FORMS))
def test_int8_sums_equal_jax_bit_for_bit(form):
    fn, (kernel, stride, padding), xshape, wshape = FORMS[form]
    rng = np.random.default_rng(len(form))
    xq, wq = _i8(rng, xshape), _i8(rng, wshape)
    cout = wshape[-1]
    ones, zeros = np.ones(cout, np.float32), np.zeros(cout, np.float32)
    want = np.asarray(fn(jnp.asarray(xq, jnp.float32), 1.0, jnp.asarray(wq),
                         jnp.asarray(ones), jnp.asarray(zeros)))
    assert np.abs(want).max() < 2 ** 24
    got = conv3d_i8(torch.from_numpy(xq), _taps(wq), kernel, stride, padding)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))

    # dequantised with real scales and a bias: only float32 rounding
    s_x = 0.0173
    s_w = rng.uniform(1e-3, 2e-2, cout).astype(np.float32)
    bias = rng.normal(0, 0.3, cout).astype(np.float32)
    x = xq.astype(np.float32) * np.float32(s_x)
    want = np.asarray(fn(jnp.asarray(x), s_x, jnp.asarray(wq),
                         jnp.asarray(s_w), jnp.asarray(bias)))
    w_torch = _taps(wq).permute(1, 2, 0).reshape(cout, wshape[-2], *kernel)
    got = to_channel_last(qmygan.conv_i8(
        _cl(x), torch.tensor(s_x), w_torch, torch.from_numpy(s_w),
        torch.from_numpy(bias), stride, padding))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def _variables(model, x, seed):
    """Random variables of the JAX ``model``'s shapes (``eval_shape``: no
    compile): kernels ~ N(0, 0.02) as the reference inits them, biases
    U(-0.1, 0.1), and the BatchNorms randomised as ``tests/test_quant.py``
    does (scale, bias, mean ~ N(0.3, 0.5), var ~ U(0.2, 3)), so that the
    folds are not identities."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0),
                                               jnp.asarray(x), False))

    def fill(path, leaf):
        names = [getattr(p, "key", "") for p in path]
        if "BatchNorm_0" in names:
            if names[-1] == "var":
                return rng.uniform(0.2, 3.0, leaf.shape).astype(np.float32)
            return rng.normal(0.3, 0.5, leaf.shape).astype(np.float32)
        if names[-1].endswith("bias"):
            return rng.uniform(-0.1, 0.1, leaf.shape).astype(np.float32)
        return rng.normal(0, 0.02, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _q_mygan(jpack):
    return {f"{n}:{t}": (b[f"{t}_w"], b[f"{t}_s"])
            for n, b in jpack["q"].items() for t in ("sp", "tp")}


def _q_ae(jpack):
    tags = {"sp": "sp", "tp": "tp", "pj": "proj", "fu": "fuse"}
    return {f"{n}:{site}": (b[f"{t}_w"], b[f"{t}_s"])
            for n, b in jpack["q"].items() for t, site in tags.items()}


def _q_xception(jpack):
    return {site: (d["w"], d["s"]) for site, d in jpack["q"].items()}


def _q_clstm(jpack):
    return {f"l{i}": (jpack["q"][f"l{i}_w"], jpack["q"][f"l{i}_s"])
            for i in (1, 2, 3)}


# family -> (JAX model, input shape, bridge, the JAX float mirror of the
# variables, the JAX quantiser and int8 forward, JAX q -> {site: (w, s)},
# the port's fold and forward, the mirror's tolerance, the int8-vs-float
# max bound)
FAMILIES = {
    "mygan": (lambda: JaxGenerator(ngf=4), (1, 16, 32, 32, 3),
              weights.generator_state_dict,
              lambda v, x: jqmygan.forward_folded(jax_fold(v)["params"], x),
              jqmygan.quantize_generator, jqmygan.generator_forward_int8,
              _q_mygan, qmygan.fold_generator, qmygan._forward, 1e-5, 0.12),
    "c2plus1d": (JaxAutoEncoder, (1, 16, 32, 32, 3),
                 weights.autoencoder_state_dict,
                 lambda v, x: jqstcnn.forward_folded(
                     jqstcnn.fold_autoencoder(v), x),
                 jqstcnn.quantize_autoencoder,
                 jqstcnn.autoencoder_forward_int8, _q_ae,
                 qstcnn.fold_autoencoder, qstcnn._forward, 2e-4, 0.12),
    "xception": (lambda: JaxXception(width_mult=0.0625), (1, 4, 32, 32, 3),
                 weights.xception_state_dict,
                 lambda v, x: jqxception.forward_folded(
                     jqxception.fold_xception(v), x),
                 jqxception.quantize_xception,
                 jqxception.xception_forward_int8, _q_xception,
                 qxception.fold_xception, qxception._forward, 2e-4, 0.2),
    "clstm": (JaxConvLSTM, (1, 6, 16, 16, 3), weights.convlstm_state_dict,
              jqclstm.convlstm_forward_float, jqclstm.quantize_convlstm,
              jqclstm.convlstm_forward_int8, _q_clstm, qclstm.fold_convlstm,
              qclstm._forward, 2e-5, 0.12),
}


def _traced_calibrate(forward_absmax, batches):
    """JAX ``calibrate``'s rule (the largest absmax over the batches, / 127,
    1 where it is 0) in the traced graph: JAX's own reads each batch's
    absmax on the host, which keeps its quantiser out of ``jax.jit``, and
    eager JAX compiles every op of the fold and the weight quantisation
    apart (~10 s a family).  ``test_calibrate_equals_jax`` holds the port's
    ``calibrate`` to JAX's own."""
    agg = {}
    for xb in batches:
        for site, v in forward_absmax(xb).items():
            agg[site] = jnp.maximum(agg[site], v) if site in agg else v
    return {site: jnp.where(v > 0, v / 127.0, 1.0) for site, v in agg.items()}


@functools.lru_cache(maxsize=None)
def _case(family):
    """JAX's variables (randomised BatchNorms), the input, the explicit
    calibration batches, and JAX's float and int8 results; JAX's quantiser
    runs under one ``jax.jit`` with ``_traced_calibrate``."""
    make, shape, bridge, jfloat, jquant, jint8, jsites = FAMILIES[family][:7]
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    variables = _variables(make(), x, 5)
    calib = [rng.uniform(-1, 1, shape).astype(np.float32), x]
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jqmygan, jqstcnn, jqxception, jqclstm):
            mp.setattr(mod, "calibrate", _traced_calibrate)
        jpack = jax.jit(jquant)(variables, [jnp.asarray(c) for c in calib])
    jpack["act_scales"] = {k: float(v)
                           for k, v in jpack["act_scales"].items()}
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in bridge(variables).items()}
    sites = {}
    for site, (w, sc) in jsites(jpack).items():
        w = np.asarray(w)
        layout = {3: weights._temporal, 4: weights._spatial,
                  5: weights._full}[w.ndim]
        sites[site] = (torch.from_numpy(layout(w).astype(np.int8)),
                       torch.from_numpy(np.array(sc)))
    return {"x": x, "calib": calib, "sd": sd,
            "float": np.asarray(jax.jit(jfloat)(variables, jnp.asarray(x))),
            "jpack": jpack, "sites": sites,
            "int8": np.asarray(jax.jit(jint8)(jpack, jnp.asarray(x)))}


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    return request.param


def _port_pack(family):
    fold, forward = FAMILIES[family][7:9]
    case = _case(family)
    return qmygan.quantize(forward, fold(case["sd"]),
                           [_cl(c) for c in case["calib"]])


def test_calibrate_equals_jax():
    rng = np.random.default_rng(0)
    draws = [{"a": np.float32(rng.uniform(0, 3)), "b": np.float32(0.0),
              "c": np.float32(rng.uniform(0, 1e-3))} for _ in range(3)]
    want = jqmygan.calibrate(lambda d: {k: jnp.asarray(v)
                                        for k, v in d.items()}, draws)
    got = qmygan.calibrate(lambda d: {k: torch.tensor(v)
                                      for k, v in d.items()}, draws)
    assert got == want and got["b"] == 1.0


def test_float_mirror_equals_jax(family):
    fold, forward, tol = FAMILIES[family][7:10]
    case = _case(family)
    pack = fold(case["sd"])
    with torch.no_grad():
        got = forward(pack, _cl(case["x"]), qmygan.Convs(pack))
    np.testing.assert_allclose(to_channel_last(got).numpy(), case["float"],
                               rtol=0, atol=tol)


def test_quantised_pack_equals_jax(family):
    case = _case(family)
    pack = _port_pack(family)
    scales = case["jpack"]["act_scales"]
    assert set(pack["act"]) == set(scales)
    for site, v in scales.items():
        np.testing.assert_allclose(float(pack["act"][site]), v, rtol=1e-5,
                                   err_msg=site)
    assert set(pack["q"]) == set(case["sites"])
    flips = total = 0
    for site, (w, sc) in case["sites"].items():
        d = (pack["q"][site].int() - w.int()).abs()
        assert int(d.max()) <= 1, site
        flips += int(d.sum())
        total += d.numel()
        np.testing.assert_allclose(pack["s"][site].numpy(), sc.numpy(),
                                   rtol=1e-6, err_msg=site)
    assert flips <= WEIGHT_FLIPS * total, (flips, total)


def test_int8_forward_equals_jax_and_tracks_float(family):
    forward, bound = FAMILIES[family][8], FAMILIES[family][10]
    case = _case(family)
    pack = _port_pack(family)
    with torch.no_grad():
        own = to_channel_last(forward(pack, _cl(case["x"]), qmygan.Convs(
            pack, quantized=True))).numpy()
        pack["act"] = {site: torch.tensor(v, dtype=torch.float32) for site, v
                       in case["jpack"]["act_scales"].items()}
        pack["q"] = {site: w for site, (w, _) in case["sites"].items()}
        pack["s"] = {site: sc for site, (_, sc) in case["sites"].items()}
        got = to_channel_last(forward(pack, _cl(case["x"]), qmygan.Convs(
            pack, quantized=True))).numpy()
    atol, mean = INT8_ATOL[family]
    np.testing.assert_allclose(got, case["int8"], rtol=0, atol=atol)
    assert np.abs(got - case["int8"]).mean() <= mean
    err = np.abs(own - case["float"])
    assert err.max() < bound and err.mean() < 0.02, (err.max(), err.mean())


def test_fold_generator_bn_holds_the_forward():
    sd = _case("mygan")["sd"]
    x = _cl(_case("mygan")["x"])
    model = Generator(ngf=4).eval()
    model.load_state_dict(sd)
    with torch.no_grad():
        want = model(x)
        model.load_state_dict(fold_generator_bn(sd))
        got = model(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-4)
    assert torch.equal(model.dconv1.bn.weight, torch.ones(4))
    assert torch.equal(model.dconv1.conv.bn.bias, torch.zeros_like(
        model.dconv1.conv.bn.bias))


def test_build_int8_serving_serves_the_generator():
    """The CLIs' entry on a bridged Generator: an int8 module with no
    parameters, on the model's device, tracking the float forward."""
    case = _case("mygan")
    model = Generator(ngf=4).eval()
    model.load_state_dict(case["sd"])
    served = build_int8_serving(model, isize=32, nfr=16, calib_clips=2)
    assert not list(served.parameters())
    assert {b.dtype for b in served.buffers()} >= {torch.int8}
    with torch.no_grad():
        got = served(_cl(case["x"]))
        want = model(_cl(case["x"]))
    assert got.shape == (1, 1, 16, 32, 32)
    assert float((got - want).abs().mean()) < 0.02


@pytest.mark.parametrize("model, match", [
    (lambda: torch.nn.Conv3d(3, 1, 1), "supports mygan-generator"),
    (lambda: Xception3D(3, 0.0625, moe_experts=2), "MoE block"),
], ids=["not_served", "moe_xception"])
def test_build_int8_serving_refuses(model, match):
    with pytest.raises(SystemExit, match=match):
        build_int8_serving(model(), isize=32, nfr=4, calib_clips=1)


def test_int8_matmul_takes_int8_only():
    a = torch.ones(20, 8, dtype=torch.int8)
    assert torch.equal(int8_matmul(a, a.t().contiguous()),
                       torch.full((20, 20), 8, dtype=torch.int32))
    with pytest.raises(TypeError):
        int8_matmul(a.float(), a.t().float())


def test_full_width_xception_int8_error_is_jax_s():
    """Xception at full width (78 int8 sites, 30 of them in sequence), its
    head scaled to a unit logit spread as ``chip_smoke.py``'s checkpoints
    are: the port's int8 forward is as far from the float forward as the
    JAX package's, on the same weights and calibration batches (32^2, T4),
    its mean error within 1.5x of JAX's (measured: mean 0.0120 both, max
    0.083 the port, 0.062 JAX)."""
    shape = (1, 4, 32, 32, 3)
    rng = np.random.default_rng(11)
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    calib = [rng.uniform(-1, 1, shape).astype(np.float32) for _ in range(2)]
    model = JaxXception()
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0),
                                               jnp.asarray(x), False))

    def fill(path, leaf):
        name = path[-1].key
        if name in ("var", "scale"):
            return np.ones(leaf.shape, np.float32)
        if name in ("mean", "bias", "head_bias"):
            return np.zeros(leaf.shape, np.float32)
        return rng.normal(0, 0.02, leaf.shape).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(
        fill, {k: shapes[k] for k in ("params", "batch_stats")})
    head = rng.normal(0, 0.5, variables["params"]["head_kernel"].shape)
    variables["params"]["head_kernel"] = (head - head.mean(
        axis=(0, 1), keepdims=True)).astype(np.float32)
    apply = jax.jit(lambda v, x: model.apply(v, x, False))
    p = np.asarray(apply(variables, jnp.asarray(calib[0]))).clip(1e-6,
                                                                 1 - 1e-6)
    logit = np.log(p / (1 - p))
    variables["params"]["head_kernel"] /= np.float32(logit.std())
    variables["params"]["head_bias"] = np.full(
        (1,), -logit.mean() / logit.std(), np.float32)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jqxception, "calibrate", _traced_calibrate)
        jpack = jax.jit(jqxception.quantize_xception)(
            variables, [jnp.asarray(c) for c in calib])
    jfloat = np.asarray(apply(variables, jnp.asarray(x)))
    jint8 = np.asarray(jax.jit(jqxception.xception_forward_int8)(
        jpack, jnp.asarray(x)))
    sd = {k: torch.from_numpy(np.array(v)) for k, v in
          weights.xception_state_dict(variables).items()}
    pack = qmygan.quantize(qxception._forward, qxception.fold_xception(sd),
                           [_cl(c) for c in calib])
    with torch.no_grad():
        got = to_channel_last(qxception.xception_forward_int8(
            pack, _cl(x))).numpy()
    jax_err = np.abs(jint8 - jfloat).mean()
    port_err = np.abs(got - jfloat).mean()
    assert 0 < port_err <= 1.5 * jax_err, (jax_err, port_err)
