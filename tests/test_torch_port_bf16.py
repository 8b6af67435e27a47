"""The port's bfloat16 compute against the JAX package's on the CPU: the
3x3 conv kernel and the modules.  The four nets are
``tests/test_torch_port_bf16_nets.py``'s, the train steps and the entry
points ``tests/test_torch_port_bf16_step.py``'s.

The JAX package computes in bfloat16 under ``dtype=jnp.bfloat16`` with
float32 parameters (its trainer's default); the port does under
``dtype=torch.bfloat16``.  Inputs come from numpy with a seed; JAX runs on
the CPU, jitted as its engines run it, the conv kernel's Pallas form in
interpret mode.  Where XLA keeps a value in float32 inside a fusion that
the JAX source types bfloat16 (a conv's bias add read by a BatchNorm), the
port keeps it float32 too (``models/layers.py::Conv3d``).

Tolerances, with what these tests measure on the CPU:

* the conv kernel: forward and dx within one bfloat16 ulp of
  ``conv3x3_pallas`` (both sum in float32 and round once; the orders of
  the sums differ), dw, float32 from bfloat16 operands, within 1e-5
  relative (measured: forward equal but on 1e-4 of the elements, by one
  ulp; dx equal; dw 3e-7);
* ops and modules (``upsample2x``, ``VideoBatchNorm``, ``STConv``):
  within 2^-7 relative on 99.9% of the elements (measured: equal but
  2.4e-4 of STConv's elements, max-abs 2.4e-4);
* the ConvLSTM layer, a recurrence: the gate sums and activations are
  XLA's fused float32 evaluations rounded where XLA stores, so a one-ulp
  difference in a hidden or cell state feeds back through the steps
  (measured: 45% of the elements equal, 21% beyond 2^-7 where h crosses
  zero, max-abs 2.9e-3).  It is held to the noise criterion: the mean
  distance to JAX's bfloat16 at most twice JAX's own distance from its
  float32 (measured 0.69x);
* everywhere, the check against an error that is only scale: the port's
  bfloat16 output is no farther (mean absolute) from the port's float32
  output than twice JAX's bfloat16 is from JAX's float32 (measured
  0.5-1.3x).

Dtype placement is asserted as well: a BatchNorm computes in float32 and
returns bfloat16 with float32 running statistics, the ConvLSTM's gate
convs take bfloat16 inputs and weights cast to bfloat16 once per forward,
parameters stay float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfd_gan_tpu.models import layers as jlayers
from vfd_gan_tpu.models.convlstm import ConvLSTMLayer as JaxConvLSTMLayer
from vfd_gan_tpu.ops import resize as jresize
from vfd_gan_tpu.ops.pallas.spatial_conv import conv3x3_pallas
from vfd_gan_tpu_torch.models import convlstm, layers
from vfd_gan_tpu_torch.ops import resize
from vfd_gan_tpu_torch.ops.image import to_channel_first, to_channel_last
from vfd_gan_tpu_torch.ops.spatial_conv import conv3x3, conv3x3_plain
from vfd_gan_tpu_torch.utils import weights
from test_torch_port_threads import one_torch_thread  # noqa: F401

BF16 = torch.bfloat16
REL = 2.0 ** -7          # relative tolerance of the exact-rounding cases
SHARE = 1e-3             # ... which may miss it on this share of elements


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """The spacing of bfloat16 values at ``|v|`` (8 significant bits)."""
    _, e = np.frexp(np.abs(v).astype(np.float64))
    return np.ldexp(1.0, e - 8)


def _within_ulp(got, want, what: str) -> None:
    g, w = _np(got), _np(want)
    err = np.abs(g - w) / _bf16_ulp(np.maximum(np.abs(g), np.abs(w)))
    assert err.max() <= 1.0, (what, float(err.max()))


def _close_rel(got, want, what: str) -> float:
    """Within 2^-7 of ``|want|`` on all but ``SHARE`` of the elements;
    returns the max-abs error."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    err = np.abs(g - w)
    share = float((err > REL * np.abs(w)).mean())
    assert share <= SHARE, (what, share, float(err.max()))
    return float(err.max())


def _noise_close(got, want, want32, what: str) -> float:
    """The mean distance to JAX's bfloat16 at most twice JAX's own
    distance from its float32."""
    g, w, w32 = _np(got), _np(want), _np(want32)
    d, own = float(np.abs(g - w).mean()), float(np.abs(w - w32).mean())
    assert d <= 2 * own, (what, d, own)
    return d


def _scale_ok(got, got32, want, want32, what: str) -> None:
    """The port's bfloat16 no farther from its float32 than twice JAX's."""
    port = float(np.abs(_np(got) - _np(got32)).mean())
    jax_ = float(np.abs(_np(want) - _np(want32)).mean())
    assert port <= 2 * jax_, (what, port, jax_)


def _jax_init(module, *inputs, **kw):
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: module.init({"params": k, "dropout": k}, *inputs, **kw))(
            jax.random.key(0)))


# -- the conv kernel ------------------------------------------------------------

# (N, H, W, Cin, Cout): the ConvLSTM's first input half (packed taps), a
# hidden half and a 12-channel one (padded to 16), narrowed
CONV_CASES = {"packed3to64": (2, 8, 16, 3, 64), "16to48": (2, 8, 16, 16, 48),
              "12to48": (2, 8, 16, 12, 48)}


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv3x3_bf16_matches_pallas_kernel_and_vjp(case):
    n, h, w, cin, cout = CONV_CASES[case]
    rng = np.random.default_rng(cin)
    x = _np(jnp.asarray(rng.normal(size=(n, h, w, cin)), jnp.bfloat16))
    k = (rng.normal(size=(3, 3, cin, cout)) * 0.1).astype(np.float32)
    dy = _np(jnp.asarray(rng.normal(size=(n, h, w, cout)), jnp.bfloat16))
    want, vjp = jax.vjp(lambda a, b: conv3x3_pallas(a, b, True),
                        jnp.asarray(x, jnp.bfloat16), jnp.asarray(k))
    want_dx, want_dk = vjp(jnp.asarray(dy, jnp.bfloat16))
    assert want.dtype == want_dx.dtype == jnp.bfloat16
    assert want_dk.dtype == jnp.float32

    xt = _t(x).to(BF16).requires_grad_()
    kt = _t(k).requires_grad_()
    got = conv3x3(xt, kt)
    got.backward(_t(dy).to(BF16))
    assert got.dtype == xt.grad.dtype == BF16 and kt.grad.dtype == torch.float32
    _within_ulp(got, want, "forward")
    _within_ulp(xt.grad, want_dx, "dx")
    scale = float(np.abs(np.asarray(want_dk)).max())
    np.testing.assert_allclose(kt.grad.numpy(), np.asarray(want_dk),
                               rtol=1e-5, atol=1e-5 * scale)
    # the CPU path is the plain version: float32 sums of the bfloat16
    # operands, rounded once
    wb = _t(k).to(BF16)
    assert torch.equal(conv3x3_plain(xt.detach(), wb), torch.nn.functional.conv2d(
        xt.detach().float().permute(0, 3, 1, 2), wb.float().permute(3, 2, 0, 1),
        padding=1).permute(0, 2, 3, 1).to(BF16))


# -- ops and modules ------------------------------------------------------------

def test_upsample2x_bf16_rounds_per_axis_as_jax():
    x = np.random.default_rng(0).normal(size=(2, 4, 8, 6, 5)).astype(
        np.float32)
    want = jresize.upsample2x(jnp.asarray(x, jnp.bfloat16))
    want32 = jresize.upsample2x(jnp.asarray(x))
    got = resize.upsample2x(_t(x).to(BF16))
    assert got.dtype == BF16
    _close_rel(got, want, "upsample2x")
    _scale_ok(got, resize.upsample2x(_t(x)), want, want32, "upsample2x")
    # the spatial-only form of Xception's decoder
    _close_rel(resize.upsample2x(_t(x).to(BF16), (1, 2, 2)),
               jresize.upsample2x(jnp.asarray(x, jnp.bfloat16), (1, 2, 2)),
               "upsample2x (1, 2, 2)")


def test_upsample_matrix_cached_in_inference_mode_serves_a_backward():
    """The bfloat16 upsample's interpolation matrices are cached per
    device and dtype; one first made under ``torch.inference_mode`` (a
    served forward) must still serve a train step's backward."""
    resize._matrix_on.cache_clear()
    x = torch.randn((1, 2, 3, 4, 5)).to(BF16)
    with torch.inference_mode():
        resize.upsample_ncdhw(x)
    y = x.clone().requires_grad_()
    resize.upsample_ncdhw(y).float().sum().backward()
    assert y.grad is not None and y.grad.dtype == BF16


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
def test_video_batchnorm_bf16_matches_jax(train, in_dtype):
    """Statistics and normalisation in float32, the result bfloat16, from a
    float32 input (a net's first BatchNorm) or a bfloat16 one; running
    statistics float32."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(2, 4, 8, 8, 6)) * 3 + 1).astype(np.float32)
    jx = jnp.asarray(x) if in_dtype == "float32" else jnp.asarray(
        x, jnp.bfloat16)
    variables = _jax_init(jlayers.VideoBatchNorm(), jx, False)
    variables["params"]["BatchNorm_0"]["scale"] = rng.normal(
        1, 0.2, 6).astype(np.float32)
    variables["batch_stats"]["BatchNorm_0"]["mean"] = np.full(6, 0.5,
                                                              np.float32)
    variables["batch_stats"]["BatchNorm_0"]["var"] = np.full(6, 4.0,
                                                             np.float32)
    sd = {}
    weights._bn(sd, "bn", variables["params"], variables["batch_stats"])
    outs = {}
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, BF16)):
        module = jlayers.VideoBatchNorm(dtype=jdt)
        if train:
            want, mut = module.apply(variables, jx, True,
                                     mutable=["batch_stats"])
        else:
            want, mut = module.apply(variables, jx, False), variables
        bn = layers.VideoBatchNorm(6, dtype=tdt)
        bn.load_state_dict({k[3:]: torch.from_numpy(np.array(v))
                            for k, v in sd.items()}, strict=True)
        bn.train(train)
        # the float32 module reads a bfloat16 input widened, as JAX's
        # float32 module promotes it
        xt = _t(x) if in_dtype == "float32" else _t(x).to(BF16)
        if in_dtype == "bfloat16" and tdt == torch.float32:
            xt = xt.float()
        with torch.no_grad():
            got = to_channel_last(bn(to_channel_first(xt)))
        outs[tdt] = (got, want)
        assert got.dtype == tdt and want.dtype == jdt
        stats = mut["batch_stats"]["BatchNorm_0"]
        assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32
        np.testing.assert_allclose(bn.running_mean.numpy(), stats["mean"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(), stats["var"],
                                   rtol=1e-5, atol=1e-6)
    (got, want), (got32, want32) = outs[BF16], outs[torch.float32]
    _close_rel(got, want, "VideoBatchNorm")
    _scale_ok(got, got32, want, want32, "VideoBatchNorm")


def test_stconv_bf16_matches_jax():
    """A (2+1)D conv in train mode: its spatial conv takes the float32
    input as it is (float32, its bias float32), its mid BatchNorm returns
    bfloat16, the temporal conv runs in bfloat16 and its bias is added in
    float32."""
    x = np.random.default_rng(2).uniform(-1, 1, (2, 4, 8, 8, 3)).astype(
        np.float32)
    variables = _jax_init(jlayers.STConv(8, padding=(1, 1, 1)), jnp.asarray(x),
                          False)
    p, s = variables["params"], variables["batch_stats"]
    sd = {"spatial_conv.weight": weights._spatial(p["spatial_kernel"]),
          "spatial_conv.bias": p["spatial_bias"],
          "temporal_conv.weight": weights._temporal(p["temporal_kernel"]),
          "temporal_conv.bias": p["temporal_bias"]}
    weights._bn(sd, "bn", p["mid_bn"], s["mid_bn"])
    outs, seen = {}, []
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, BF16)):
        want = jlayers.STConv(8, padding=(1, 1, 1), dtype=jdt).apply(
            variables, jnp.asarray(x), True, mutable=["batch_stats"])[0]
        module = layers.STConv(3, 8, padding=(1, 1, 1), dtype=tdt)
        module.load_state_dict({k: torch.from_numpy(np.array(v))
                                for k, v in sd.items()}, strict=True)
        hooks = [m.register_forward_hook(
            lambda m, i, o: seen.append((i[0].dtype, o.dtype)))
            for m in (module.spatial_conv, module.bn, module.temporal_conv)]
        with torch.no_grad():
            got = to_channel_last(module.train()(to_channel_first(_t(x))))
        for hook in hooks:
            hook.remove()
        outs[tdt] = (got, want)
    assert seen[3:] == [(torch.float32, torch.float32),
                        (torch.float32, BF16), (BF16, torch.float32)]
    (got, want), (got32, want32) = outs[BF16], outs[torch.float32]
    # the temporal conv's biased sum is left float32 for the BatchNorm that
    # reads it (layers.Conv3d); JAX's module output is that sum rounded
    assert got.dtype == torch.float32 and want.dtype == jnp.bfloat16
    got = got.to(BF16)
    _close_rel(got, want, "STConv")
    _scale_ok(got, got32, want, want32, "STConv")


def test_convlstm_layer_bf16_matches_jax(monkeypatch):
    """The recurrence in bfloat16: the input cast to it, every hidden state
    that enters a gate conv bfloat16, so is the cell state (a float32
    cell state would make the next hidden state float32)."""
    x = np.random.default_rng(3).uniform(-1, 1, (2, 4, 16, 16, 3)).astype(
        np.float32)
    variables = _jax_init(JaxConvLSTMLayer(16), jnp.asarray(x))
    kernel = np.asarray(variables["params"]["gate_kernel"])
    seen = []

    def recording(a, w):
        seen.append((a.dtype, w.dtype))
        return conv3x3(a, w)

    monkeypatch.setattr(convlstm, "conv3x3", recording)
    outs = {}
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, BF16)):
        want = JaxConvLSTMLayer(16, dtype=jdt).apply(variables,
                                                     jnp.asarray(x))
        layer = convlstm.ConvLSTMLayer(3, 16, dtype=tdt)
        layer.cell_list[0].conv.weight.data = torch.from_numpy(
            kernel.transpose(3, 2, 0, 1).copy())
        with torch.no_grad():
            outs[tdt] = (layer(_t(x)), want)
    # 1 input half + 4 hidden halves per dtype; the float32 weights, which
    # conv3x3 casts to the input's dtype for its products (their
    # gradients come back float32 and add up unrounded)
    assert seen[:5] == [(torch.float32, torch.float32)] * 5
    assert seen[5:] == [(BF16, torch.float32)] * 5
    (got, want), (got32, want32) = outs[BF16], outs[torch.float32]
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    _noise_close(got, want, want32, "ConvLSTMLayer")
    _scale_ok(got, got32, want, want32, "ConvLSTMLayer")
