"""The port's bfloat16 backward against the JAX package's on the CPU: the
modules whose backward a bfloat16 train step runs, in train mode, and each
net's parameter gradient in eval mode.  The train steps' own gradients are
``tests/test_torch_port_bf16_step.py``'s and ``_bf16_gan_step.py``'s.

Each case takes the gradient of ``sum(out * r)`` (``r`` a fixed draw) with
respect to every parameter and the input, in bfloat16 on both sides with
float32 parameters, and measures each gradient's relative L2 distance from
JAX's.  The control is the port's float32 gradient, held to the same JAX
bfloat16 gradient.

Two bounds, from these readings (CPU, two torch threads):

* exact: where the port rounds where JAX does, the distance is at most
  ``EXACT`` (1e-4) and the control misses it: a BatchNorm's scale and
  shift (measured at most 7.1e-7 against a control of 1.3e-3) and its
  input gradient from a float32 input (2.3e-7 / 1.6e-3); the bfloat16
  temporal conv's weight, cast from float32 (3.8e-6 / 2.7e-3);
  ``TorchLinear``'s weight and input (0 / 2.7e-3 and 3.4e-3); the
  upsample's input (0 / 4.0e-3);
* noise: every other gradient no farther from JAX's than ``NOISE`` (1.5)
  times the control.  There a bfloat16 rounding of a sum whose order
  differs, or a kink of the activation at a rounded value, decides the
  difference, as it decides JAX's own float32-vs-bfloat16 distance
  (measured ratios at most 1.06: a BatchNorm's input gradient from a
  bfloat16 input, a bias that a train-mode BatchNorm reads, whose exact
  gradient is 0, the discriminator block's gradients at 5-9%).  A zero,
  stale or misrouted gradient is at distance 1 or more and fails it.

Each net's eval-mode gradients: all of them together within ``NOISE``
times the control (measured 0.81-1.01), each parameter's within
``LEAF_NOISE`` (5) times its own (measured at most 4.3, c2plus1d's first
BatchNorm shift, a sum that cancels; median ratios 0.19-0.97).  A
train-mode step of MyGAN's discriminator is noise-dominated at a test's
size (``_bf16_step.py``); eval mode, where no BatchNorm divides by a
batch's spread, is where the backward through every layer of each net is
compared closely.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_bf16 import BF16, _jax_init, _t
from tests.test_torch_port_bf16_nets import NETS
from vfd_gan_tpu.models import layers as jlayers
from vfd_gan_tpu.ops import resize as jresize
from vfd_gan_tpu_torch.models import layers
from vfd_gan_tpu_torch.ops import resize
from vfd_gan_tpu_torch.ops.image import to_channel_first, to_channel_last
from vfd_gan_tpu_torch.utils import weights
from test_torch_port_threads import one_torch_thread  # noqa: F401

EXACT = 1e-4
NOISE = 1.5
LEAF_NOISE = 5.0


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _jax_grads(module, variables, x, train: bool, r, bridge) -> dict:
    """JAX's gradients of ``sum(out * r)`` by the port's names, ``"x"`` the
    input's."""
    stats = variables.get("batch_stats", {})

    def loss(p, a):
        v = {"params": p, "batch_stats": stats}
        out = (module.apply(v, a, True, mutable=["batch_stats"])[0] if train
               else module.apply(v, a, False))
        return jnp.sum(out.astype(jnp.float32) * r)

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(variables["params"], x)
    out = {k: v for k, v in bridge({
        "params": jax.tree_util.tree_map(np.asarray, gp),
        "batch_stats": stats}).items()
        if "running" not in k and "num_batches" not in k}
    out["x"] = np.asarray(gx.astype(jnp.float32))
    return out


def _port_grads(module, sd, x: torch.Tensor, train: bool, r,
                layout=True) -> dict:
    module.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in sd.items()}, strict=True)
    module.train(train)
    x = x.clone().requires_grad_()
    out = module(to_channel_first(x)) if layout else module(x)
    out = to_channel_last(out) if layout else out
    (out.float() * _t(r)).sum().backward()
    got = {k: p.grad.float().numpy() for k, p in module.named_parameters()}
    got["x"] = x.grad.float().numpy()
    return got


def _whole(grads: dict, want: dict) -> float:
    """The relative L2 distance of all gradients together."""
    ks = sorted(want)
    return _rel(np.concatenate([grads[k].ravel() for k in ks]),
                np.concatenate([want[k].ravel() for k in ks]))


def _grads_close(got: dict, control: dict, want: dict, exact: set,
                 what: str, leaf: float = NOISE) -> None:
    """Each gradient in ``exact`` within EXACT, where the control misses
    it; every other one within ``leaf`` times the control's distance; all
    of them together within NOISE times the control's."""
    assert set(got) == set(want), what
    for k in want:
        d, c = _rel(got[k], want[k]), _rel(control[k], want[k])
        if k in exact:
            assert d <= EXACT < c, (what, k, d, c)
        else:
            assert d <= leaf * c, (what, k, d, c)
    d, c = _whole(got, want), _whole(control, want)
    assert d <= NOISE * c, (what, d, c)


# -- modules ---------------------------------------------------------------------

def _bn_sd(v):
    sd = {}
    weights._bn(sd, "bn", v["params"], v["batch_stats"])
    return {k[3:]: a for k, a in sd.items()}


def _stconv_sd(v):
    p, s = v["params"], v["batch_stats"]
    sd = {"spatial_conv.weight": weights._spatial(p["spatial_kernel"]),
          "spatial_conv.bias": p["spatial_bias"],
          "temporal_conv.weight": weights._temporal(p["temporal_kernel"]),
          "temporal_conv.bias": p["temporal_bias"]}
    weights._bn(sd, "bn", p["mid_bn"], s["mid_bn"])
    return sd


def _block_sd(v):
    sd = {}
    weights._gen_block(sd, "b", v["params"], v["batch_stats"])
    return {k[2:]: a for k, a in sd.items()}


def _linear_sd(v):
    p = v["params"]["linear"]["Dense_0"]
    return {"weight": weights.linear_to_torch(p["kernel"]),
            "bias": np.asarray(p["bias"])}


class _JaxLinear(fnn.Module):
    """``TorchLinear`` with the modules' call signature."""

    dtype: object = jnp.float32

    @fnn.compact
    def __call__(self, x, train=False):
        return jlayers.TorchLinear(3, dtype=self.dtype, name="linear")(x)


class _JaxUpsample(fnn.Module):
    """``upsample2x`` as a module without parameters."""

    @fnn.compact
    def __call__(self, x, train=False):
        return jresize.upsample2x(x)


class _Upsample(torch.nn.Module):
    def forward(self, x):
        return resize.upsample2x(x)


def _normal(shape, seed, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            + shift).astype(np.float32)


# case -> (JAX module of a dtype, port module of a dtype, bridge, input,
# input in bfloat16, train mode, NCDHW layout, the exact gradients)
MODULES = {
    "batchnorm_bf16_in": (
        lambda d: jlayers.VideoBatchNorm(dtype=d),
        lambda d: layers.VideoBatchNorm(6, dtype=d), _bn_sd,
        _normal((2, 4, 8, 8, 6), 1, 3.0, 1.0), True, True, True,
        {"weight", "bias"}),
    "batchnorm_f32_in": (
        lambda d: jlayers.VideoBatchNorm(dtype=d),
        lambda d: layers.VideoBatchNorm(6, dtype=d), _bn_sd,
        _normal((2, 4, 8, 8, 6), 1, 3.0, 1.0), False, True, True,
        {"weight", "bias", "x"}),
    "stconv": (
        lambda d: jlayers.STConv(8, padding=(1, 1, 1), dtype=d),
        lambda d: layers.STConv(3, 8, padding=(1, 1, 1), dtype=d),
        _stconv_sd, np.random.default_rng(2).uniform(
            -1, 1, (2, 4, 8, 8, 3)).astype(np.float32), False, True, True,
        {"temporal_conv.weight"}),
    "disc_block": (
        lambda d: jlayers.DiscConvBlock(8, dtype=d),
        lambda d: layers.DiscConvBlock(6, 8, (3, 3, 3), (1, 1, 1), dtype=d),
        _block_sd, _normal((2, 4, 8, 8, 6), 3), True, True, True, set()),
    "linear": (
        lambda d: _JaxLinear(dtype=d),
        lambda d: layers.TorchLinear(40, 3, dtype=d), _linear_sd,
        _normal((4, 40), 6), True, None, False, {"weight", "x"}),
    "upsample": (
        lambda d: _JaxUpsample(), lambda d: _Upsample(), lambda v: {},
        _normal((2, 4, 8, 6, 5), 0), True, None, False, {"x"}),
}


@pytest.mark.parametrize("case", list(MODULES))
def test_module_bf16_vjp_matches_jax(case):
    """A module's bfloat16 backward (train mode where it has one) against
    JAX's: the mixed-dtype BatchNorm, the weight casts, ``TorchLinear``
    and the per-axis upsample."""
    jmod, pmod, bridge, x, in_bf16, train, layout, exact = MODULES[case]
    jx = jnp.asarray(x, jnp.bfloat16) if in_bf16 else jnp.asarray(x)
    variables = dict(_jax_init(jmod(jnp.float32), jx, False))
    variables.setdefault("params", {})
    module = jmod(jnp.bfloat16)
    out = module.apply(variables, jx, bool(train),
                       mutable=["batch_stats"])[0] if train else \
        module.apply(variables, jx, False)
    r = _normal(out.shape, 9)
    want = _jax_grads(module, variables, jx, bool(train), r, bridge)
    sd = bridge(variables)
    got = _port_grads(pmod(BF16), sd, _t(x).to(BF16) if in_bf16 else _t(x),
                      bool(train), r, layout)
    control = _port_grads(pmod(torch.float32), sd, _t(x), bool(train), r,
                          layout)
    _grads_close(got, control, want, exact, case)


# -- nets -------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _net_case(family: str):
    jax_net, _, bridge, (b, t, s) = NETS[family]
    x = np.random.default_rng(4).uniform(-1, 1, (b, t, s, s, 3)).astype(
        np.float32)
    variables = _jax_init(jax_net(jnp.float32), jnp.asarray(x), False)
    r = np.random.default_rng(5).uniform(-1, 1, (b, t, s, s, 1)).astype(
        np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, a, *k, **kw: a)
        want = _jax_grads(jax_net(jnp.bfloat16), variables, jnp.asarray(x),
                          False, r, bridge)
    return x, r, bridge(variables), want


@pytest.mark.parametrize("family", list(NETS))
def test_net_eval_bf16_gradients_match_jax(family):
    """Each net's bfloat16 parameter and input gradients in eval mode
    against JAX's: all together within NOISE times the control's distance,
    each within LEAF_NOISE times its own."""
    _, port_net, _, _ = NETS[family]
    x, r, sd, want = _net_case(family)
    got = _port_grads(port_net(BF16), sd, _t(x), False, r)
    control = _port_grads(port_net(torch.float32), sd, _t(x), False, r)
    _grads_close(got, control, want, set(), family, LEAF_NOISE)
