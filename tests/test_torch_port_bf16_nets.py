"""The four nets' bfloat16 forwards against the JAX package's on the CPU,
in eval and train mode, and where their dtypes sit.  Inputs, helpers and
tolerances are ``tests/test_torch_port_bf16.py``'s: within 2^-7 relative
on 99.9% of the elements and no farther from the port's float32 than twice
JAX's bfloat16 is from JAX's float32.  The port's float32 output stands
for JAX's float32 (the float32 parity tests hold the two within 1e-5), so
JAX compiles each net once, in bfloat16.

One case is held to the noise criterion instead (the mean distance to
JAX's bfloat16 at most twice JAX's own distance from its float32): the
AutoEncoder in train mode, whose forward no second implementation can
hold to 2^-7.  Its train-mode BatchNorms at this size normalise a few
elements per channel at the bottleneck, so a one-ulp difference anywhere
moves most outputs: the port's own bfloat16 forward with each conv's sums
taken in float64 instead of float32 (each still rounded once, as valid a
bfloat16 conv) is beyond 2^-7 of it on 71% of the elements (measured, and
asserted here as the control), as the port is of JAX's on 64%.  The same
control moves Xception's train forward on 57% of the elements; its
float32 sums happen to round as XLA's do at this size, and it is held to
2^-7.  The other nets' train-mode outputs meet 2^-7 (at most 0.07% of the
elements beyond), their eval outputs all of them.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_bf16 import (
    BF16,
    REL,
    SHARE,
    _close_rel,
    _jax_init,
    _noise_close,
    _scale_ok,
    _t,
)
from vfd_gan_tpu.models.convlstm import ConvLSTMModel as JaxConvLSTMModel
from vfd_gan_tpu.models.mygan import Generator as JaxGenerator
from vfd_gan_tpu.models.stcnn import AutoEncoder as JaxAutoEncoder
from vfd_gan_tpu.models.xception3d import Xception3D as JaxXception3D
from vfd_gan_tpu_torch.models import layers
from vfd_gan_tpu_torch.models.convlstm import ConvLSTMModel
from vfd_gan_tpu_torch.models.mygan import Generator
from vfd_gan_tpu_torch.models.stcnn import AutoEncoder
from vfd_gan_tpu_torch.models.xception3d import Xception3D
from vfd_gan_tpu_torch.ops.image import to_channel_first, to_channel_last
from vfd_gan_tpu_torch.utils import weights


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# family -> (JAX net of a dtype, port net of a dtype, weight bridge,
# (B, T, H=W)).  Tiny: ngf 2, Xception at width 1/16.
NETS = {
    "mygan": (lambda d: JaxGenerator(ngf=2, dtype=d, drop_rate=0.0),
              lambda d: Generator(2, drop_rate=0.0, dtype=d),
              weights.generator_state_dict, (2, 16, 32)),
    "clstm": (lambda d: JaxConvLSTMModel(dtype=d),
              lambda d: ConvLSTMModel(dtype=d),
              weights.convlstm_state_dict, (2, 4, 16)),
    "c2plus1d": (lambda d: JaxAutoEncoder(dtype=d),
                 lambda d: AutoEncoder(drop_rate=0.0, dtype=d),
                 weights.autoencoder_state_dict, (2, 16, 16)),
    "xception": (lambda d: JaxXception3D(dtype=d, width_mult=1 / 16),
                 lambda d: Xception3D(3, 1 / 16, drop_rate=0.0, dtype=d),
                 weights.xception_state_dict, (2, 2, 32)),
}
# held to the noise criterion, not to 2^-7 (module docstring)
NOISE_CASES = {("c2plus1d", True)}


def _identity_dropout(self, inputs, *args, **kwargs):
    return inputs


@functools.lru_cache(maxsize=None)
def _jax_outputs(family: str):
    """The clip, the bridged state dict and JAX's bfloat16 outputs by
    ``train``, the eval and train forwards in one jit."""
    jax_net, _, bridge, (b, t, s) = NETS[family]
    x = np.random.default_rng(4).uniform(-1, 1, (b, t, s, s, 3)).astype(
        np.float32)
    variables = _jax_init(jax_net(jnp.float32), jnp.asarray(x), False)
    net = jax_net(jnp.bfloat16)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", _identity_dropout)
        evals, trains = jax.jit(lambda v, a: (
            net.apply(v, a, False),
            net.apply(v, a, True, mutable=["batch_stats"])[0]))(
                variables, x)
    assert evals.dtype == trains.dtype == jnp.float32
    return x, bridge(variables), {False: np.asarray(evals),
                                  True: np.asarray(trains)}


_CONV_FORWARD = layers.Conv3d._conv_forward


def _conv_forward_f64(self, x, w, b):
    """``Conv3d``'s float32 sums taken in float64 (and rounded to float32)."""
    if x.dtype != torch.float32:
        return _CONV_FORWARD(self, x, w, b)
    return _CONV_FORWARD(self, x.double(), w.double(),
                         None if b is None else b.double()).float()


def _first_conv(model: torch.nn.Module):
    if isinstance(model, ConvLSTMModel):
        return None
    return next(m for m in model.modules() if isinstance(m, layers.Conv3d))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("family", list(NETS))
def test_net_forward_bf16_matches_jax(family, train):
    """Each net's bfloat16 forward against JAX's, and where the dtypes
    sit: the first conv takes the float32 clip, the first BatchNorm
    returns bfloat16, the mask is float32, the parameters stay float32."""
    _, port_net, _, _ = NETS[family]
    x, sd, want = _jax_outputs(family)
    outs = {}
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, BF16)):
        model = port_net(tdt)
        model.load_state_dict({k: torch.from_numpy(np.array(v))
                               for k, v in sd.items()}, strict=True)
        model.train(train)
        seen = {}

        def note(key, dtype):
            seen.setdefault(key, dtype)     # the first call's; returns None

        bn = next(m for m in model.modules()
                  if isinstance(m, layers.VideoBatchNorm))
        hooks = [bn.register_forward_hook(lambda m, i, o: note("bn",
                                                               o.dtype))]
        conv = _first_conv(model)
        if conv is not None:
            hooks.append(conv.register_forward_hook(
                lambda m, i, o: note("conv", i[0].dtype)))
        with torch.no_grad():
            got = to_channel_last(model(to_channel_first(_t(x))))
        for hook in hooks:
            hook.remove()
        assert got.dtype == torch.float32
        assert all(p.dtype == torch.float32 for p in model.parameters())
        assert seen["bn"] == tdt
        assert seen.get("conv", torch.float32) == torch.float32
        outs[tdt] = got
    # the port's float32 output stands for JAX's: the float32 parity tests
    # hold the two within 1e-5 (test_torch_port_generator.py and
    # test_torch_port_supervised.py), far inside any bfloat16 distance
    got, got32 = outs[BF16], outs[torch.float32]
    w, w32 = want[train], got32
    if (family, train) in NOISE_CASES:
        _noise_close(got, w, w32, family)
        # the control: float64 conv sums move the port's own forward
        # beyond 2^-7 of itself
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(layers.Conv3d, "_conv_forward", _conv_forward_f64)
            model = port_net(BF16)
            model.load_state_dict({k: torch.from_numpy(np.array(v))
                                   for k, v in sd.items()}, strict=True)
            with torch.no_grad():
                got64 = to_channel_last(model.train(train)(
                    to_channel_first(_t(x))))
        a, b = got64.float().numpy(), got.float().numpy()
        assert (np.abs(a - b) > REL * np.abs(b)).mean() > SHARE
    else:
        _close_rel(got, w, family)
    _scale_ok(got, got32, w, w32, family)
