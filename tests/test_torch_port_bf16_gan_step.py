"""One bfloat16 ``_gan_core`` step of MyGAN and of its ``--ae`` form
against the JAX package's on the CPU: the float32 steps of
``tests/test_torch_port_train.py`` and ``tests/test_torch_port_sweep_options.py``
(their sizes, inputs and injected flows) with ``compute_dtype bfloat16``,
the trainer's default, on both sides.  Tolerances are
``tests/test_torch_port_bf16_step.py``'s: losses within 1e-2 relative
(the spatial feature-matching loss 5e-2), every updated parameter within
2.5 lr, both float32; G's and D's gradients (Adam's first moment) by
their median parameter and as a whole, against a control on the clip
reversed in time and mirrored; running means and variances within
2e-2 as a whole.

The weights come from the float32 modules' init at those tests' shapes:
the parameters and statistics are float32 whatever the compute dtype, and
the same init programs are then compiled once per test run.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_bf16_step import (
    _identity_dropout,
    _losses_close,
    _params_close,
    _stats_close,
    jax_moments,
    moments_close,
)
from tests.test_torch_port_supervised import _np_tree
from tests.test_torch_port_sweep_options import _jax_engine
from tests.test_torch_port_train import NDF, NGF, B, S, T, _jax_init, _load, _t
from vfd_gan_tpu.config import Config as JaxConfig
from vfd_gan_tpu.models.mygan import DualDisc as JaxDualDisc
from vfd_gan_tpu.models.mygan import Generator as JaxGenerator
from vfd_gan_tpu.models.stcnn import AutoEncoder as JaxAutoEncoder
from vfd_gan_tpu.train.state import NetState as JaxNetState
from vfd_gan_tpu_torch.config import Config
from vfd_gan_tpu_torch.train.gan_engine import MyGanEngine
from vfd_gan_tpu_torch.utils.weights import (
    autoencoder_state_dict,
    dualdisc_state_dict,
    generator_state_dict,
)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("ae", [False, True], ids=["mygan", "ae"])
def test_gan_core_bf16_step_matches_jax(tmp_path, monkeypatch, ae):
    """One ``_gan_core`` step of MyGAN (b2, ngf = ndf = 4) and of its
    ``--ae`` form (b1, the AutoEncoder as G) in bfloat16, from the same
    bridged weights and injected flows."""
    monkeypatch.setattr(fnn.Dropout, "__call__", _identity_dropout)
    kw = dict(model="mygan", isize=S, nfr=T, batchsize=B, ngf=NGF, ndf=NDF,
              ep=1, tensorboard=False, result_root=str(tmp_path), ae=ae)
    cfg = JaxConfig(**kw).validate()
    assert cfg.compute_dtype == "bfloat16"          # the default
    b = 1 if ae else B
    rng = np.random.default_rng(8 if ae else 5)
    data = rng.uniform(-1, 1, (b, T, S, S, 3)).astype(np.float32)
    gt = (rng.uniform(size=(b, T, S, S, 1)) > 0.85).astype(np.float32)
    flows = rng.uniform(-1, 1, (2 * b, T, S, S, 3)).astype(np.float32)

    def netg(dtype):
        return JaxAutoEncoder(dtype=dtype) if ae else JaxGenerator(
            ngf=NGF, dtype=dtype, drop_rate=0.0)

    x = jnp.zeros((b, T, S, S, 3), jnp.float32)
    g_vars = _jax_init(netg(jnp.float32), x)
    d_vars = _jax_init(JaxDualDisc(ndf=NDF, dtype=jnp.float32), x, x)
    jeng = _jax_engine(cfg, netg(jnp.bfloat16), flows)
    jeng.netd = JaxDualDisc(ndf=NDF, dtype=jnp.bfloat16)
    g_state, d_state, want, _ = jax.jit(jeng._gan_core)(
        JaxNetState.create(g_vars, jeng.tx_g),
        JaxNetState.create(d_vars, jeng.tx_d), jnp.asarray(data),
        jnp.asarray(gt), jax.random.key(0))

    g_bridge = autoencoder_state_dict if ae else generator_state_dict

    def port_step(clip):
        port = MyGanEngine(Config(**kw).validate(), None, None,
                           device=torch.device("cpu"))
        _load(port.netg, g_bridge(g_vars))
        _load(port.netd, dualdisc_state_dict(d_vars))
        for m in port.netg.modules():
            if hasattr(m, "drop_rate"):
                m.drop_rate = 0.0
        port._flow = lambda v, streams=1: _t(flows)
        got = port._gan_core(_t(clip), _t(gt),
                             torch.Generator().manual_seed(0))
        return port, got

    # the control: the same step on the clip reversed in time and mirrored
    control, _ = port_step(data[:, ::-1, :, ::-1].copy())
    port, got = port_step(data)

    _losses_close(got, want)
    _params_close(port.netg.state_dict(),
                  g_bridge(_np_tree(g_state.variables())))
    _params_close(port.netd.state_dict(),
                  dualdisc_state_dict(_np_tree(d_state.variables())))
    tag = "_ae" if ae else ""
    moments_close(port.g, jax_moments(g_state, g_bridge), control.g,
                  "netg" + tag)
    moments_close(port.d, jax_moments(d_state, dualdisc_state_dict),
                  control.d, "netd" + tag)
    _stats_close(port.netg.state_dict(),
                 g_bridge(_np_tree(g_state.variables())))
    _stats_close(port.netd.state_dict(),
                 dualdisc_state_dict(_np_tree(d_state.variables())))
