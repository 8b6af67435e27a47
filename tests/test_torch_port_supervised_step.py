"""One ``SupervisedEngine`` train step per family against the JAX
engine's ``_train_step_impl`` on the CPU: augment with the same draws
injected into both, the train-mode forward, bce, backward and one Adam
step, from the same bridged weights.  Sizes and the shared helpers are
``tests/test_torch_port_supervised.py``'s.

Tolerances: the loss 1e-5, BN running statistics 1e-5, and the updated
parameters as ``tests/test_torch_port_train.py`` holds them: Adam's first
step moves a weight by ~lr whatever its gradient's size, so where the
true gradient is ~0 float noise can flip its sign; every element is held
to 2.5 lr and at most 2% of them may differ by more than 5e-6.

JAX's dropout cannot be switched off (a fixed ``nn.Dropout(0.25)`` in the
AutoEncoder's up blocks and Xception's decoder): the port runs
``drop_rate=0``, flax's ``Dropout`` is patched to return its input, and
the test asserts that the patch took effect (two dropout keys, one
output).  The ConvLSTM has no dropout.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_supervised import (
    ATOL,
    BRIDGES,
    LR,
    SIZES,
    _cfgs,
    _jax_model_and_vars,
    _np_tree,
)
from vfd_gan_tpu.ops import augment as jaug
from vfd_gan_tpu.train.state import NetState as JaxNetState
from vfd_gan_tpu.train.state import make_adam
from vfd_gan_tpu.train.supervised_engine import (
    SupervisedEngine as JaxSupervisedEngine,
)
from vfd_gan_tpu_torch.ops import augment
from vfd_gan_tpu_torch.train import supervised_engine
from vfd_gan_tpu_torch.train.supervised_engine import SupervisedEngine
from test_torch_port_threads import one_torch_thread  # noqa: F401


def _identity_dropout(self, inputs, *args, **kwargs):
    return inputs


def _step_parity(got: dict, want: dict) -> None:
    """Every updated parameter within the sign-flip envelope of Adam's
    first step, and at most 2% beyond 5e-6."""
    total = loose = 0
    for k, v in want.items():
        if "running" in k or k.endswith("num_batches_tracked"):
            continue
        d = np.abs(got[k].detach().numpy() - v)
        assert d.max() <= 2.5 * LR, (k, float(d.max()))
        total += d.size
        loose += int((d > 5e-6).sum())
    assert total and loose / total < 0.02, (loose, total)


@pytest.mark.parametrize("family", list(BRIDGES))
def test_supervised_step_matches_jax(family, tmp_path, monkeypatch):
    jcfg, cfg = _cfgs(family, tmp_path)
    b, t, isize, _ = SIZES[family]
    s = augment.staging_size(isize)
    rng = np.random.default_rng(4)
    data = rng.integers(0, 256, (b, t, s, s, 3), dtype=np.uint8)
    mask = np.zeros((b, t, s, s, 1), np.uint8)
    mask[:, :, 4:s - 4, 5:s - 6] = 255
    batch = {"data": data, "real": data, "mask": mask}
    draws = (np.linspace(-0.17, 0.15, b).astype(np.float32),
             np.arange(b, dtype=np.int32) % 2, np.ones(b, np.int32),
             np.arange(b) % 2 == 0)

    # JAX: its engine's step, without the mesh and init its constructor
    # builds, on injected draws, with flax's Dropout made the identity
    monkeypatch.setattr(fnn.Dropout, "__call__", _identity_dropout)
    monkeypatch.setattr(jaug, "sample_clip_params",
                        lambda *a, **k: tuple(map(jnp.asarray, draws)))
    model, variables = _jax_model_and_vars(family)
    jeng = object.__new__(JaxSupervisedEngine)
    jeng.cfg, jeng.model, jeng.pipe = jcfg, model, None
    jeng.tx = make_adam(jcfg.lr, jcfg.beta1)
    x = jnp.asarray(rng.uniform(-1, 1, (b, t, isize, isize, 3)), jnp.float32)
    outs = [model.apply(variables, x, True, mutable=["batch_stats"],
                        rngs={"dropout": jax.random.key(k)})[0]
            for k in (1, 2)]
    np.testing.assert_array_equal(np.asarray(outs[0]), np.asarray(outs[1]))
    state, loss, _ = jax.jit(jeng._train_step_impl, static_argnums=(3,))(
        JaxNetState.create(variables, jeng.tx),
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(0),
        True)

    # the port: its engine's step on the same draws, at drop_rate 0
    monkeypatch.setattr(supervised_engine, "sample_clip_params",
                        lambda *a, **k: (torch.from_numpy(draws[0]),
                                         torch.from_numpy(draws[1]).long(),
                                         torch.from_numpy(draws[2]).long(),
                                         torch.from_numpy(draws[3])))
    eng = SupervisedEngine(cfg, None, None, device=torch.device("cpu"))
    bridge = BRIDGES[family][0]
    eng.model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                               bridge(variables).items()}, strict=True)
    for m in eng.model.modules():
        if hasattr(m, "drop_rate"):
            m.drop_rate = 0.0
    got = eng._train_step_impl({k: torch.from_numpy(v)
                                for k, v in batch.items()})

    np.testing.assert_allclose(float(got["loss/err/train"]), float(loss),
                               rtol=0, atol=ATOL)
    new = bridge(_np_tree(state.variables()))
    sd = eng.model.state_dict()
    _step_parity(sd, new)
    for k, v in new.items():
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), v, rtol=0, atol=ATOL,
                                       err_msg=k)
    moved = max(np.abs(sd[k].numpy() - v).max() for k, v in
                bridge(variables).items() if k.endswith("weight"))
    assert 0.5 * LR < moved < 2 * LR
