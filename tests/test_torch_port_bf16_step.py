"""One bfloat16 train step of each supervised family against the JAX
package's on the CPU, and the trainer's default command line.  MyGAN's
steps are ``tests/test_torch_port_bf16_gan_step.py``'s, under the same
tolerances (``_losses_close``, ``_params_close``, ``moments_close``,
``_stats_close``).

The steps are those of ``tests/test_torch_port_supervised_step.py``, with
its draws and sizes (but c2plus1d's, 32^2 here), run with ``compute_dtype
bfloat16`` on both sides: the nets in bfloat16, their parameters and
Adam's state float32.  flax's ``Dropout`` is patched to the identity and
the port runs ``drop_rate=0``.

Tolerances.  Every loss within 1e-2 relative of JAX's (bfloat16 keeps 8
significant bits; a train-mode BatchNorm amplifies a one-ulp difference,
see ``tests/test_torch_port_bf16_nets.py``; measured at most 3.2e-3),
but the spatial feature-matching loss (``g/err_g_adv_s`` and the
``g/err_g_adv`` that holds it), an L2 distance between the deepest
train-mode spatial features and the most amplified value, as the float32
tests single it out (``tests/test_torch_port_sweep_options.py``): 5e-2
(measured 8.8e-4 for MyGAN, 1.2e-2 for ``--ae``); every updated parameter
within Adam's first-step envelope of 2.5 lr.  The losses are float32 and
the parameters stay float32.

The gradient itself is read from Adam's first moment after the step,
``(1 - beta1) g`` on both sides (torch ``exp_avg``, optax ``mu``).  Each
net's median parameter and its whole gradient are held within
``GRAD_RTOL`` (relative L2) of JAX's; the control, the same step on the
clip reversed in time and mirrored, must miss it on the median, as a
zero, stale or misrouted gradient does (distance 1).  Readings (median /
whole; control median): clstm 0.0085 / 0.0099 (1.04); c2plus1d 0.13 /
0.13 (1.06); xception 0.30 / 0.33 (1.54); MyGAN G 0.23 / 0.033, D 0.42 /
0.59; ``--ae`` G 0.12 / 0.045, D 0.43 / 0.52 (controls 1.0).  The worst
parameter is not the measure: a bias that a train-mode BatchNorm reads
has an exact gradient of 0, so both sides hold rounding noise there (at
most 15x that leaf's norm apart).  In a train-mode step a BatchNorm
divides by a batch's spread, so a one-ulp difference moves the whole
gradient: c2plus1d at 16^2 measured 1.08 (the port's own float32 step
1.2 from JAX's bfloat16), hence 32^2 here; the discriminators stay at
0.4-0.6 and their modules are held tighter in
``tests/test_torch_port_bf16_grads.py``.  The running means, and the
running variances, within ``STATS_RTOL`` (2e-2) as a whole (measured at
most 4.6e-3 for any one BatchNorm against JAX; one deep Xception mean,
near 0, was 8% off on the card against the CPU, so no single statistic
is the measure).
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_supervised import (
    BRIDGES,
    SIZES,
    _cfgs,
    _jax_model_and_vars,
    _np_tree,
)
from vfd_gan_tpu.models import build_mask_model as jax_build
from vfd_gan_tpu.ops import augment as jaug
from vfd_gan_tpu.train.state import NetState as JaxNetState
from vfd_gan_tpu.train.state import make_adam
from vfd_gan_tpu.train.supervised_engine import (
    SupervisedEngine as JaxSupervisedEngine,
)
from vfd_gan_tpu_torch.cli import trainer
from vfd_gan_tpu_torch.config import Config
from vfd_gan_tpu_torch.models.convlstm import ConvLSTMModel
from vfd_gan_tpu_torch.ops import augment, spatial_conv
from vfd_gan_tpu_torch.train import supervised_engine
from vfd_gan_tpu_torch.train.state import relative_distances
from vfd_gan_tpu_torch.train.supervised_engine import SupervisedEngine
from test_torch_port_threads import one_torch_thread  # noqa: F401

BF16 = torch.bfloat16
LOSS_RTOL = 1e-2          # module docstring
FEATURE_MATCHING_RTOL = 5e-2
# gradient bounds by net: the median parameter's and the whole gradient's
# relative L2 distance from JAX's (module docstring)
GRAD_RTOL = {"clstm": 0.03, "c2plus1d": 0.3, "xception": 0.6, "netg": 0.45,
             "netd": 0.7, "netg_ae": 0.3, "netd_ae": 0.7}
STATS_RTOL = 0.02
# sizes that differ from tests/test_torch_port_supervised.py's (module
# docstring): c2plus1d's train-mode step at 16^2 is noise-dominated
STEP_SIZES = {"c2plus1d": (2, 16, 32, {})}
LR = Config().lr


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _identity_dropout(self, inputs, *args, **kwargs):
    return inputs


def _losses_close(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        rtol = FEATURE_MATCHING_RTOL if k.split("/")[1] in (
            "err_g_adv_s", "err_g_adv") else LOSS_RTOL
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=rtol, atol=1e-5, err_msg=k)


def jax_moments(state, bridge) -> dict:
    """optax's first moment after one step, ``(1 - beta1) g``, bridged to
    the port's names."""
    return {k: torch.from_numpy(np.array(v)) for k, v in bridge({
        "params": _np_tree(state.opt_state[0].mu),
        "batch_stats": _np_tree(state.batch_stats)}).items()}


def moments_close(net, want: dict, control, what: str) -> None:
    """A net's gradient, read from Adam's first moment: the median
    parameter's relative distance and the whole gradient's within
    GRAD_RTOL[what] of JAX's, where the control's median misses it."""
    got = net.first_moments()
    median, whole = relative_distances(got, {k: want[k] for k in got})
    control, _ = relative_distances(control.first_moments(),
                                    {k: want[k] for k in got})
    rtol = GRAD_RTOL[what]
    assert median <= rtol and whole <= rtol < control, (
        what, median, whole, control)


def _stats_close(got: dict, want: dict) -> None:
    """The BatchNorms' running means, and their variances, within
    STATS_RTOL of JAX's as a whole (relative L2)."""
    for kind in ("running_mean", "running_var"):
        keys = [k for k in want if k.endswith(kind)]
        _, whole = relative_distances(
            {k: got[k] for k in keys},
            {k: torch.from_numpy(np.array(want[k])) for k in keys})
        assert keys and whole <= STATS_RTOL, (kind, whole)


def _params_close(got: dict, want: dict) -> None:
    """Every updated parameter float32 and within 2.5 lr of JAX's."""
    for k, v in want.items():
        if "running" in k or k.endswith("num_batches_tracked"):
            continue
        assert got[k].dtype == torch.float32, k
        d = np.abs(got[k].detach().numpy() - v)
        assert d.max() <= 2.5 * LR, (k, float(d.max()))


@pytest.mark.parametrize("family", list(BRIDGES))
def test_supervised_bf16_step_matches_jax(family, tmp_path, monkeypatch):
    """One ``SupervisedEngine`` step per family in bfloat16 against the JAX
    engine's, augment draws injected into both; the ConvLSTM's gate convs
    go through the conv3x3 wrapper in bfloat16."""
    if family in STEP_SIZES:
        monkeypatch.setitem(SIZES, family, STEP_SIZES[family])
    jcfg, cfg = (dataclasses.replace(c, compute_dtype="bfloat16")
                 for c in _cfgs(family, tmp_path))
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

    monkeypatch.setattr(fnn.Dropout, "__call__", _identity_dropout)
    monkeypatch.setattr(jaug, "sample_clip_params",
                        lambda *a, **k: tuple(map(jnp.asarray, draws)))
    _, variables = _jax_model_and_vars(family)
    jeng = object.__new__(JaxSupervisedEngine)
    jeng.cfg, jeng.pipe = jcfg, None
    jeng.model = jax_build(family, jcfg, jnp.bfloat16)
    jeng.tx = make_adam(jcfg.lr, jcfg.beta1)
    state, loss, _ = jax.jit(jeng._train_step_impl, static_argnums=(3,))(
        JaxNetState.create(variables, jeng.tx),
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(0),
        True)

    monkeypatch.setattr(supervised_engine, "sample_clip_params",
                        lambda *a, **k: (torch.from_numpy(draws[0]),
                                         torch.from_numpy(draws[1]).long(),
                                         torch.from_numpy(draws[2]).long(),
                                         torch.from_numpy(draws[3])))
    bridge = BRIDGES[family][0]
    seen = []
    conv = spatial_conv.conv3x3_forward
    monkeypatch.setattr(spatial_conv, "conv3x3_forward",
                        lambda x, w, flip=False: seen.append(
                            (x.dtype, w.dtype)) or conv(x, w, flip))

    def port_step(clip):
        eng = SupervisedEngine(cfg, None, None, device=torch.device("cpu"))
        eng.model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v
                                   in bridge(variables).items()}, strict=True)
        for m in eng.model.modules():
            if hasattr(m, "drop_rate"):
                m.drop_rate = 0.0
        got = eng._train_step_impl({"data": clip, "real": clip,
                                    "mask": torch.from_numpy(mask)})
        return eng, got

    # the control: the same step on the clip reversed in time and mirrored
    control = port_step(torch.from_numpy(
        data[:, ::-1, :, ::-1].copy()))[0].net
    seen.clear()
    eng, got = port_step(torch.from_numpy(data))

    _losses_close({"loss/err/train": got["loss/err/train"]},
                  {"loss/err/train": loss})
    _params_close(eng.model.state_dict(),
                  bridge(_np_tree(state.variables())))
    moments_close(eng.net, jax_moments(state, bridge), control, family)
    _stats_close(eng.model.state_dict(),
                 bridge(_np_tree(state.variables())))
    if isinstance(eng.model, ConvLSTMModel):
        # forward and dx launches, every one in bfloat16
        assert seen and set(seen) == {(BF16, BF16)}


def test_trainer_default_command_line_trains_in_bf16(tmp_path, capsys):
    """``python -m vfd_gan_tpu_torch.cli.trainer --model clstm`` with no
    ``--compute_dtype``: the JAX trainer's default, bfloat16, with float32
    parameters, finite losses and a scored sweep."""
    engine = trainer.main(
        ["--model", "clstm", "--batchsize", "2", "--nfr", "8", "--isize",
         "16", "--synthetic_data", "2", "--synthetic_test_batches", "1",
         "--ep", "1", "--freq", "2", "--device", "cpu", "--no-tensorboard",
         "--result_root", str(tmp_path)])
    assert engine.cfg.compute_dtype == "bfloat16"
    assert engine.model.clstm1.dtype == BF16
    assert all(p.dtype == torch.float32 for p in engine.model.parameters())
    assert engine.global_step == 2
    assert all(np.isfinite(v) for v in engine.errors.values())
    assert {"score/roc", "score/pr", "score/f1"} <= set(engine.scores)
    assert "[Done]" in capsys.readouterr().out
