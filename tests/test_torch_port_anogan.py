"""The port's AnoGAN against the JAX package on the CPU: the transposed
3-D conv, the 1-d BatchNorm of G's seed Linear, both nets in eval and
train mode, the weight bridges, ``predict_forgery``, one ``_ano_core``
step in train mode and in the ``--ref_mode_quirks`` latch, one bfloat16
step, and the trainer's runs (a sweep, ``.pth`` pairs, exact resume).

Sizes: b2, nfr 16, 16x16 (the AnoGAN D bridge of ``torch_export``
hardcodes a pooled time axis of 2, right at nfr 16 only); the widths are
AnoGAN's fixed ones (512 -> 64 channels).  z comes from numpy on both
sides and dropout runs at rate 0 (flax's and torch's masks differ).

Tolerances.  The conv 1e-5, eval-mode forwards 1e-5, train-mode ones
1e-5 on G and ``TRAIN_D_RTOL`` relative on D's score (its BatchNorms sum
8192 values per channel in another order).  A step: D's loss 1e-6, as
the JAX package's own golden test holds its step to the reference; G's
loss 1e-6 + 1e-5 relative, since it reads D after D's update, where
Adam's first step flips the sign of near-zero gradients (measured: 2.6e-6
apart, a few dozen of D's parameters 2 lr apart; through JAX's updated D
the port's G loss is JAX's within 6e-8, and is held to 1e-6); updated
parameters within Adam's first-step envelope of 2.5 lr (G's lr is 5x
D's) with at most 2% of them beyond 5e-6 (``tests/test_torch_port_train.
py`` says why); every BatchNorm running statistic of G 1e-5 relative,
of D 1e-5 relative plus ``TRAIN_D_RTOL`` of its vector's largest value
(its third update reads the updated D, and its deeper statistics sit
behind the LeakyReLU(64), which multiplies noise on negative values by
64: measured 7e-5 on a ``layer2.2`` mean whose largest value is ~9; the
JAX package's golden test holds them to 2e-3 relative + 1e-3), and their
counts show D's three updates and G's one.  The bfloat16 step as
``tests/test_torch_port_bf16_step.py`` holds the other families: losses
1e-2 relative, parameters 2.5 lr, running statistics 2e-2 as a whole,
and each net's gradient (Adam's first moment) by its median parameter
and as a whole within ``GRAD_RTOL`` of JAX's, where a control step (the
clip reversed in time and mirrored, z reversed) misses it.  Readings
(median / whole; control median): G 0.156 / 0.146 (1.0), D 0.040 / 0.035
(0.46); the port's float32 step is 0.24 / 0.41 (G) and 0.057 / 0.048 (D)
from JAX's bfloat16 one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_bf16_step import _losses_close, _stats_close
from tests.test_torch_port_resume import (
    _assert_same_end_state,
    _assert_tree_equal,
)
from tests.test_torch_port_supervised import _np_tree
from vfd_gan_tpu.config import Config as JaxConfig
from vfd_gan_tpu.models.anogan import AnoDiscriminator as JaxD
from vfd_gan_tpu.models.anogan import AnoGenerator as JaxG
from vfd_gan_tpu.models.layers import TorchBatchNorm
from vfd_gan_tpu.ops import convs as jconvs
from vfd_gan_tpu.train import anogan_engine as janogan
from vfd_gan_tpu.train.state import NetState as JaxNetState
from vfd_gan_tpu.train.state import make_adam
from vfd_gan_tpu.utils import torch_export
from vfd_gan_tpu_torch.cli import trainer
from vfd_gan_tpu_torch.config import Config
from vfd_gan_tpu_torch.models.anogan import AnoDiscriminator, AnoGenerator
from vfd_gan_tpu_torch.models.layers import BatchNorm1d
from vfd_gan_tpu_torch.ops import convs
from vfd_gan_tpu_torch.ops.image import to_channel_first, to_channel_last
from vfd_gan_tpu_torch.ops.losses import bce
from vfd_gan_tpu_torch.train import checkpoints
from vfd_gan_tpu_torch.train.anogan_engine import (
    AnoGanEngine,
    predict_forgery,
)
from vfd_gan_tpu_torch.train.state import relative_distances
from vfd_gan_tpu_torch.utils.checkpoint import load_state_dict
from vfd_gan_tpu_torch.utils.weights import (
    anogan_discriminator_state_dict,
    anogan_generator_state_dict,
)
from test_torch_port_threads import one_torch_thread  # noqa: F401

B, T, S = 2, 16, 16
ATOL = 1e-5
TRAIN_D_RTOL = 5e-4
LOSS_ATOL = 1e-6
G_LOSS_RTOL = 1e-5
LR = Config().lr
# bfloat16 gradient bounds by net (module docstring), median and whole
GRAD_RTOL = {"anogan_g": 0.3, "anogan_d": 0.15}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def _load(module, sd: dict):
    module.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in sd.items()}, strict=True)
    return module


@pytest.fixture(scope="module")
def jax_nets():
    """JAX G (drop_rate 0) and D with their variables, as numpy."""
    g, d = JaxG(nfr=T, isize=S, drop_rate=0.0), JaxD()
    z = jnp.zeros((B, 100), jnp.float32)
    video = jnp.zeros((B, T, S, S, 3), jnp.float32)
    kg, kd = jax.random.split(jax.random.key(0))
    g_vars = jax.jit(lambda k: g.init({"params": k, "dropout": k}, z,
                                      False))(kg)
    d_vars = jax.jit(lambda k: d.init({"params": k}, video, False))(kd)
    return g, _np_tree(g_vars), d, _np_tree(d_vars)


def _port_nets(g_vars, d_vars, dtype=torch.float32):
    g = _load(AnoGenerator(T, S, drop_rate=0.0, dtype=dtype),
              anogan_generator_state_dict(g_vars, T, S))
    d = _load(AnoDiscriminator(T, S, dtype=dtype),
              anogan_discriminator_state_dict(d_vars, T))
    return g, d


# AnoGAN's (stride, output_padding) pairs, and (2, 0); torch takes an
# output padding below the stride only
@pytest.mark.parametrize("stride, out_pad", [(1, 0), (2, 1), (2, 0)])
def test_conv3d_transpose_matches_jax(stride, out_pad):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 5, 4, 6)).astype(np.float32)
    k = rng.standard_normal((3, 3, 3, 6, 5)).astype(np.float32)
    want = jconvs.conv3d_transpose(
        jnp.asarray(x), jnp.asarray(k), stride=(stride,) * 3,
        padding=(1, 1, 1), output_padding=(out_pad,) * 3)
    got = convs.conv3d_transpose(_t(x), _t(k), stride=(stride,) * 3,
                                 padding=(1, 1, 1),
                                 output_padding=(out_pad,) * 3)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm1d_matches_torch_batchnorm(train):
    """AnoGAN's ``fc_bn``: normalised output and running statistics."""
    rng = np.random.default_rng(1)
    x = (3 + 2 * rng.standard_normal((4, 7))).astype(np.float32)
    bn = TorchBatchNorm()
    variables = bn.init(jax.random.key(1), jnp.asarray(x), True)
    variables = {"params": variables["params"],
                 "batch_stats": {"mean": jnp.full((7,), 0.5),
                                 "var": jnp.full((7,), 2.0)}}
    y, mut = bn.apply(variables, jnp.asarray(x), not train,
                      mutable=["batch_stats"])
    port = BatchNorm1d(7).train(train)
    with torch.no_grad():
        port.weight.copy_(_t(variables["params"]["scale"]))
        port.running_mean.fill_(0.5)
        port.running_var.fill_(2.0)
    got = port(_t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]),
                               rtol=0, atol=ATOL)
    assert train == bool(np.any(np.asarray(mut["batch_stats"]["var"])
                                != 2.0))


def test_bridges_equal_torch_export(jax_nets):
    _, g_vars, _, d_vars = jax_nets
    for got, want in (
            (anogan_generator_state_dict(g_vars, T, S),
             torch_export.anogan_generator_to_torch(g_vars, T, S)),
            (anogan_discriminator_state_dict(d_vars, T),
             torch_export.anogan_discriminator_to_torch(d_vars))):
        assert list(got) == list(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


@pytest.mark.parametrize("train", [False, True])
def test_nets_match_jax(jax_nets, train):
    """G from the same z and D on the same clip, eval and train mode; in
    train mode the running statistics as well."""
    jg, g_vars, jd, d_vars = jax_nets
    g, d = _port_nets(g_vars, d_vars)
    g.train(train)
    d.train(train)
    rng = np.random.default_rng(2)
    z = rng.standard_normal((B, 100)).astype(np.float32)
    clip = rng.uniform(-1, 1, (B, T, S, S, 3)).astype(np.float32)
    kw = {"mutable": ["batch_stats"]} if train else {}
    want_g = jg.apply(g_vars, jnp.asarray(z), train, **kw)
    want_d = jd.apply(d_vars, jnp.asarray(clip), train, **kw)
    if train:
        (want_g, g_mut), ((want_s, want_f), d_mut) = want_g, want_d
    else:
        want_s, want_f = want_d
    got_g = to_channel_last(g(_t(z)))
    got_s, got_f = d(to_channel_first(_t(clip)))
    np.testing.assert_allclose(got_g.detach().numpy(), np.asarray(want_g),
                               rtol=0, atol=ATOL)
    # D's features: JAX flattens channel-last, the port NCDHW
    want_f = np.asarray(want_f).reshape(B, T // 8, S // 8, S // 8, 256)
    np.testing.assert_allclose(
        got_f.detach().numpy(),
        want_f.transpose(0, 4, 1, 2, 3).reshape(B, -1),
        rtol=TRAIN_D_RTOL if train else 0, atol=ATOL)
    np.testing.assert_allclose(got_s.detach().numpy(), np.asarray(want_s),
                               rtol=TRAIN_D_RTOL if train else 0, atol=ATOL)
    if train:
        for got_sd, want_sd in (
                (g.state_dict(), anogan_generator_state_dict(
                    {"params": g_vars["params"], **_np_tree(g_mut)}, T, S)),
                (d.state_dict(), anogan_discriminator_state_dict(
                    {"params": d_vars["params"], **_np_tree(d_mut)}, T))):
            for k, v in want_sd.items():
                if "running" in k:
                    np.testing.assert_allclose(got_sd[k].numpy(), v,
                                               rtol=ATOL, atol=ATOL,
                                               err_msg=k)


def test_predict_forgery_matches_jax():
    rng = np.random.default_rng(3)
    fake = rng.uniform(0, 1, (B, 4, S, S, 3)).astype(np.float32)
    real = rng.uniform(-1, 1, (B, 4, S, S, 3)).astype(np.float32)
    want = janogan.predict_forgery(jnp.asarray(fake), jnp.asarray(real))
    got = predict_forgery(_t(fake), _t(real))
    assert got.shape == (B, 4, S, S, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def _cfgs(tmp_path, dtype="float32"):
    kw = dict(model="anogan", batchsize=B, nfr=T, isize=S, ep=1,
              compute_dtype=dtype, tensorboard=False,
              result_root=str(tmp_path))
    return JaxConfig(**kw).validate(), Config(**kw).validate()


def _jax_step(jg, g_vars, jd, d_vars, jcfg, real, z, train_mode):
    """One ``_ano_core`` of the JAX engine, without the mesh and init its
    constructor builds."""
    jeng = object.__new__(janogan.AnoGanEngine)
    jeng.cfg, jeng.netg, jeng.netd = jcfg, jg, jd
    jeng.tx_g = make_adam(5 * jcfg.lr, 0.5)
    jeng.tx_d = make_adam(jcfg.lr, 0.5)
    g_state, d_state, fake, metrics = jax.jit(
        jeng._ano_core, static_argnums=(5,))(
        JaxNetState.create(g_vars, jeng.tx_g),
        JaxNetState.create(d_vars, jeng.tx_d), jnp.asarray(real),
        jnp.asarray(z), jax.random.key(0), train_mode)
    return g_state, d_state, np.asarray(fake), {
        k: float(v) for k, v in metrics.items()}


def _port_engine(cfg, g_vars, d_vars):
    eng = AnoGanEngine(cfg, None, None, device=torch.device("cpu"))
    _load(eng.netg, anogan_generator_state_dict(g_vars, T, S))
    _load(eng.netd, anogan_discriminator_state_dict(d_vars, T))
    eng.netg.drop_rate = 0.0
    return eng


def _step_parity(got: dict, want: dict, lr: float, what: str) -> None:
    total = loose = 0
    for k, v in want.items():
        if "running" in k or k.endswith("num_batches_tracked"):
            continue
        d = np.abs(got[k].detach().numpy() - v)
        assert d.max() <= 2.5 * lr, (what, k, float(d.max()))
        total += d.size
        loose += int((d > 5e-6).sum())
    assert total and loose / total < 0.02, (what, loose, total)


def _inputs(seed=4):
    rng = np.random.default_rng(seed)
    real = rng.uniform(-1, 1, (B, T, S, S, 3)).astype(np.float32)
    z = rng.standard_normal((B, 100)).astype(np.float32)
    return real, z


@pytest.mark.parametrize("train_mode", [True, False],
                         ids=["train", "ref_mode_quirks_latch"])
def test_ano_core_step_matches_jax(jax_nets, tmp_path, train_mode):
    jg, g_vars, jd, d_vars = jax_nets
    jcfg, cfg = _cfgs(tmp_path)
    real, z = _inputs()
    g_state, d_state, want_fake, want = _jax_step(
        jg, g_vars, jd, d_vars, jcfg, real, z, train_mode)

    eng = _port_engine(cfg, g_vars, d_vars)
    d_step = eng.d.optimizer.step
    d_grads = []

    def step_and_keep_grads():
        d_step()
        d_grads.extend(p.grad.clone() for p in eng.netd.parameters())

    eng.d.optimizer.step = step_and_keep_grads
    metrics, fake = eng._ano_core(_t(real), _t(z), None, train_mode)
    # the G step took no gradient into D's parameters
    assert d_grads and all(torch.equal(a, p.grad) for a, p in zip(
        d_grads, eng.netd.parameters()))
    assert set(metrics) == set(want)
    np.testing.assert_allclose(float(metrics["d/err_d/train"]),
                               want["d/err_d/train"], rtol=0, atol=LOSS_ATOL)
    np.testing.assert_allclose(float(metrics["g/err_g/train"]),
                               want["g/err_g/train"], rtol=G_LOSS_RTOL,
                               atol=LOSS_ATOL)
    # G's loss reads D after its update: through JAX's updated D it is
    # JAX's within 1e-6
    d_new = _load(AnoDiscriminator(T, S), anogan_discriminator_state_dict(
        _np_tree(d_state.variables()), T)).train(train_mode)
    with torch.no_grad():
        s_fake, _ = d_new(to_channel_first(_t(want_fake)))
    np.testing.assert_allclose(float(bce(s_fake, torch.ones(B))),
                               want["g/err_g/train"], rtol=0, atol=LOSS_ATOL)
    np.testing.assert_allclose(fake.numpy(), want_fake, rtol=0, atol=ATOL)
    for net, state, bridge, lr, rtol in (
            (eng.netg, g_state,
             lambda v: anogan_generator_state_dict(v, T, S), 5 * LR, 0.0),
            (eng.netd, d_state,
             lambda v: anogan_discriminator_state_dict(v, T), LR,
             TRAIN_D_RTOL)):
        new = bridge(_np_tree(state.variables()))
        sd = net.state_dict()
        _step_parity(sd, new, lr, type(net).__name__)
        for k, v in new.items():
            if "running" in k:
                np.testing.assert_allclose(
                    sd[k].numpy(), v, rtol=ATOL,
                    atol=ATOL + rtol * np.abs(v).max(), err_msg=k)
    # D's BatchNorms updated three times (real, fake, the G step's pass),
    # G's once; none in the latch
    for net, n in ((eng.netg, 1), (eng.netd, 3)):
        counts = {int(v) for k, v in net.state_dict().items()
                  if k.endswith("num_batches_tracked")}
        assert counts == {n if train_mode else 0}
    eng.close()


def moments_close(net, want: dict, control, rtol: float, what: str) -> str:
    """A net's gradient, read from Adam's first moment: the median
    parameter's and the whole gradient's relative L2 distance from JAX's
    within ``rtol``, where the control's median misses it; returns the
    readings."""
    got = net.first_moments()
    median, whole = relative_distances(got, {k: want[k] for k in got})
    cmedian, _ = relative_distances(control.first_moments(),
                                    {k: want[k] for k in got})
    assert median <= rtol and whole <= rtol < cmedian, (
        what, median, whole, cmedian)
    return f"{what} {median:.3g} / {whole:.3g} (control {cmedian:.3g})"


def test_ano_core_bf16_step_matches_jax(tmp_path):
    """One bfloat16 step against JAX's in bfloat16 (module docstring)."""
    jcfg, cfg = (dataclasses.replace(c, compute_dtype="bfloat16")
                 for c in _cfgs(tmp_path))
    jg = JaxG(nfr=T, isize=S, drop_rate=0.0, dtype=jnp.bfloat16)
    jd = JaxD(dtype=jnp.bfloat16)
    kg, kd = jax.random.split(jax.random.key(5))
    g_vars = _np_tree(jax.jit(lambda k: jg.init(
        {"params": k, "dropout": k}, jnp.zeros((B, 100)), False))(kg))
    d_vars = _np_tree(jax.jit(lambda k: jd.init(
        {"params": k}, jnp.zeros((B, T, S, S, 3)), False))(kd))
    real, z = _inputs()
    g_state, d_state, _, want = _jax_step(jg, g_vars, jd, d_vars, jcfg,
                                          real, z, True)

    def port_step(real, z):
        eng = _port_engine(cfg, g_vars, d_vars)
        assert eng.netd.layer1["1"].dtype == torch.bfloat16
        metrics, _ = eng._ano_core(_t(real), _t(z))
        return eng, metrics

    control, _ = port_step(real[:, ::-1, :, ::-1], z[:, ::-1])
    eng, got = port_step(real, z)
    _losses_close(got, want)
    for net, state, control_net, bridge, lr, what in (
            (eng.g, g_state, control.g,
             lambda v: anogan_generator_state_dict(v, T, S), 5 * LR,
             "anogan_g"),
            (eng.d, d_state, control.d,
             lambda v: anogan_discriminator_state_dict(v, T), LR,
             "anogan_d")):
        new = bridge(_np_tree(state.variables()))
        sd = net.module.state_dict()
        for k, v in new.items():
            if "running" not in k and not k.endswith("num_batches_tracked"):
                assert sd[k].dtype == torch.float32, k
                assert np.abs(sd[k].numpy() - v).max() <= 2.5 * lr, k
        _stats_close(sd, new)
        mu = {k: torch.from_numpy(np.array(v)) for k, v in bridge({
            "params": _np_tree(state.opt_state[0].mu),
            "batch_stats": _np_tree(state.batch_stats)}).items()}
        print(moments_close(net, mu, control_net, GRAD_RTOL[what], what))
    eng.close()
    control.close()


_ARGS = ["--model", "anogan", "--batchsize", "2", "--nfr", "8", "--isize",
         "16", "--compute_dtype", "float32", "--synthetic_data", "2",
         "--synthetic_test_batches", "1", "--synthetic_thick_masks",
         "--freq", "2", "--device", "cpu", "--no-tensorboard", "--seed", "3"]


def _run(argv, root):
    engine = trainer.build_engine([*argv, "--result_root", str(root)])
    try:
        engine.train()
    finally:
        engine.close()
    return engine


def test_trainer_writes_loadable_pth_pair(tmp_path, capsys):
    engine = _run(_ARGS + ["--ep", "1"], tmp_path)
    out = capsys.readouterr().out
    assert "test sweep at step 2: 1 batches" in out and "[Done]" in out
    assert all(np.isfinite(v) for v in engine.errors.values())
    assert {"d/err_d/train", "g/err_g/train", "d/err_d/test",
            "g/err_g/test"} <= set(engine.errors)
    for group in engine.g.optimizer.param_groups:
        assert group["lr"] == 5 * LR and group["betas"] == (0.5, 0.999)
    for group in engine.d.optimizer.param_groups:
        assert group["lr"] == LR and group["betas"] == (0.5, 0.999)
    names = sorted(p.name for p in tmp_path.rglob("*.pth"))
    assert names == ["roc_ep0000_netD.pth", "roc_ep0000_netG.pth"]
    g_pth, = tmp_path.rglob("*_netG.pth")
    d_pth, = tmp_path.rglob("*_netD.pth")
    AnoGenerator(8, 16).load_state_dict(load_state_dict(str(g_pth)),
                                        strict=True)
    AnoDiscriminator(8, 16).load_state_dict(load_state_dict(str(d_pth)),
                                            strict=True)


def test_stopped_and_resumed_run_equals_the_unbroken_run(tmp_path):
    """Two epochs of two steps, stopped after step 3 with an autosave and
    resumed: netG and netD, their Adam states and the loop, bit for bit."""
    argv = _ARGS + ["--ep", "2"]
    whole = _run(argv, tmp_path / "a")
    first = _run(argv + ["--max_steps", "3", "--autosave_every", "3"],
                 tmp_path / "b1")
    latest = first.weight_path("latest.pt")
    saved = torch.load(latest, map_location="cpu", weights_only=True)
    assert {"netG", "netD", "step", "loop"} <= set(saved)
    _assert_tree_equal(saved, checkpoints.host_copy(first._ckpt_tree()))
    second = _run(argv + ["--resume", latest], tmp_path / "b2")
    assert second.global_step == 4 and len(second.step_seconds) == 1
    _assert_same_end_state(whole, second)
