"""The port's training step against the JAX package on the CPU.

Augmentation (with injected draws), the losses, the Generator in train
mode at ``drop_rate=0``, the DualDisc and its weight bridge, one whole
``_gan_core`` step of ``MyGanEngine`` (flows injected on both sides, as
``tests/test_gan_step_parity.py`` does, dropout zeroed), the test step's
tail, the synthetic data source and the trainer entry point.  Sizes are
tiny: B=2, T=16, 64x64, ngf = ndf = 4.

Tolerances.  Eval-mode values and the G side agree to ~1e-6, inside
1e-5.  Train-mode values of the spatial discriminator do not: at this
size its BatchNorms normalise channels of 131k elements, and JAX sums
them in float32 with XLA's CPU reduction, which is off from a float64
evaluation by ~1e-5 relative, an error the deep BN chain amplifies to
~1e-4 on D's spatial score (measured: port vs JAX 1.5e-4 relative on
``err_d_real_s``; the port's own float32 vs its float64 run 6e-6, and its
BatchNorm equal to a numpy float64 BatchNorm to 3e-14).  Those values are
held to ``TRAIN_D_RTOL`` and the port's precision is pinned on its own
(``test_dualdisc_train_mode_float32_is_close_to_float64``).  Updated
parameters: Adam's first step moves each weight by ~lr whatever the
gradient's size, so where the true gradient is ~0 (a conv bias under a
BatchNorm) float noise can flip its sign, a 2 lr difference that carries
no information; as ``tests/test_gan_step_parity.py`` does, every element
is bounded by 2.5 lr and at most 2% may differ by more than 5e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfd_gan_tpu import config as jconfig
from vfd_gan_tpu.config import Config
from vfd_gan_tpu.models.mygan import DualDisc as JaxDualDisc
from vfd_gan_tpu.models.mygan import Generator as JaxGenerator
from vfd_gan_tpu.ops import augment as jaug
from vfd_gan_tpu.ops import losses as jlosses
from vfd_gan_tpu.train.gan_engine import MyGanEngine as JaxEngine
from vfd_gan_tpu.train.state import NetState as JaxNetState
from vfd_gan_tpu.train.state import make_adam
from vfd_gan_tpu.utils import torch_export
from vfd_gan_tpu_torch import config as pconfig
from vfd_gan_tpu_torch.cli import trainer
from vfd_gan_tpu_torch.data.device_synthetic import DeviceSyntheticIterator
from vfd_gan_tpu_torch.models.mygan import DualDisc, Generator
from vfd_gan_tpu_torch.ops import augment, losses
from vfd_gan_tpu_torch.ops.image import to_channel_first, to_channel_last
from vfd_gan_tpu_torch.train.gan_engine import MyGanEngine
from vfd_gan_tpu_torch.utils.checkpoint import load_state_dict
from vfd_gan_tpu_torch.utils.weights import (
    dualdisc_state_dict,
    generator_state_dict,
)

B, T, S, NGF, NDF = 2, 16, 64, 4, 4
ATOL = 1e-5
TRAIN_D_RTOL = 5e-4     # train-mode spatial-D values (module docstring)
LR = Config().lr


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def _load(module, sd: dict):
    module.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in sd.items()}, strict=True)
    return module


def _close_sd(got: dict, want: dict, atol: float, what: str) -> None:
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        g = got[k].detach().cpu().numpy()
        np.testing.assert_allclose(g, np.asarray(v), rtol=0, atol=atol,
                                   err_msg=f"{what}: {k}")


# -- augmentation ------------------------------------------------------------

_DRAWS = [
    (0.0, 0, 0, False),
    (0.1234, 5, 9, True),
    (-0.1745, 12, 0, False),
    (0.05, 3, 12, True),
]


@pytest.mark.parametrize("isize", [16, 24])
def test_augment_clips_bit_exact_with_injected_draws(isize):
    stage = augment.staging_size(isize)
    rng = np.random.default_rng(0)
    draws = [d for d in _DRAWS if max(d[1], d[2]) <= stage - isize]
    b = len(draws)
    data = rng.integers(0, 256, (b, 3, stage, stage, 3), dtype=np.uint8)
    real = rng.integers(0, 256, (b, 3, stage, stage, 3), dtype=np.uint8)
    mask = (rng.uniform(size=(b, 3, stage, stage, 1)) > 0.5).astype(
        np.uint8) * 255
    angle = np.array([d[0] for d in draws], np.float32)
    cy = np.array([d[1] for d in draws], np.int32)
    cx = np.array([d[2] for d in draws], np.int32)
    flip = np.array([d[3] for d in draws])

    warp = jax.vmap(jaug._warp_clip, in_axes=(0, 0, 0, 0, 0, None))
    args = tuple(map(jnp.asarray, (angle, cy, cx, flip)))
    want = jaug.normalize_clips(*(warp(jnp.asarray(v), *args, isize)
                                  for v in (data, real, mask)))
    params = (torch.from_numpy(angle), torch.from_numpy(cy).long(),
              torch.from_numpy(cx).long(), torch.from_numpy(flip))
    got = augment.augment_clips(params, torch.from_numpy(data),
                                torch.from_numpy(real),
                                torch.from_numpy(mask), isize)
    for g, w in zip(got, want):
        assert g.shape == (b, 3, isize, isize, w.shape[-1])
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_sample_clip_params_ranges():
    gen = torch.Generator().manual_seed(0)
    angle, cy, cx, flip = augment.sample_clip_params(gen, 256, 140, 128)
    assert angle.abs().max() <= np.deg2rad(10.0) + 1e-6
    assert cy.min() >= 0 and cy.max() <= 12 and cx.max() <= 12
    assert {cy.max().item(), cx.max().item()} == {12}   # inclusive bound
    assert 0.3 < flip.float().mean() < 0.7


# -- losses -------------------------------------------------------------------

@pytest.mark.parametrize("name", ["weighted_bce", "bce", "l2_loss"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(1)
    pred = rng.uniform(0, 1, (2, 3, 4, 5)).astype(np.float32)
    pred.flat[:3] = (0.0, 1.0, 1e-9)                # clamp and floor paths
    target = (rng.uniform(size=pred.shape) > 0.5).astype(np.float32)
    want = float(getattr(jlosses, name)(jnp.asarray(pred),
                                        jnp.asarray(target)))
    got = float(getattr(losses, name)(_t(pred), _t(target)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# -- models -------------------------------------------------------------------

def _jax_init(module, *inputs):
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: module.init(k, *inputs, False))(jax.random.key(0)))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_generator_drop_rate_zero_train_mode_matches_jax():
    """The repaired ``drop_rate``: at 0 a train-mode forward is
    deterministic, and equals JAX's, BN running stats included."""
    x = np.random.default_rng(2).uniform(-1, 1, (B, T, 16, 16, 3)).astype(
        np.float32)
    jg = JaxGenerator(ngf=NGF, drop_rate=0.0)
    variables = _jax_init(jg, jnp.asarray(x))
    want, mut = jax.jit(lambda v, x: jg.apply(
        v, x, True, mutable=["batch_stats"],
        rngs={"dropout": jax.random.key(1)}))(variables, jnp.asarray(x))
    models = [_load(Generator(NGF, drop_rate=0.0),
                    generator_state_dict(variables)).train()
              for _ in range(2)]
    outs = [to_channel_last(m(to_channel_first(_t(x)),
                              torch.Generator().manual_seed(s)))
            for m, s in zip(models, (0, 1))]
    assert torch.equal(outs[0], outs[1])
    np.testing.assert_allclose(outs[0].detach().numpy(), np.asarray(want),
                               rtol=0, atol=ATOL)
    stats = generator_state_dict({"params": variables["params"],
                                  "batch_stats": _np_tree(mut)["batch_stats"]})
    _close_sd(models[0].state_dict(), stats, ATOL, "G BN stats")


def test_generator_dropout_draws_from_its_generator():
    model = Generator(4, generator=torch.Generator().manual_seed(0)).train()
    x = torch.rand(2, 3, 16, 16, 16)
    a = model(x, torch.Generator().manual_seed(5))
    b = model(x, torch.Generator().manual_seed(5))
    c = model(x, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    model.eval()
    assert torch.equal(model(x, torch.Generator().manual_seed(5)),
                       model(x, torch.Generator().manual_seed(6)))


def _disc_inputs(seed, n=1):
    """``n`` (RGB mask video, flow video) pairs: binary masks, as D sees
    the gt, and uniform flow RGB."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        gt = (rng.uniform(size=(B, T, S, S, 1)) > 0.85).astype(np.float32)
        out.append((np.repeat(gt, 3, axis=-1),
                    rng.uniform(-1, 1, (B, T, S, S, 3)).astype(np.float32)))
    return out


@pytest.fixture(scope="module")
def jax_disc():
    """JAX DualDisc variables at init and after two train passes (real
    and fake inputs), and the jitted train-mode apply."""
    x = jnp.zeros((B, T, S, S, 3), jnp.float32)
    jd = JaxDualDisc(ndf=NDF)
    variables = _jax_init(jd, x, x)
    train = jax.jit(lambda v, x, y: jd.apply(v, x, y, True,
                                             mutable=["batch_stats"]))
    stats = variables["batch_stats"]
    for x, y in _disc_inputs(4, 2):
        _, mut = train({"params": variables["params"], "batch_stats": stats},
                       jnp.asarray(x), jnp.asarray(y))
        stats = mut["batch_stats"]
    trained = {"params": variables["params"], "batch_stats": _np_tree(stats)}
    return jd, variables, trained, train


def test_dualdisc_bridge_equals_torch_export_at_128():
    x = jnp.zeros((1, 16, 128, 128, 3), jnp.float32)
    variables = _jax_init(JaxDualDisc(ndf=NDF), x, x)
    got = dualdisc_state_dict(variables)
    want = torch_export.mygan_dualdisc_to_torch(variables)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=k)
    _load(DualDisc(NDF, 16, 128), got)


def test_dualdisc_eval_forward_matches_jax(jax_disc):
    """Eval mode with the running stats of two train passes (at init they
    would leave D's signal below float32 resolution)."""
    jd, _, trained, _ = jax_disc
    (x, y), = _disc_inputs(3)
    s, sf, t, tf = jax.jit(lambda v, x, y: jd.apply(v, x, y, False))(
        trained, jnp.asarray(x), jnp.asarray(y))
    model = _load(DualDisc(NDF, T, S), dualdisc_state_dict(trained)).eval()
    with torch.no_grad():
        gs, gsf, gt, gtf = model(to_channel_first(_t(x)),
                                 to_channel_first(_t(y)))
    np.testing.assert_allclose(gs.numpy(), np.asarray(s), rtol=0, atol=ATOL)
    np.testing.assert_allclose(gt.numpy(), np.asarray(t), rtol=0, atol=ATOL)
    np.testing.assert_allclose(to_channel_last(gsf).numpy(), np.asarray(sf),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(to_channel_last(gtf).numpy(), np.asarray(tf),
                               rtol=0, atol=ATOL)


def test_dualdisc_train_forward_and_bn_stats_match_jax(jax_disc):
    """Two sequential train passes, as a step runs real then fake: scores,
    temporal features and the running stats after both."""
    _, variables, trained, train = jax_disc
    model = _load(DualDisc(NDF, T, S), dualdisc_state_dict(variables)).train()
    stats = variables["batch_stats"]
    for x, y in _disc_inputs(4, 2):
        (s, _, t, tf), mut = train({"params": variables["params"],
                                    "batch_stats": stats}, jnp.asarray(x),
                                   jnp.asarray(y))
        stats = mut["batch_stats"]
        with torch.no_grad():
            gs, _, gt, gtf = model(to_channel_first(_t(x)),
                                   to_channel_first(_t(y)))
        np.testing.assert_allclose(gs.numpy(), np.asarray(s),
                                   rtol=TRAIN_D_RTOL, atol=ATOL)
        np.testing.assert_allclose(gt.numpy(), np.asarray(t), rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(
            to_channel_last(gtf).numpy(), np.asarray(tf), rtol=0,
            atol=TRAIN_D_RTOL * np.abs(np.asarray(tf)).max())
    want = dualdisc_state_dict(trained)
    got = model.state_dict()
    for k, v in want.items():
        if "running" in k:
            tol = TRAIN_D_RTOL * np.abs(v).max() + ATOL \
                if k.startswith("spatdisc") else ATOL
            np.testing.assert_allclose(got[k].numpy(), v, rtol=0, atol=tol,
                                       err_msg=k)


def test_dualdisc_train_mode_float32_is_close_to_float64():
    """The port's float32 train-mode D against its own float64 run: the
    tolerance of the JAX comparison above is JAX's float32 error, not the
    port's (measured here: 1.1e-5 on a score, inside 2e-5)."""
    model = DualDisc(NDF, T, S, generator=torch.Generator().manual_seed(0))
    model64 = DualDisc(NDF, T, S)
    model64.load_state_dict(model.state_dict())
    model.train()
    model64.double().train()
    with torch.no_grad():
        for x, y in _disc_inputs(7, 2):
            a = model(to_channel_first(_t(x)), to_channel_first(_t(y)))
            b = model64(to_channel_first(_t(x)).double(),
                        to_channel_first(_t(y)).double())
            for i in (0, 2):
                np.testing.assert_allclose(a[i].numpy(), b[i].numpy(),
                                           rtol=0, atol=2 * ATOL)
    got, want = model.state_dict(), model64.state_dict()
    for k in got:
        if "running" in k:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=0, atol=ATOL, err_msg=k)


# -- one GAN step -------------------------------------------------------------

# metrics that carry the train-mode spatial D (module docstring)
_SPATIAL_TRAIN = {"d/err_d_real_s/train", "d/err_d_fake_s/train",
                  "d/err_d_real/train", "d/err_d_fake/train",
                  "d/err_d/train", "g/err_g_adv_s/train",
                  "g/err_g_adv/train", "g/err_g/train"}


def _cfg(tmp_path, **kw):
    return Config(model="mygan", isize=S, nfr=T, batchsize=B, ngf=NGF,
                  ndf=NDF, ep=1, compute_dtype="float32", tensorboard=False,
                  result_root=str(tmp_path), **kw).validate()


@pytest.fixture(scope="module")
def step_inputs():
    rng = np.random.default_rng(5)
    data = rng.uniform(-1, 1, (B, T, S, S, 3)).astype(np.float32)
    gt = (rng.uniform(size=(B, T, S, S, 1)) > 0.85).astype(np.float32)
    flows = rng.uniform(-1, 1, (2 * B, T, S, S, 3)).astype(np.float32)
    return data, gt, flows


@pytest.fixture(scope="module")
def engines(tmp_path_factory, step_inputs):
    """A JAX engine (its step methods, without the mesh and init its
    constructor builds) and a port engine, from the same weights, with
    dropout zeroed and the flows injected."""
    cfg = _cfg(tmp_path_factory.mktemp("runs"))
    jeng = object.__new__(JaxEngine)
    jeng.cfg = cfg
    jeng.netg = JaxGenerator(ngf=NGF, dtype=jnp.float32, drop_rate=0.0)
    jeng.netd = JaxDualDisc(ndf=NDF, dtype=jnp.float32)
    jeng.tx_g, jeng.tx_d = make_adam(cfg.lr, cfg.beta1), make_adam(
        cfg.lr, cfg.beta1)
    shared = jnp.asarray(step_inputs[2])
    jeng._flow = lambda v, streams=1: shared
    x = jnp.zeros((B, T, S, S, 3), jnp.float32)
    g_vars = _jax_init(jeng.netg, x)
    d_vars = _jax_init(jeng.netd, x, x)

    port = MyGanEngine(cfg, None, None, device=torch.device("cpu"))
    _load(port.netg, generator_state_dict(g_vars))
    _load(port.netd, dualdisc_state_dict(d_vars))
    port.netg.drop_rate = 0.0
    port._flow = lambda v, streams=1: _t(step_inputs[2])
    return jeng, port, g_vars, d_vars


def _step_parity(got: dict, want: dict, prefix: str, share: float) -> None:
    """Every updated parameter under ``prefix`` within the sign-flip
    envelope; all but ``share`` of those with a real gradient within 5e-6.
    A conv bias right before a BatchNorm has a true gradient of 0 (the BN
    subtracts it again), so its first Adam step is +-lr of float noise on
    either side."""
    total = loose = 0
    for k, v in want.items():
        if not k.startswith(prefix) or "running" in k \
                or k.endswith("num_batches_tracked"):
            continue
        d = np.abs(got[k].detach().numpy() - v)
        assert d.max() <= 2.5 * LR, (prefix, k, float(d.max()))
        if k.endswith(("spatial_conv.bias", "temporal_conv.bias")):
            continue
        total += d.size
        loose += int((d > 5e-6).sum())
    assert total and loose / total < share, (prefix, loose, total)


def test_gan_core_step_matches_jax(engines, step_inputs):
    jeng, port, g_vars, d_vars = engines
    data, gt, _ = step_inputs
    g_state, d_state, want, _ = jax.jit(jeng._gan_core)(
        JaxNetState.create(g_vars, jeng.tx_g),
        JaxNetState.create(d_vars, jeng.tx_d), jnp.asarray(data),
        jnp.asarray(gt), jax.random.key(0))
    got = port._gan_core(_t(data), _t(gt), torch.Generator().manual_seed(0))

    assert set(got) == set(want)
    for k in want:
        rtol = TRAIN_D_RTOL if k in _SPATIAL_TRAIN else 0.0
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol,
                                   atol=ATOL, err_msg=k)
    g_new = generator_state_dict(_np_tree(g_state.variables()))
    d_new = dualdisc_state_dict(_np_tree(d_state.variables()))
    _step_parity(port.netg.state_dict(), g_new, "", 0.02)
    _step_parity(port.netd.state_dict(), d_new, "tempdisc", 0.02)
    # the spatial D's small deep-layer gradients carry the train-mode
    # float32 error of the module docstring: measured 3.6% beyond 5e-6
    _step_parity(port.netd.state_dict(), d_new, "spatdisc", 0.10)
    for k, v in g_new.items():
        if "running" in k:
            np.testing.assert_allclose(port.netg.state_dict()[k].numpy(), v,
                                       rtol=0, atol=ATOL, err_msg=k)
    for k, v in d_new.items():
        if "running" in k:
            tol = TRAIN_D_RTOL * np.abs(v).max() + ATOL \
                if k.startswith("spatdisc") else ATOL
            np.testing.assert_allclose(port.netd.state_dict()[k].numpy(), v,
                                       rtol=0, atol=tol, err_msg=k)
    # the step moved the weights, by about lr
    moved = np.abs(port.netd.state_dict()["tempdisc.linear.weight"].numpy()
                   - dualdisc_state_dict(d_vars)["tempdisc.linear.weight"])
    assert 0.5 * LR < moved.max() < 2 * LR


def test_eval_tail_matches_jax(engines, step_inputs, jax_disc):
    """The test step's tail in eval mode: the opened masks and the
    reference's test losses (temporal-only ``g/err_g/test``)."""
    jeng, port, _, _ = engines
    trained = jax_disc[2]
    data, gt, flows = step_inputs
    _load(port.netd, dualdisc_state_dict(trained))
    pred = np.clip(gt * 0.7 + 0.2 + 0.1 * np.random.default_rng(6).uniform(
        size=gt.shape), 0, 1).astype(np.float32)
    g3, p3 = (np.repeat(v, 3, axis=-1) for v in (gt, pred))
    d_state = JaxNetState.create(trained, jeng.tx_d)
    _, jm, want, _, _ = jax.jit(jeng._eval_tail)(
        d_state, *map(jnp.asarray, (data, data, gt, pred, g3, p3, flows[:B],
                                    flows[B:])))
    port.netd.eval()
    _, pm, got, _ = port._eval_tail(*map(_t, (data, gt, pred, g3, p3,
                                              flows[:B], flows[B:])))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                                   atol=ATOL, err_msg=k)


# -- data and the entry point -------------------------------------------------

def test_device_synthetic_is_a_function_of_seed_epoch_index():
    it = DeviceSyntheticIterator(2, 16, 32, n_batches=3, seed=4)
    first = list(it)
    again = DeviceSyntheticIterator(2, 16, 32, n_batches=3, seed=4)
    assert len(first) == 3
    for i, a in enumerate(first):
        b = again.batch(0, i)
        for k in ("data", "real", "mask"):
            assert torch.equal(a[k], b[k]), k
    second_pass = list(it)                       # epoch 1: other batches
    assert not torch.equal(first[0]["data"], second_pass[0]["data"])
    assert torch.equal(second_pass[2]["data"], again.batch(1, 2)["data"])
    b0 = first[0]
    assert b0["data"].shape == (2, 16, 32, 32, 3)
    assert b0["data"].dtype == torch.uint8
    assert b0["mask"].shape == (2, 16, 32, 32, 1)
    assert set(b0["mask"].unique().tolist()) <= {0, 255}
    # a clip with an empty mask is real: its data is the real video
    fake = b0["mask"].flatten(1).amax(1) > 0
    assert torch.equal(b0["data"][~fake], b0["real"][~fake])
    assert not torch.equal(b0["data"][fake], b0["real"][fake])


_ARGS = ["--model", "mygan", "--batchsize", "2", "--nfr", "16", "--isize",
         "64", "--ngf", "2", "--ndf", "2", "--compute_dtype", "float32",
         "--synthetic_data", "2", "--synthetic_test_batches", "1", "--ep",
         "1", "--freq", "2", "--synthetic_thick_masks"]


def test_trainer_runs_a_sweep_and_writes_loadable_pth(tmp_path, capsys):
    engine = trainer.main(_ARGS + ["--device", "cpu", "--result_root",
                                   str(tmp_path)])
    out = capsys.readouterr().out
    assert "test sweep at step 2" in out and "[Done]" in out
    assert engine.global_step == 2 and len(engine.step_seconds) == 2
    assert all(np.isfinite(v) for v in engine.errors.values())
    assert {"score/roc", "score/pr", "score/f1"} <= set(engine.scores)
    weights = sorted(p.name for p in (tmp_path / "mygan").rglob("*.pth"))
    assert weights == ["roc_ep0000_netD.pth", "roc_ep0000_netG.pth"]
    g_pth, = (tmp_path / "mygan").rglob("*_netG.pth")
    d_pth, = (tmp_path / "mygan").rglob("*_netD.pth")
    Generator(2).load_state_dict(load_state_dict(str(g_pth)), strict=True)
    DualDisc(2, 16, 64).load_state_dict(load_state_dict(str(d_pth)),
                                        strict=True)
    args, = (tmp_path / "mygan").rglob("args.txt")
    assert '"synthetic_data": 2' in args.read_text()


@pytest.mark.parametrize("extra, match", [
    # ported since: the engine is built and holds the option
    pytest.param(["--model", "anogan"], None, id="--model_anogan-AnoGAN"),
    pytest.param(["--device_scoring"], None,
                 id="--device_scoring-sweep scored on the device"),
    # ported since: the nets compute in it
    pytest.param(["--compute_dtype", "bfloat16"], None,
                 id="--compute_dtype_bfloat16-bf16 nets"),
    # neither synthetic data nor both path lists: the JAX trainer's exit 2
    pytest.param(["--synthetic_data", "0"], 2, id="--synthetic_data_0-mp4"),
    # ported since: the engine is built and holds the option (the ids are
    # the refusal cases')
    pytest.param(["--accum", "2"], None, id="--accum_2---accum"),
    pytest.param(["--remat"], None, id="--remat---remat"),
    # ported since: the engine is built and holds the option
    pytest.param(["--cache_gt_flow"], None,
                 id="--cache_gt_flow-gt-flow cache"),
    pytest.param(["--ref_mode_quirks"], None,
                 id="--ref_mode_quirks-train-mode test sweep"),
    pytest.param(["--host_flow"], None, id="--host_flow-host_flow"),
    # ported since: the engine is built and holds the option
    pytest.param(["--int8_disc"], None, id="--int8_disc-quant"),
], ids=lambda v: v if isinstance(v, str) else "_".join(v))
def test_trainer_refuses_what_is_not_ported(tmp_path, capsys, extra, match):
    argv = _ARGS + extra + ["--device", "cpu", "--result_root", str(tmp_path)]
    if match is None:
        engine = trainer.build_engine(argv)
        want = extra[1] if len(extra) > 1 else True
        assert str(getattr(engine.cfg, extra[0].lstrip("-"))) == str(want)
        if extra[0] == "--remat":
            assert engine.netg.remat == set(engine.netg.BLOCKS)
        if extra[0] == "--host_flow":
            from vfd_gan_tpu_torch.train.host_flow import (
                video_to_flow_rgb_host,
            )
            assert engine._flow is video_to_flow_rgb_host
        if extra[0] == "--int8_disc":
            from vfd_gan_tpu_torch.models.layers import QConv3d
            assert isinstance(engine.netd.spatdisc.dconv1.conv.spatial_conv,
                              QConv3d)
        if extra[0] == "--compute_dtype":
            assert engine.netg.dconv1.bn.dtype == torch.bfloat16
            assert engine.netd.spatdisc.linear.dtype == torch.bfloat16
        if extra[0] == "--model":
            assert type(engine).__name__ == "AnoGanEngine"
        engine.close()
        return
    if match == 2:
        with pytest.raises(SystemExit) as exit_info:
            trainer.main(argv)
        assert exit_info.value.code == 2
        assert "--tr_plist and --ts_plist are required" in \
            capsys.readouterr().err
        return
    with pytest.raises(SystemExit, match=match):
        trainer.main(argv)


def test_unported_lost_exactly_the_five_ported_options():
    """Left: what needs several devices (--int8_disc and --moe_experts
    with one shard are ported since; --dp since, and since with the three
    options whose dp needs a global reduction of its own; --pp since;
    --sp for MyGAN since, and for every family since; --moe_shards
    since; --tp for MyGAN without its options since, and for Xception and
    GANomaly since)."""
    from vfd_gan_tpu_torch.config import parse_args
    from vfd_gan_tpu_torch.train.engine_base import UNPORTED

    assert set(UNPORTED) == {"tp"}
    unported, _ = UNPORTED["tp"]
    for model in ("mygan", "xception", "ganomaly"):
        assert unported(parse_args(["--model", model, "--tp", "2"])) is None
    assert unported(parse_args(["--model", "c2plus1d", "--tp", "2"])) \
        == "--model c2plus1d"


def test_trainer_needs_a_card_for_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        trainer.main(_ARGS + ["--result_root", str(tmp_path)])



def test_config_is_the_jax_config_restated():
    import dataclasses

    mine = [(f.name, f.type, getattr(pconfig.Config(), f.name))
            for f in dataclasses.fields(pconfig.Config)]
    theirs = [(f.name, f.type, getattr(jconfig.Config(), f.name))
              for f in dataclasses.fields(jconfig.Config)]
    assert mine == theirs
    argv = ["--model", "mygan", "--isize", "64", "--no-tensorboard",
            "--flow_scale", "1.0", "--remat", "--gpu", "1"]
    assert dataclasses.asdict(pconfig.parse_args(argv)) == \
        dataclasses.asdict(jconfig.parse_args(argv))
    for bad in (["--isize", "60"], ["--model", "mygan", "--nfr", "8"],
                ["--pp", "2"], ["--morph_plane", "xy"], ["--accum", "3"]):
        with pytest.raises(ValueError) as mine_err:
            pconfig.parse_args(bad)
        with pytest.raises(ValueError) as their_err:
            jconfig.parse_args(bad)
        assert str(mine_err.value) == str(their_err.value)
