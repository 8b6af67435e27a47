"""The port's GANomaly against the JAX package on the CPU: the 2-D conv
and transposed conv, the BatchNorm of NCHW frames, both nets in eval and
train mode (their weights through the port's own bridge, held by these
forward equalities), the anomaly score, one train step in float32 and in
bfloat16, the frame-level sweep, and the trainer's runs (``.pth`` pairs,
exact resume).

Sizes: b2 clips of T 8 folded to 16 frames, 32x32 (two pyramid levels);
the nets at ngf 16 (and one extra layer), the steps at the engine's fixed
ngf 64.  The augment draws are injected into both engines.

Tolerances. The convs 1e-5; forwards 1e-5 (train-mode D ``TRAIN_RTOL``
relative: its BatchNorms sum in another order); the float32 step: losses
1e-6 + 1e-5 relative (the L1 term, a mean over 49k values of the train-mode
generator's output, measured 4.6e-6 relative apart, weighs ``w_con`` = 10
in G's loss), updated parameters within Adam's first-step envelope of 2.5
lr with at most 2% beyond 5e-6 (``tests/test_torch_port_train.py`` says
why), running statistics 1e-5 relative plus ``TRAIN_RTOL`` of each vector's
largest value; the bfloat16 step as ``tests/test_torch_port_bf16_step.py``
holds the other families: losses 1e-2 relative, parameters 2.5 lr, running
statistics 2e-2 as a whole, and each net's gradient (Adam's first moment)
by its median parameter and as a whole within ``GRAD_RTOL`` of JAX's, where
the control step's (the clip reversed in time and mirrored) median misses
it (readings, median / whole; control median: G 0.096 / 0.105 (1.11), D
0.037 / 0.047 (1.04)). The sweep's ROC 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_anogan import moments_close
from tests.test_torch_port_bf16_step import _losses_close, _stats_close
from tests.test_torch_port_resume import (
    _assert_same_end_state,
    _assert_tree_equal,
)
from tests.test_torch_port_supervised import _np_tree
from vfd_gan_tpu.config import Config as JaxConfig
from vfd_gan_tpu.eval.metrics import evaluate as jax_evaluate
from vfd_gan_tpu.models import ganomaly as jganomaly
from vfd_gan_tpu.models.layers import VideoBatchNorm as JaxVideoBatchNorm
from vfd_gan_tpu.ops import augment as jaug
from vfd_gan_tpu.train import ganomaly_engine as jengine
from vfd_gan_tpu.train.state import NetState as JaxNetState
from vfd_gan_tpu.train.state import make_adam
from vfd_gan_tpu_torch.cli import trainer
from vfd_gan_tpu_torch.config import Config
from vfd_gan_tpu_torch.models.ganomaly import (
    GanomalyDiscriminator,
    GanomalyGenerator,
    ganomaly_anomaly_score,
)
from vfd_gan_tpu_torch.models.layers import FrameBatchNorm
from vfd_gan_tpu_torch.ops import augment, convs
from vfd_gan_tpu_torch.train import checkpoints, ganomaly_engine
from vfd_gan_tpu_torch.train.ganomaly_engine import GanomalyEngine
from vfd_gan_tpu_torch.utils.checkpoint import load_state_dict
from vfd_gan_tpu_torch.utils.weights import (
    ganomaly_discriminator_state_dict,
    ganomaly_generator_state_dict,
)
from test_torch_port_threads import one_torch_thread  # noqa: F401

B, T, S = 2, 8, 32
N = B * T
ATOL = 1e-5
TRAIN_RTOL = 5e-4
LOSS_RTOL = 1e-5
LR = Config().lr
# bfloat16 gradient bounds by net (module docstring), median and whole
GRAD_RTOL = {"ganomaly_g": 0.25, "ganomaly_d": 0.15}


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


def _nchw(x) -> torch.Tensor:
    return _t(x).permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("stride, pad", [(2, 1), (1, 0), (1, 1)])
def test_conv2d_and_transpose_match_jax(stride, pad):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 9, 8, 5)).astype(np.float32)
    k = rng.standard_normal((4, 4, 5, 6)).astype(np.float32)
    for mine, theirs in ((convs.conv2d, jganomaly._conv2d),
                         (convs.conv2d_transpose,
                          jganomaly._conv2d_transpose)):
        want = theirs(jnp.asarray(x), jnp.asarray(k), stride, pad)
        got = mine(_t(x), _t(k), stride, pad)
        assert got.shape == want.shape, mine.__name__
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL, err_msg=mine.__name__)


@pytest.mark.parametrize("train", [True, False])
def test_frame_batchnorm_matches_jax(train):
    rng = np.random.default_rng(1)
    x = (1 + 3 * rng.standard_normal((6, 5, 4, 7))).astype(np.float32)
    bn = JaxVideoBatchNorm()
    variables = bn.init(jax.random.key(1), jnp.asarray(x), True)
    stats = {"mean": jnp.full((7,), 0.25), "var": jnp.full((7,), 3.0)}
    variables = {"params": variables["params"],
                 "batch_stats": {"BatchNorm_0": stats}}
    y, mut = bn.apply(variables, jnp.asarray(x), train,
                      mutable=["batch_stats"])
    port = FrameBatchNorm(7).train(train)
    with torch.no_grad():
        port.weight.copy_(_t(variables["params"]["BatchNorm_0"]["scale"]))
        port.running_mean.fill_(0.25)
        port.running_var.fill_(3.0)
    got = port(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(y), rtol=0, atol=ATOL)
    new = mut["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(new["mean"]), rtol=0, atol=ATOL)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(new["var"]), rtol=0, atol=ATOL)
    assert train == bool(np.any(np.asarray(new["var"]) != 3.0))


def _jax_nets(ngf=64, extra=0, dtype=jnp.float32, seed=0):
    g = jganomaly.GanomalyGenerator(isize=S, ngf=ngf, n_extra_layers=extra,
                                    dtype=dtype)
    d = jganomaly.GanomalyDiscriminator(isize=S, ngf=ngf,
                                        n_extra_layers=extra, dtype=dtype)
    frames = jnp.zeros((N, S, S, 3), jnp.float32)
    kg, kd = jax.random.split(jax.random.key(seed))
    g_vars = jax.jit(lambda k: g.init({"params": k}, frames, False))(kg)
    d_vars = jax.jit(lambda k: d.init({"params": k}, frames, False))(kd)
    return g, _np_tree(g_vars), d, _np_tree(d_vars)


@pytest.mark.parametrize("train, extra", [(False, 0), (True, 0), (False, 1),
                                          (True, 1)])
def test_nets_match_jax(train, extra):
    """G (fake, z_in, z_out), the anomaly score and D (score, features)
    on the same frames; in train mode the running statistics too."""
    jg, g_vars, jd, d_vars = _jax_nets(16, extra)
    g = _load(GanomalyGenerator(S, ngf=16, n_extra_layers=extra),
              ganomaly_generator_state_dict(g_vars)).train(train)
    d = _load(GanomalyDiscriminator(S, ngf=16, n_extra_layers=extra),
              ganomaly_discriminator_state_dict(d_vars)).train(train)
    x = np.random.default_rng(2).uniform(-1, 1, (N, S, S, 3)).astype(
        np.float32)
    kw = {"mutable": ["batch_stats"]} if train else {}
    want_g = jg.apply(g_vars, jnp.asarray(x), train, **kw)
    want_d = jd.apply(d_vars, jnp.asarray(x), train, **kw)
    if train:
        (want_g, g_mut), (want_d, d_mut) = want_g, want_d
    fake, z_in, z_out = g(_nchw(x))
    rtol = TRAIN_RTOL if train else 0
    for got, want in ((_nhwc(fake), want_g[0]), (z_in, want_g[1]),
                      (z_out, want_g[2])):
        np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
            got, torch.Tensor) else got), np.asarray(want), rtol=rtol,
            atol=ATOL)
    np.testing.assert_allclose(
        ganomaly_anomaly_score(z_in, z_out).detach().numpy(),
        np.asarray(jganomaly.ganomaly_anomaly_score(want_g[1], want_g[2])),
        rtol=rtol, atol=ATOL)
    score, feat = d(_nchw(x))
    np.testing.assert_allclose(score.detach().numpy(), np.asarray(want_d[0]),
                               rtol=rtol, atol=ATOL)
    np.testing.assert_allclose(_nhwc(feat), np.asarray(want_d[1]),
                               rtol=rtol, atol=ATOL)
    if train:
        for net, bridge, params, mut in (
                (g, ganomaly_generator_state_dict, g_vars["params"], g_mut),
                (d, ganomaly_discriminator_state_dict, d_vars["params"],
                 d_mut)):
            new = bridge({"params": params, **_np_tree(mut)})
            _stats_within(net.state_dict(), new)


def _stats_within(got: dict, want: dict) -> None:
    for k, v in want.items():
        if "running" in k:
            np.testing.assert_allclose(
                got[k].numpy(), v, rtol=ATOL,
                atol=ATOL + TRAIN_RTOL * np.abs(v).max(), err_msg=k)


def _batch(seed=4):
    s = augment.staging_size(S)
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (B, T, s, s, 3), dtype=np.uint8)
    mask = np.zeros((B, T, s, s, 1), np.uint8)
    mask[:, :, 4:s - 4, 5:s - 6] = 255
    draws = (np.linspace(-0.17, 0.15, B).astype(np.float32),
             np.arange(B, dtype=np.int32) % 2, np.ones(B, np.int32),
             np.arange(B) % 2 == 0)
    return data, mask, draws


def _cfgs(tmp_path, dtype="float32"):
    kw = dict(model="ganomaly", batchsize=B, nfr=T, isize=S, ep=1,
              compute_dtype=dtype, tensorboard=False,
              result_root=str(tmp_path))
    return JaxConfig(**kw).validate(), Config(**kw).validate()


def _jax_step(monkeypatch, jcfg, jg, g_vars, jd, d_vars, batch, draws):
    monkeypatch.setattr(jaug, "sample_clip_params",
                        lambda *a, **k: tuple(map(jnp.asarray, draws)))
    jeng = object.__new__(jengine.GanomalyEngine)
    jeng.cfg, jeng.netg, jeng.netd = jcfg, jg, jd
    jeng.tx_g = make_adam(jcfg.lr, jcfg.beta1)
    jeng.tx_d = make_adam(jcfg.lr, jcfg.beta1)
    g_state, d_state, metrics, _ = jax.jit(jeng._train_step_impl)(
        JaxNetState.create(g_vars, jeng.tx_g),
        JaxNetState.create(d_vars, jeng.tx_d),
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(0))
    return g_state, d_state, metrics


def _port_engine(monkeypatch, cfg, g_vars, d_vars, draws):
    monkeypatch.setattr(ganomaly_engine, "sample_clip_params",
                        lambda *a, **k: (torch.from_numpy(draws[0]),
                                         torch.from_numpy(draws[1]).long(),
                                         torch.from_numpy(draws[2]).long(),
                                         torch.from_numpy(draws[3])))
    eng = GanomalyEngine(cfg, None, None, device=torch.device("cpu"))
    _load(eng.netg, ganomaly_generator_state_dict(g_vars))
    _load(eng.netd, ganomaly_discriminator_state_dict(d_vars))
    return eng


def _step_parity(got: dict, want: dict) -> None:
    total = loose = 0
    for k, v in want.items():
        if "running" in k or k.endswith("num_batches_tracked"):
            continue
        d = np.abs(got[k].detach().numpy() - v)
        assert got[k].dtype == torch.float32, k
        assert d.max() <= 2.5 * LR, (k, float(d.max()))
        total += d.size
        loose += int((d > 5e-6).sum())
    assert total and loose / total < 0.02, (loose, total)


def test_train_step_matches_jax(tmp_path, monkeypatch):
    jcfg, cfg = _cfgs(tmp_path)
    jg, g_vars, jd, d_vars = _jax_nets()
    data, mask, draws = _batch()
    batch = {"data": data, "real": data, "mask": mask}
    g_state, d_state, want = _jax_step(monkeypatch, jcfg, jg, g_vars, jd,
                                       d_vars, batch, draws)
    eng = _port_engine(monkeypatch, cfg, g_vars, d_vars, draws)
    got = eng._train_step_impl({k: torch.from_numpy(v)
                                for k, v in batch.items()})
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=LOSS_RTOL,
                                   atol=1e-6, err_msg=k)
    for net, state, bridge in (
            (eng.netg, g_state, ganomaly_generator_state_dict),
            (eng.netd, d_state, ganomaly_discriminator_state_dict)):
        new = bridge(_np_tree(state.variables()))
        _step_parity(net.state_dict(), new)
        _stats_within(net.state_dict(), new)
    # D's BatchNorms moved in its step only (twice), G's once
    for net, n in ((eng.netg, 1), (eng.netd, 2)):
        assert {int(v) for k, v in net.state_dict().items()
                if k.endswith("num_batches_tracked")} == {n}
    eng.close()


def test_bf16_train_step_matches_jax(tmp_path, monkeypatch):
    """One bfloat16 step against JAX's in bfloat16 (module docstring)."""
    jcfg, cfg = _cfgs(tmp_path, "bfloat16")
    jg, g_vars, jd, d_vars = _jax_nets(dtype=jnp.bfloat16, seed=5)
    data, mask, draws = _batch()
    batch = {"data": data, "real": data, "mask": mask}
    g_state, d_state, want = _jax_step(monkeypatch, jcfg, jg, g_vars, jd,
                                       d_vars, batch, draws)

    def port_step(clip):
        eng = _port_engine(monkeypatch, cfg, g_vars, d_vars, draws)
        assert eng.netd.trunk.pyramid[0].bn.dtype == torch.bfloat16
        got = eng._train_step_impl({"data": clip, "real": clip,
                                    "mask": torch.from_numpy(mask)})
        return eng, got

    control, _ = port_step(torch.from_numpy(
        data[:, ::-1, :, ::-1].copy()))
    eng, got = port_step(torch.from_numpy(data))
    # the latent l2 is bfloat16 in both, as JAX computes it
    assert got.pop("g/err_g_enc/train").dtype == torch.bfloat16
    want_enc = float(want.pop("g/err_g_enc/train"))
    _losses_close(got, want)
    for net, state, control_net, bridge, what in (
            (eng.g, g_state, control.g, ganomaly_generator_state_dict,
             "ganomaly_g"),
            (eng.d, d_state, control.d, ganomaly_discriminator_state_dict,
             "ganomaly_d")):
        new = bridge(_np_tree(state.variables()))
        sd = net.module.state_dict()
        for k, v in new.items():
            if "running" not in k and not k.endswith("num_batches_tracked"):
                assert sd[k].dtype == torch.float32, k
                assert np.abs(sd[k].numpy() - v).max() <= 2.5 * LR, k
        _stats_close(sd, new)
        mu = {k: torch.from_numpy(np.array(v)) for k, v in bridge({
            "params": _np_tree(state.opt_state[0].mu),
            "batch_stats": _np_tree(state.batch_stats)}).items()}
        print(moments_close(net, mu, control_net, GRAD_RTOL[what], what))
    assert np.isfinite(want_enc)
    eng.close()
    control.close()


def _sweep_batches(labels):
    rng = np.random.default_rng(6)
    out = []
    for lab in labels:
        data = rng.integers(0, 256, (B, T, S, S, 3), dtype=np.uint8)
        out.append({"data": data, "real": data,
                    "mask": np.zeros((B, T, S, S, 1), np.uint8),
                    "label": np.repeat(np.asarray(lab, np.float32)[:, None],
                                       T, axis=1)})
    return out


@pytest.mark.parametrize("labels", [[(1, 0), (0, 1)], [(0, 0), (0, 0)]],
                         ids=["two_classes", "single_class"])
def test_sweep_matches_jax(tmp_path, labels):
    """The frame-level sweep: JAX's eval-step scores, min-max normalised
    over the sweep, scored by the JAX package's ``evaluate``; a
    single-class sweep gives 0.0 and saves nothing."""
    jcfg, cfg = _cfgs(tmp_path)
    jg, g_vars, jd, d_vars = _jax_nets(16)
    batches = _sweep_batches(labels)
    jeng = object.__new__(jengine.GanomalyEngine)
    jeng.cfg, jeng.netg = jcfg, jg
    step = jax.jit(jeng._eval_step_impl)
    scores = np.concatenate([np.asarray(step(
        JaxNetState.create(g_vars, make_adam(1e-3)),
        {k: jnp.asarray(v) for k, v in b.items()})[0]).ravel()
        for b in batches])
    lab = np.concatenate([b["label"].ravel() for b in batches])
    scores = (scores - scores.min()) / (scores.max() - scores.min() + 1e-12)
    want = 0.0 if len(np.unique(lab)) < 2 else jax_evaluate(
        lab, scores, metric="roc")

    eng = GanomalyEngine(cfg, None, batches, device=torch.device("cpu"))
    eng.g.module = GanomalyGenerator(S, ngf=16)
    _load(eng.netg, ganomaly_generator_state_dict(g_vars))
    roc = eng.test()
    assert roc == pytest.approx(want, abs=1e-5) and eng.scores[
        "score/roc"] == roc
    saved = sorted(p.name for p in tmp_path.rglob("*.pth"))
    assert saved == (["roc_ep0000_netD.pth", "roc_ep0000_netG.pth"]
                     if want > 0 else [])
    eng.close()


_ARGS = ["--model", "ganomaly", "--batchsize", "2", "--nfr", "8",
         "--isize", "16", "--compute_dtype", "float32", "--synthetic_data",
         "2", "--synthetic_test_batches", "2", "--freq", "2", "--device",
         "cpu", "--no-tensorboard", "--seed", "3"]


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
    assert "test sweep at step 2: 2 batches, frame roc" in out
    assert {"g/err_g_adv/train", "g/err_g_con/train", "g/err_g_enc/train",
            "g/err_g/train", "d/err_d/train"} <= set(engine.errors)
    assert all(np.isfinite(v) for v in engine.errors.values())
    assert 0.0 <= engine.scores["score/roc"] <= 1.0
    # the sweep's clips hold both classes, so a ROC above 0 saved a pair
    pths = sorted(tmp_path.rglob("*.pth"))
    assert [p.name for p in pths] == ["roc_ep0000_netD.pth",
                                      "roc_ep0000_netG.pth"]
    GanomalyDiscriminator(16).load_state_dict(
        load_state_dict(str(pths[0])), strict=True)
    GanomalyGenerator(16).load_state_dict(
        load_state_dict(str(pths[1])), strict=True)


def test_stopped_and_resumed_run_equals_the_unbroken_run(tmp_path):
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


def test_synthetic_label_is_jax_semantics_and_survives_prefetch():
    """``label``: ``is_fake`` over T, float32, as JAX's iterator yields
    it; ``device_prefetch`` carries it with the other fields."""
    from vfd_gan_tpu_torch.data.device_synthetic import (
        DeviceSyntheticIterator,
    )
    from vfd_gan_tpu_torch.parallel.prefetch import device_prefetch

    it = DeviceSyntheticIterator(4, 6, 16, n_batches=3, seed=2)
    batches = list(device_prefetch(it, "cpu", depth=2))
    assert len(batches) == 3
    for i, batch in enumerate(batches):
        label = batch["label"]
        assert label.dtype == torch.float32 and label.shape == (4, 6)
        is_fake = batch["mask"].flatten(1).amax(1) > 0
        # a forged clip's mask is nonempty; every frame carries its label
        assert torch.equal(label, is_fake.float()[:, None].expand(4, 6))
        assert torch.equal(label, it.batch(0, i)["label"])
    assert {float(v) for b in batches for v in b["label"].unique()} == {
        0.0, 1.0}
