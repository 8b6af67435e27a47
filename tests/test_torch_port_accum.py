"""``--accum k``: the port's accumulated steps against the JAX engines'
on the CPU, and against their own manual k-microbatch reference.

The contract (JAX ``gan_engine._gan_core_accum``,
``supervised_engine._train_step_impl``): the batch is augmented once and
split into k consecutive microbatches; each microbatch's gradients are
taken with the parameters fixed and the BatchNorm running statistics
chained through the microbatches; the gradients are summed and scaled by
1/k (the GAN engine multiplies by ``1 / k``, the supervised one divides by
``k``); one optimizer step per net.  As JAX's ``tests/test_accum.py`` does,
the comparison with JAX uses SGD(1.0), so that an updated parameter is the
old one less the averaged gradient (Adam's first step is about sign(g) lr
and would hide a sum-vs-mean error), and, for the GAN, a flow stand-in on
both sides (``tanh`` of the video plus a fixed random field: D's
train-mode BatchNorms over ``tanh`` of a near-constant predicted mask
alone would amplify float32 noise past the step tests' bounds); dropout is
zeroed.

Tolerances: those of the port's step tests (``tests/test_torch_port_
train.py``, ``tests/test_torch_port_supervised_step.py``) for the losses
(1e-5, the train-mode spatial D's 5e-4 relative) and the running
statistics (1e-5, the spatial D's 5e-4 of their largest magnitude).  The
step tests hold the updated parameters through Adam's sign envelope; SGD's
update is the averaged gradient itself, held by relative L2 distance, the
median tensor's and the whole set's: 1e-3 for the ConvLSTM; for MyGAN 2e-2
(G, the temporal D) and 0.25 (the spatial D).  MyGAN's bounds are JAX's
float32 error through train-mode BatchNorms over a one-clip microbatch,
not the port's: measured against the port's own float64 step, JAX is at
6.4e-3 / 6.3e-4 (G, median / whole), 5.4e-3 / 5.7e-3 (temporal D) and
9.2e-2 / 0.124 (spatial D), the port's float32 step at 1.9e-4 / 2.6e-5,
2.6e-3 / 2.3e-3 and 2.9e-3 / 3.8e-3, held here within 1e-2.  A sum in
place of a mean is a distance of 1, an unsplit batch or a lost microbatch
far above these.

The port's own manual reference (``tools/step_reference.manual_gan_accum``,
and for the ConvLSTM its forward and backward per microbatch: the
``.grad`` tensors summed by hand, scaled, one step of each optimizer) is
bit-equal on the CPU, in bfloat16 (the default) and for ``--ae``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from tests.test_torch_port_supervised import BRIDGES, _jax_model_and_vars
from vfd_gan_tpu.config import Config as JaxConfig
from vfd_gan_tpu.models.mygan import DualDisc as JaxDualDisc
from vfd_gan_tpu.models.mygan import Generator as JaxGenerator
from vfd_gan_tpu.ops import augment as jaug
from vfd_gan_tpu.train.gan_engine import MyGanEngine as JaxGanEngine
from vfd_gan_tpu.train.state import NetState as JaxNetState
from vfd_gan_tpu.train.supervised_engine import (
    SupervisedEngine as JaxSupervisedEngine,
)
from vfd_gan_tpu_torch.config import Config
from vfd_gan_tpu_torch.ops import augment
from vfd_gan_tpu_torch.ops.image import to_channel_first, to_channel_last
from vfd_gan_tpu_torch.ops.losses import bce
from vfd_gan_tpu_torch.train import engine_base, supervised_engine
from vfd_gan_tpu_torch.train.gan_engine import MyGanEngine
from vfd_gan_tpu_torch.train.state import relative_distances
from vfd_gan_tpu_torch.train.supervised_engine import SupervisedEngine
from vfd_gan_tpu_torch.tools.step_reference import manual_gan_accum
from vfd_gan_tpu_torch.utils.weights import (
    dualdisc_state_dict,
    generator_state_dict,
)
from test_torch_port_threads import one_torch_thread  # noqa: F401

B, T, S, NGF, NDF, K = 2, 16, 64, 4, 4, 2
ATOL = 1e-5
TRAIN_D_RTOL = 5e-4
CPU = torch.device("cpu")
_SPATIAL_TRAIN = {"d/err_d_real_s/train", "d/err_d_fake_s/train",
                  "d/err_d_real/train", "d/err_d_fake/train",
                  "d/err_d/train", "g/err_g_adv_s/train",
                  "g/err_g_adv/train", "g/err_g/train"}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mesh():
    return Mesh(np.array(jax.devices()[:1]), ("dp",))


def _sgd(module):
    return torch.optim.SGD(module.parameters(), lr=1.0)


def _load(module, sd: dict):
    module.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in sd.items()}, strict=True)


def _updates_close(got: dict, new: dict, old: dict, prefix: str,
                   bound: float) -> None:
    """The SGD updates (the averaged gradients) under ``prefix`` within
    ``bound`` by relative L2 distance, median tensor and whole set.  A conv
    bias right before a BatchNorm has a true gradient of 0 (the BN takes
    it out again), so its update is float noise and is left out, as the
    step tests leave it out."""
    keys = [k for k in new if k.startswith(prefix) and "running" not in k
            and not k.endswith(("num_batches_tracked", "spatial_conv.bias",
                                "temporal_conv.bias"))]
    step_got = {k: got[k].detach().double() - torch.from_numpy(
        np.array(old[k])).double() for k in keys}
    step_want = {k: torch.from_numpy(np.array(new[k] - old[k])).double()
                 for k in keys}
    median, whole = relative_distances(step_got, step_want)
    assert median <= bound and whole <= bound, (prefix, median, whole)


def _stats_close(got: dict, want: dict) -> None:
    for k, v in want.items():
        if "running" in k:
            tol = TRAIN_D_RTOL * np.abs(v).max() + ATOL \
                if k.startswith("spatdisc") else ATOL
            np.testing.assert_allclose(got[k].numpy(), v, rtol=0, atol=tol,
                                       err_msg=k)


def _gan_inputs():
    rng = np.random.default_rng(5)
    data = rng.uniform(-1, 1, (B, T, S, S, 3)).astype(np.float32)
    gt = (rng.uniform(size=(B, T, S, S, 1)) > 0.85).astype(np.float32)
    return data, gt


# the flow stand-in's fixed field: one microbatch's two streams
FIELD = np.random.default_rng(6).uniform(
    -1, 1, (2 * B // K, T, S, S, 3)).astype(np.float32)


def _gan_cfg(tmp_path, **kw):
    fields = dict(model="mygan", isize=S, nfr=T, batchsize=B, ngf=NGF,
                  ndf=NDF, ep=1, accum=K, compute_dtype="float32",
                  tensorboard=False, result_root=str(tmp_path))
    return Config(**{**fields, **kw}).validate()


def test_gan_accum_step_matches_jax(tmp_path):
    data, gt = _gan_inputs()
    jcfg = JaxConfig(**{**vars(_gan_cfg(tmp_path))})
    jeng = object.__new__(JaxGanEngine)
    jeng.cfg, jeng.mesh = jcfg, _mesh()
    jeng.netg = JaxGenerator(ngf=NGF, dtype=jnp.float32, drop_rate=0.0)
    jeng.netd = JaxDualDisc(ndf=NDF, dtype=jnp.float32)
    jeng.tx_g = jeng.tx_d = optax.sgd(1.0)
    jeng._flow = lambda v, streams=1: jnp.tanh(v) + FIELD
    x = jnp.zeros((B, T, S, S, 3), jnp.float32)
    g_vars = _np_tree(jax.jit(lambda k: jeng.netg.init(k, x, False))(
        jax.random.key(0)))
    d_vars = _np_tree(jax.jit(lambda k: jeng.netd.init(k, x, x, False))(
        jax.random.key(1)))
    g_state, d_state, want, viz = jax.jit(
        jeng._gan_core_accum, static_argnums=5)(
        JaxNetState.create(g_vars, jeng.tx_g),
        JaxNetState.create(d_vars, jeng.tx_d), jnp.asarray(data),
        jnp.asarray(gt), jax.random.key(2), K)

    port = _port_gan(tmp_path, g_vars, d_vars, data, gt, torch.float32)
    assert set(port.metrics) == set(want)
    for k in want:
        rtol = TRAIN_D_RTOL if k in _SPATIAL_TRAIN else 0.0
        np.testing.assert_allclose(float(port.metrics[k]), float(want[k]),
                                   rtol=rtol, atol=ATOL, err_msg=k)
    g_new = generator_state_dict(_np_tree(g_state.variables()))
    d_new = dualdisc_state_dict(_np_tree(d_state.variables()))
    g_old, d_old = generator_state_dict(g_vars), dualdisc_state_dict(d_vars)
    g_sd, d_sd = port.netg.state_dict(), port.netd.state_dict()
    _updates_close(g_sd, g_new, g_old, "", 2e-2)
    _updates_close(d_sd, d_new, d_old, "tempdisc", 2e-2)
    _updates_close(d_sd, d_new, d_old, "spatdisc", 0.25)
    _stats_close(g_sd, g_new)
    _stats_close(d_sd, d_new)
    # G's statistics moved once per microbatch, D's twice
    assert int(g_sd["dconv1.bn.num_batches_tracked"]) == K
    assert int(d_sd["spatdisc.dconv1.bn.num_batches_tracked"]) == 2 * K
    assert np.asarray(viz["pred"]).shape[0] == B

    # the port's float32 step against its float64 step
    p64 = _port_gan(tmp_path, g_vars, d_vars, data, gt, torch.float64)
    as_np = {k: v.numpy() for k, v in p64.netg.state_dict().items()}
    _updates_close(g_sd, as_np, g_old, "", 1e-2)
    as_np = {k: v.numpy() for k, v in p64.netd.state_dict().items()}
    _updates_close(d_sd, as_np, d_old, "", 1e-2)


def _port_gan(tmp_path, g_vars, d_vars, data, gt, dtype):
    """The port's accumulated step from the JAX weights in ``dtype``
    (G's float32 head, cast to ``dtype`` for D and the flow stand-in);
    the engine, with its metrics under ``.metrics``."""
    port = MyGanEngine(_gan_cfg(tmp_path), None, None, device=CPU)
    _load(port.netg, generator_state_dict(g_vars))
    _load(port.netd, dualdisc_state_dict(d_vars))
    port.netg.to(dtype).drop_rate = 0.0
    port.netd.to(dtype)
    port.g.optimizer, port.d.optimizer = _sgd(port.netg), _sgd(port.netd)
    field = torch.from_numpy(FIELD).to(dtype)
    port._flow = lambda v, streams=1: torch.tanh(v.to(dtype)) + field
    disc = port._disc
    port._disc = lambda *a: disc(*(x.to(dtype) for x in a))
    port.metrics = port._gan_core(torch.from_numpy(data).to(dtype),
                                  torch.from_numpy(gt).to(dtype))
    return port


def test_supervised_accum_step_matches_jax(tmp_path, monkeypatch):
    """clstm, b2, T8, 32^2, accum 2: the JAX engine's ``_train_step_impl``
    and the port's, augment draws injected into both."""
    b, t, isize = 2, 8, 32
    kw = dict(model="clstm", batchsize=b, nfr=t, isize=isize, ep=1,
              accum=K, compute_dtype="float32", tensorboard=False,
              result_root=str(tmp_path))
    jcfg, cfg = JaxConfig(**kw).validate(), Config(**kw).validate()
    s = augment.staging_size(isize)
    rng = np.random.default_rng(4)
    data = rng.integers(0, 256, (b, t, s, s, 3), dtype=np.uint8)
    mask = np.zeros((b, t, s, s, 1), np.uint8)
    mask[:, :, 4:s - 4, 5:s - 6] = 255
    mask[1, :, 9:20, 3:12] = 0
    batch = {"data": data, "real": data, "mask": mask}
    draws = (np.array([-0.17, 0.12], np.float32), np.array([1, 0], np.int32),
             np.array([0, 2], np.int32), np.array([True, False]))

    monkeypatch.setattr(jaug, "sample_clip_params",
                        lambda *a, **k: tuple(map(jnp.asarray, draws)))
    model, variables = _jax_model_and_vars("clstm", b, t)
    jeng = object.__new__(JaxSupervisedEngine)
    jeng.cfg, jeng.model, jeng.pipe, jeng.mesh = jcfg, model, None, _mesh()
    jeng.tx = optax.sgd(1.0)
    state, loss, viz = jax.jit(jeng._train_step_impl, static_argnums=(3,))(
        JaxNetState.create(variables, jeng.tx),
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(0),
        True)

    monkeypatch.setattr(supervised_engine, "sample_clip_params",
                        lambda *a, **k: (torch.from_numpy(draws[0]),
                                         torch.from_numpy(draws[1]).long(),
                                         torch.from_numpy(draws[2]).long(),
                                         torch.from_numpy(draws[3])))
    eng = SupervisedEngine(cfg, None, None, device=CPU)
    bridge = BRIDGES["clstm"][0]
    _load(eng.model, bridge(variables))
    eng.net.optimizer = _sgd(eng.model)
    got = eng._train_step_impl({k: torch.from_numpy(v)
                                for k, v in batch.items()})

    np.testing.assert_allclose(float(got["loss/err/train"]), float(loss),
                               rtol=0, atol=ATOL)
    new = bridge(_np_tree(state.variables()))
    sd = eng.model.state_dict()
    _updates_close(sd, new, bridge(variables), "", 1e-3)
    _stats_close(sd, new)
    assert int(sd["bn1.num_batches_tracked"]) == K
    assert np.asarray(viz["pred"]).shape[0] == b


# -- the port against its own manual k-microbatch reference ----------------

def _manual_supervised_step(eng: SupervisedEngine, data, gt, k: int,
                            drop) -> dict:
    model = eng.model.train()
    params = list(model.parameters())
    total, losses = [None] * len(params), []
    for d, g in zip(data.chunk(k), gt.chunk(k)):
        eng.net.optimizer.zero_grad(set_to_none=True)
        loss = bce(to_channel_last(model(to_channel_first(d), drop)), g)
        loss.backward()
        losses.append(loss.detach())
        for i, p in enumerate(params):
            if p.grad is not None:
                total[i] = p.grad.clone() if total[i] is None \
                    else total[i] + p.grad
    for a, p in zip(total, params):
        p.grad = None if a is None else a / k
    eng.net.optimizer.step()
    return {"loss/err/train": sum(losses[1:], losses[0]) / k}


def _same_state(a, b) -> None:
    for x, y in ((a.module.state_dict(), b.module.state_dict()),
                 (a.optimizer.state_dict()["state"],
                  b.optimizer.state_dict()["state"])):
        assert x.keys() == y.keys()
        for key in x:
            xs = x[key] if isinstance(x[key], dict) else {"": x[key]}
            ys = y[key] if isinstance(y[key], dict) else {"": y[key]}
            for name in xs:
                assert torch.equal(xs[name], ys[name]), (key, name)


@pytest.mark.parametrize("case", ["mygan-bfloat16", "ae-float32",
                                  "clstm-bfloat16-k4"])
def test_accum_step_equals_its_manual_reference(tmp_path, monkeypatch, case):
    """Bit-equal on the CPU, with Adam, dropout on (masks from generators
    of one seed) and, for MyGAN, the device flow; each microbatch's flow
    is its own ``streams=2`` call over 2 x the microbatch."""
    family, dtype, *rest = case.split("-")
    k = int(rest[0][1:]) if rest else K
    if family == "clstm":
        b, t, s = 4, 8, 16
        cfg = Config(model="clstm", batchsize=b, nfr=t, isize=s, ep=1,
                     accum=k, compute_dtype=dtype, tensorboard=False,
                     result_root=str(tmp_path)).validate()
        engines = [SupervisedEngine(cfg, None, None, device=CPU)
                   for _ in range(2)]
        rng = np.random.default_rng(9)
        data = torch.from_numpy(rng.uniform(-1, 1, (b, t, s, s, 3)).astype(
            np.float32))
        gt = torch.from_numpy((rng.uniform(size=(b, t, s, s, 1)) > 0.7
                               ).astype(np.float32))
        monkeypatch.setattr(engine_base.EngineBase, "panel_step", True)
        got = engines[0]._step(data, gt, torch.Generator().manual_seed(3))
        want = _manual_supervised_step(engines[1], data, gt, k,
                                       torch.Generator().manual_seed(3))
        assert engines[0]._viz["pred"].shape[0] == b
        nets = [(e.net,) for e in engines]
    else:
        cfg = _gan_cfg(tmp_path, ae=family == "ae")
        cfg.compute_dtype = dtype
        engines = [MyGanEngine(cfg, None, None, device=CPU)
                   for _ in range(2)]
        calls = []
        flow = engines[0]._flow
        engines[0]._flow = lambda v, streams=1: (
            calls.append((v.shape[0], streams)), flow(v, streams))[1]
        data, gt = map(torch.from_numpy, _gan_inputs())
        monkeypatch.setattr(engine_base.EngineBase, "panel_step", True)
        got = engines[0]._gan_core(data, gt,
                                   torch.Generator().manual_seed(3))
        want = manual_gan_accum(engines[1], data, gt, k,
                                torch.Generator().manual_seed(3))
        assert calls == [(2 * B // k, 2)] * k
        viz = engines[0]._viz
        assert torch.equal(viz["gt"], gt)
        assert {v.shape[0] for v in viz.values()} == {B}
        nets = [(e.g, e.d) for e in engines]
    assert got.keys() == want.keys()
    for name in want:
        assert torch.equal(got[name], want[name]), name
    for a, b_ in zip(*nets):
        _same_state(a, b_)


def test_accum_train_step_augments_once(tmp_path, monkeypatch):
    """One augment call over the whole batch per accumulated step, and the
    panels of that step hold the whole batch in microbatch order."""
    from vfd_gan_tpu_torch.train import gan_engine

    calls = []
    real = gan_engine.augment_clips

    def counted(params, data, *rest):
        calls.append(data.shape[0])
        return real(params, data, *rest)

    monkeypatch.setattr(gan_engine, "augment_clips", counted)
    monkeypatch.setattr(engine_base.EngineBase, "panel_step", True)
    cfg = _gan_cfg(tmp_path, batchsize=4, ngf=2, ndf=2)
    eng = MyGanEngine(cfg, None, None, device=CPU)
    eng._flow = lambda v, streams=1: torch.tanh(v)
    stage = augment.staging_size(S)
    rng = np.random.default_rng(1)
    batch = {"data": rng.integers(0, 256, (4, T, stage, stage, 3),
                                  dtype=np.uint8),
             "mask": (rng.uniform(size=(4, T, stage, stage, 1)) > 0.9
                      ).astype(np.uint8) * 255}
    batch["real"] = batch["data"]
    metrics = eng._train_step_impl({k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    assert calls == [4]
    assert all(v.shape == () and torch.isfinite(v) for v in metrics.values())
    assert {v.shape[0] for v in eng._viz.values()} == {4}
    assert eng._viz["input"].shape == (4, T, S, S, 3)



@pytest.mark.parametrize("model, extra", [
    ("mygan", ["--nfr", "16", "--isize", "64", "--ngf", "2", "--ndf", "2"]),
    ("mygan", ["--nfr", "16", "--isize", "64", "--ndf", "2", "--ae"]),
    ("clstm", ["--nfr", "8", "--isize", "16"]),
    ("c2plus1d", ["--nfr", "16", "--isize", "16"]),
    ("xception", ["--nfr", "8", "--isize", "32", "--xwidth", "0.0625"]),
], ids=["mygan", "mygan-ae", "clstm", "c2plus1d", "xception"])
def test_trainer_takes_accum_for_every_engine_that_has_it(tmp_path, model,
                                                         extra):
    """``--accum 2`` through the entry point: one step and a sweep, the
    BatchNorm statistics moved once per microbatch (D's twice)."""
    from vfd_gan_tpu_torch.cli import trainer

    engine = trainer.main(
        ["--model", model, "--batchsize", "4", "--accum", "2", *extra,
         "--compute_dtype", "float32", "--synthetic_data", "1",
         "--synthetic_test_batches", "1", "--ep", "1", "--freq", "1",
         "--device", "cpu", "--no-tensorboard", "--result_root",
         str(tmp_path)])
    assert engine.cfg.accum == 2 and engine.global_step == 1
    assert all(np.isfinite(v) for v in engine.errors.values())
    nets = engine._nets()
    counts = {name: [int(v) for k, v in net.module.state_dict().items()
                     if k.endswith("num_batches_tracked")]
              for name, net in nets.items()}
    want = {"netG": 2, "netD": 4, "state": 2}
    for name, seen in counts.items():
        # the sweep runs in eval mode: no statistic moves there
        assert seen and set(seen) == {want[name]}, (name, seen)
