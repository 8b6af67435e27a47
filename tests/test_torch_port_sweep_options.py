"""MyGAN's ``--ae``, ``--ref_mode_quirks`` and ``--cache_gt_flow`` and the
supervised engine's stuck-in-eval latch, on the CPU, against the JAX
package where it has the same function.

Tolerances (those of ``tests/test_torch_port_train.py``, whose helpers and
sizes these tests use: B=2, T=16, 64x64, ndf=4): losses 1e-5, the
train-mode spatial D's 5e-4 relative; BatchNorm statistics 1e-5, the
spatial D's 5e-4 of their largest value and never tighter than 5e-5 (its
running means on these noise inputs cancel to ~1e-2, where float32 sums in
another order differ by up to 2.2e-5: measured at 1, 2, 4 and 8 torch
threads); updated parameters inside Adam's
first-step envelope of 2.5 lr with at most 2% beyond 5e-6.  The spatial
feature-matching loss (``g/err_g_adv_s`` and the ``g/err_g_adv`` that holds
it), an L2 distance between the deepest train-mode spatial features, is the
most amplified of those values: here it was measured between 1e-5 and 8e-4
relative from JAX's, depending on the thread count that orders torch's
float32 sums (1, 2, 4 or 8 threads), and is held to 5e-3.  The cached
sweep is held to the port's own uncached sweep exactly (``torch.equal``).
flax's ``Dropout`` is patched to the identity and the port runs
``drop_rate=0``, as in ``tests/test_torch_port_supervised_step.py``.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_train import (
    _SPATIAL_TRAIN,
    ATOL,
    NDF,
    TRAIN_D_RTOL,
    B,
    S,
    T,
    _cfg,
    _jax_init,
    _load,
    _np_tree,
    _step_parity,
    _t,
)
from vfd_gan_tpu.data.synthetic import make_dataset
from vfd_gan_tpu.models.mygan import DualDisc as JaxDualDisc
from vfd_gan_tpu.models.mygan import Generator as JaxGenerator
from vfd_gan_tpu.models.stcnn import AutoEncoder as JaxAutoEncoder
from vfd_gan_tpu.train.engine_base import EngineBase as JaxEngineBase
from vfd_gan_tpu.train.gan_engine import MyGanEngine as JaxEngine
from vfd_gan_tpu.train.state import NetState as JaxNetState
from vfd_gan_tpu.train.state import make_adam
from vfd_gan_tpu_torch.cli import trainer
from vfd_gan_tpu_torch.models.stcnn import AutoEncoder
from vfd_gan_tpu_torch.train.gan_engine import MyGanEngine
from vfd_gan_tpu_torch.utils.weights import (
    autoencoder_state_dict,
    dualdisc_state_dict,
    generator_state_dict,
)
from test_torch_port_threads import one_torch_thread  # noqa: F401


FEATURE_MATCHING_RTOL = 5e-3     # module docstring


def _loss_rtol(key: str, spatial: set) -> float:
    if key.split("/")[1] in ("err_g_adv_s", "err_g_adv"):
        return FEATURE_MATCHING_RTOL
    return TRAIN_D_RTOL if key in spatial else 0.0


def _identity_dropout(self, inputs, *args, **kwargs):
    return inputs


def _jax_engine(cfg, netg, flows):
    """A JAX engine's step methods, without the mesh and init its
    constructor builds, the flows injected."""
    jeng = object.__new__(JaxEngine)
    jeng.cfg = cfg
    jeng.netg = netg
    jeng.netd = JaxDualDisc(ndf=NDF, dtype=jnp.float32)
    jeng.tx_g, jeng.tx_d = make_adam(cfg.lr, cfg.beta1), make_adam(
        cfg.lr, cfg.beta1)
    shared = jnp.asarray(flows)
    jeng._flow = lambda v, streams=1: shared
    return jeng


def _bn_close(got_sd, want: dict, spatial_prefix="spatdisc"):
    for k, v in want.items():
        if "running" in k:
            tol = max(TRAIN_D_RTOL * np.abs(v).max() + ATOL, 5e-5) \
                if k.startswith(spatial_prefix) else ATOL
            np.testing.assert_allclose(got_sd[k].numpy(), v, rtol=0,
                                       atol=tol, err_msg=k)


# -- --ae ---------------------------------------------------------------------

def test_ae_gan_core_step_matches_jax(tmp_path, monkeypatch):
    """One ``_gan_core`` step with the AutoEncoder as G, from the same
    bridged weights and injected flows; b1 (the full-width AutoEncoder is
    the slow part, and its 4 x 4 bottleneck still gives BatchNorm 16
    values per channel)."""
    monkeypatch.setattr(fnn.Dropout, "__call__", _identity_dropout)
    cfg = _cfg(tmp_path, ae=True)
    b = 1
    rng = np.random.default_rng(8)
    data = rng.uniform(-1, 1, (b, T, S, S, 3)).astype(np.float32)
    gt = (rng.uniform(size=(b, T, S, S, 1)) > 0.85).astype(np.float32)
    flows = rng.uniform(-1, 1, (2 * b, T, S, S, 3)).astype(np.float32)

    jeng = _jax_engine(cfg, JaxAutoEncoder(dtype=jnp.float32), flows)
    x = jnp.zeros((b, T, S, S, 3), jnp.float32)
    g_vars = _jax_init(jeng.netg, x)
    d_vars = _jax_init(jeng.netd, x, x)
    g_state, d_state, want, _ = jax.jit(jeng._gan_core)(
        JaxNetState.create(g_vars, jeng.tx_g),
        JaxNetState.create(d_vars, jeng.tx_d), jnp.asarray(data),
        jnp.asarray(gt), jax.random.key(0))

    port = MyGanEngine(cfg, None, None, device=torch.device("cpu"))
    assert isinstance(port.netg, AutoEncoder)
    _load(port.netg, autoencoder_state_dict(g_vars))
    _load(port.netd, dualdisc_state_dict(d_vars))
    for m in port.netg.modules():
        if hasattr(m, "drop_rate"):
            m.drop_rate = 0.0
    port._flow = lambda v, streams=1: _t(flows)
    got = port._gan_core(_t(data), _t(gt), torch.Generator().manual_seed(0))

    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=_loss_rtol(k, _SPATIAL_TRAIN),
                                   atol=ATOL, err_msg=k)
    g_new = autoencoder_state_dict(_np_tree(g_state.variables()))
    d_new = dualdisc_state_dict(_np_tree(d_state.variables()))
    _step_parity(port.netg.state_dict(), g_new, "", 0.02)
    _step_parity(port.netd.state_dict(), d_new, "tempdisc", 0.02)
    _step_parity(port.netd.state_dict(), d_new, "spatdisc", 0.10)
    _bn_close(port.netg.state_dict(), g_new)
    _bn_close(port.netd.state_dict(), d_new)


def test_ae_run_saves_an_autoencoder_as_netg(tmp_path, capsys):
    engine = trainer.main([
        "--model", "mygan", "--ae", "--batchsize", "1", "--nfr", "16",
        "--isize", "64", "--ndf", "2", "--compute_dtype", "float32",
        "--no-tensorboard", "--synthetic_data", "1",
        "--synthetic_test_batches", "1", "--synthetic_thick_masks", "--ep",
        "1", "--freq", "1", "--device", "cpu", "--result_root",
        str(tmp_path)])
    assert "--Using C2plus1d AutoEncoder as G--" in capsys.readouterr().out
    (g_pth,) = (tmp_path / "mygan").rglob("*_netG.pth")
    saved = torch.load(g_pth, map_location="cpu", weights_only=True)
    AutoEncoder().load_state_dict(saved["state_dict"], strict=True)
    assert engine.global_step == 1


# -- --ref_mode_quirks: MyGAN's train-mode sweep ------------------------------

def test_quirk_eval_step_matches_jax(tmp_path):
    """One batch of the quirk sweep against JAX ``_eval_step_quirk_impl``:
    G and D in train mode (dropout at rate 0 on both sides), the test
    losses, the prediction, and G's and D's BatchNorm running statistics
    after the batch (D's updated twice)."""
    cfg = _cfg(tmp_path, ref_mode_quirks=True)
    rng = np.random.default_rng(9)
    batch = {"data": rng.integers(0, 256, (B, T, S, S, 3), dtype=np.uint8),
             "real": rng.integers(0, 256, (B, T, S, S, 3), dtype=np.uint8),
             "mask": (rng.uniform(size=(B, T, S, S, 1)) > 0.85).astype(
                 np.uint8) * 255}
    flows = rng.uniform(-1, 1, (2 * B, T, S, S, 3)).astype(np.float32)

    jeng = _jax_engine(cfg, JaxGenerator(ngf=4, dtype=jnp.float32,
                                         drop_rate=0.0), flows)
    x = jnp.zeros((B, T, S, S, 3), jnp.float32)
    g_vars = _jax_init(jeng.netg, x)
    d_vars = _jax_init(jeng.netd, x, x)
    _, _, want, viz, g_stats, d_stats = jax.jit(jeng._eval_step_quirk_impl)(
        JaxNetState.create(g_vars, jeng.tx_g),
        JaxNetState.create(d_vars, jeng.tx_d),
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(0))

    port = MyGanEngine(cfg, None, None, device=torch.device("cpu"))
    _load(port.netg, generator_state_dict(g_vars))
    _load(port.netd, dualdisc_state_dict(d_vars))
    port.netg.drop_rate = 0.0
    port._flow = lambda v, streams=1: _t(flows)
    before = {k: v.clone() for k, v in port.netd.state_dict().items()}
    _, m_pre, got, pviz = port._eval_step_quirk_impl(batch)

    assert port.netg.training and port.netd.training
    np.testing.assert_allclose(pviz["pred"].numpy(), np.asarray(viz["pred"]),
                               rtol=0, atol=ATOL)
    assert m_pre.shape == (B, T, S, S, 1)
    assert set(got) == set(want)
    spatial = {k.replace("/train", "/test") for k in _SPATIAL_TRAIN}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=_loss_rtol(k, spatial), atol=ATOL,
                                   err_msg=k)
    _bn_close(port.netg.state_dict(), generator_state_dict(
        {"params": g_vars["params"], "batch_stats": _np_tree(g_stats)}))
    _bn_close(port.netd.state_dict(), dualdisc_state_dict(
        {"params": d_vars["params"], "batch_stats": _np_tree(d_stats)}))
    # two updates per batch: D saw real, then fake
    tracked = "tempdisc.dconv1.bn.num_batches_tracked"
    assert int(port.netd.state_dict()[tracked]) == int(before[tracked]) + 2
    # no parameter moved: the sweep runs under no_grad
    for k, v in before.items():
        if "running" not in k and "tracked" not in k:
            assert torch.equal(port.netd.state_dict()[k], v), k


_GAN_ARGS = ["--model", "mygan", "--batchsize", "1", "--nfr", "16", "--isize",
             "64", "--ngf", "2", "--ndf", "2", "--compute_dtype", "float32",
             "--no-tensorboard", "--ep", "1", "--freq", "1000000", "--device",
             "cpu", "--workers", "1"]


@pytest.fixture(scope="module")
def gan_lists(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sweep_vids"))
    # 48 frames: three 16-frame test windows, fakes only
    return make_dataset(root, n_train=1, n_test=1, frames=48, size=72,
                        include_originals=False)


def _gan_engine(lists, root, *extra):
    return trainer.build_engine([*_GAN_ARGS, "--tr_plist", lists[0],
                                 "--ts_plist", lists[1], "--result_root",
                                 str(root), *extra])


def _buffers(module):
    return {k: v.clone() for k, v in module.state_dict().items()
            if "running" in k}


def test_mygan_quirk_test_sweep_mutates_bn(gan_lists, tmp_path):
    """``tests/test_ref_mode_quirks.py`` for the port: with the flag one
    sweep moves G's and D's running statistics and draws dropout masks
    from the engine's generator; without it neither happens."""
    for flag, moves in ((["--ref_mode_quirks"], True), ([], False)):
        eng = _gan_engine(gan_lists, tmp_path / str(moves), *flag)
        g_before, d_before = _buffers(eng.netg), _buffers(eng.netd)
        rng_before = eng.rng.get_state()
        eng.test()
        g_moved = any(not torch.equal(v, g_before[k])
                      for k, v in _buffers(eng.netg).items())
        d_moved = any(not torch.equal(v, d_before[k])
                      for k, v in _buffers(eng.netd).items())
        assert g_moved == d_moved == moves
        assert torch.equal(eng.rng.get_state(), rng_before) != moves
        assert eng.netg.training == eng.netd.training == moves
        eng.close()


# -- --ref_mode_quirks: the supervised latch ----------------------------------

_CLSTM_ARGS = ["--model", "clstm", "--batchsize", "2", "--nfr", "8",
               "--isize", "16", "--compute_dtype", "float32",
               "--no-tensorboard", "--synthetic_data", "4",
               "--synthetic_test_batches", "1", "--synthetic_thick_masks",
               "--ep", "1", "--freq", "2", "--device", "cpu"]


def test_stuck_in_eval_follows_the_step_as_in_jax(tmp_path):
    eng = trainer.build_engine([*_CLSTM_ARGS, "--ref_mode_quirks",
                                "--result_root", str(tmp_path)])
    jeng = object.__new__(JaxEngineBase)
    jeng.cfg = eng.cfg
    for step in range(0, 7):
        eng.global_step = jeng.global_step = step
        assert eng.stuck_in_eval == jeng.stuck_in_eval == (step > 2)
    eng.close()


@pytest.mark.parametrize("model, extra", [
    ("clstm", []), ("c2plus1d", ["--nfr", "16"])])
def test_supervised_stuck_in_eval_freezes_bn(tmp_path, model, extra):
    """Before the latch (step <= freq) a train step moves the BN running
    statistics; from step freq + 1 they are frozen, dropout draws nothing
    from the generator, and the parameters still move."""
    argv = list(_CLSTM_ARGS)
    argv[1] = model
    eng = trainer.build_engine([*argv, *extra, "--ref_mode_quirks",
                                "--result_root", str(tmp_path)])
    batch = next(iter(eng.train_iter))

    eng.global_step = 1
    before = _buffers(eng.model)
    eng._train_step_impl(batch)
    assert eng.model.training
    assert any(not torch.equal(v, before[k])
               for k, v in _buffers(eng.model).items())

    eng.global_step = eng.cfg.freq + 1
    frozen = _buffers(eng.model)
    params = {k: v.detach().clone() for k, v in
              eng.model.named_parameters()}
    tracked = {k: int(v) for k, v in eng.model.state_dict().items()
               if k.endswith("num_batches_tracked")}
    eng._train_step_impl(batch)
    assert not eng.model.training
    for k, v in _buffers(eng.model).items():
        assert torch.equal(v, frozen[k]), k
    assert tracked == {k: int(v) for k, v in eng.model.state_dict().items()
                       if k.endswith("num_batches_tracked")}
    assert any(not torch.equal(v, params[k])
               for k, v in eng.model.named_parameters())
    eng.close()


def test_supervised_default_keeps_training_mode(tmp_path):
    eng = trainer.build_engine([*_CLSTM_ARGS, "--result_root",
                                str(tmp_path)])
    batch = next(iter(eng.train_iter))
    eng.global_step = 10 ** 6
    assert not eng.stuck_in_eval
    before = _buffers(eng.model)
    eng._train_step_impl(batch)
    assert eng.model.training
    assert any(not torch.equal(v, before[k])
               for k, v in _buffers(eng.model).items())
    eng.close()


def test_latch_engages_after_the_first_periodic_test_of_a_run(tmp_path):
    eng = trainer.build_engine([*_CLSTM_ARGS, "--ref_mode_quirks",
                                "--result_root", str(tmp_path)])
    modes = []
    step = eng._step

    def recording_step(*args):
        out = step(*args)
        modes.append(eng.model.training)
        return out

    eng._step = recording_step
    eng.train()
    eng.close()
    # freq 2: steps 1 and 2 in train mode, 3 and 4 in eval mode
    assert modes == [True, True, False, False]


# -- --cache_gt_flow ----------------------------------------------------------

def _recorded_sweep(eng):
    """One ``test()`` with every ``_flow`` call and every eval step's
    outputs recorded: returns ((clips, streams) per flow call, clip index
    -> (m_pre, gt flow), metrics, scores)."""
    calls, per_clip = [], {}
    flow = eng._flow
    steps = {name: getattr(eng, name) for name in (
        "_eval_step_impl", "_eval_step_cached_impl")}

    def recording_flow(video, streams=1):
        calls.append((video.shape[0], streams))
        return flow(video, streams=streams)

    def recording(name):
        def run(batch, *args):
            out = steps[name](batch, *args)
            for j, i in enumerate(batch["index"]):
                per_clip[int(i)] = (out[1][j].clone(),
                                    out[3]["gt_flow"][j].clone())
            return out
        return run

    eng._flow = recording_flow
    for name in steps:
        setattr(eng, name, recording(name))
    try:
        scores = eng.test()
    finally:
        eng._flow = flow
        for name, fn in steps.items():
            setattr(eng, name, fn)
    return calls, per_clip, dict(eng.errors), scores


def test_cached_sweep_equals_the_uncached_sweep(gan_lists, tmp_path):
    cached = _gan_engine(gan_lists, tmp_path / "c", "--cache_gt_flow")
    plain = _gan_engine(gan_lists, tmp_path / "p")
    first = _recorded_sweep(cached)
    assert first[0] == [(2, 2)] * 3             # both streams, three clips
    assert sorted(cached._gt_flow_cache) == [0, 1, 2]
    second = _recorded_sweep(cached)
    assert second[0] == [(1, 1)] * 3            # the predicted stream only
    want = [_recorded_sweep(plain) for _ in range(2)]
    assert want[1][0] == [(2, 2)] * 3 and plain._gt_flow_cache == {}
    for got, ref in zip((first, second), want):
        assert sorted(got[1]) == sorted(ref[1]) == [0, 1, 2]
        for i in ref[1]:
            # the scored masks, and the gt flows: the second sweep's are
            # the first sweep's, whatever the sweeps' orders
            assert torch.equal(got[1][i][0], ref[1][i][0])
            assert torch.equal(got[1][i][1], first[1][i][1])
            assert torch.equal(got[1][i][1], ref[1][i][1])
        np.testing.assert_array_equal(got[3], ref[3])       # roc, pr, f1
        # at batch size 1 the cached flow is the batch's own: D's test
        # losses agree too
        assert got[2] == ref[2]
    cached.close()
    plain.close()


def test_cache_is_bypassed_under_ref_mode_quirks_and_without_an_index(
        gan_lists, tmp_path):
    eng = _gan_engine(gan_lists, tmp_path / "q", "--cache_gt_flow",
                      "--ref_mode_quirks")
    eng.test()
    assert eng._gt_flow_cache == {}
    eng.close()
    synthetic = trainer.build_engine([
        *_GAN_ARGS, "--cache_gt_flow", "--synthetic_data", "1",
        "--synthetic_test_batches", "1", "--result_root",
        str(tmp_path / "s")])
    synthetic.test()
    assert synthetic._gt_flow_cache == {}
    synthetic.close()
