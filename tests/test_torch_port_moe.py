"""The port's MoE layer (``parallel/moe.py``), block and ``--moe_experts``
Xception against the JAX package's on the CPU (one device, no mesh).

* ``moe_apply`` with the JAX tests' expert (``tanh(h @ w + b)``), E 4, D 8,
  T 16:
  - cf = E (no token can drop): equal to JAX's layer and to the dense
    per-token oracle within float32 rounding (rtol 1e-5, atol 1e-6, as
    ``tests/test_moe.py`` holds JAX's), ``dropped_frac`` 0;
  - cf 0.5 (C 2): the routing, ``dropped_frac`` and which rows are zero
    equal JAX's exactly, the kept rows within float32 rounding;
  - the gradients of a loss through the layer, to the expert parameters,
    the router and the tokens, equal JAX's (rtol 1e-4, atol 1e-6, as
    ``tests/test_moe.py``);
  - the load-balancing loss equals JAX's (rtol 1e-6) with and without drops.
* Xception at ``--xwidth 0.0625``, ``--moe_experts 4``, b2, T8, 32^2, from
  JAX's variables through the weight bridge (``moe.*`` keys):
  - the eval forward equals JAX's within 1e-5;
  - one float32 train step (augment draws injected, dropout off) equals
    the JAX engine's: the loss with its ``moe_aux_w`` term within 1e-5,
    every parameter (the MoE block's too) within Adam's first-step
    envelope of 2.5 lr, the running statistics within 1e-5.  The
    gradient itself (Adam's first moment) is held to the port's own
    float64 step from the same weights and clip: within ``F64_RTOL``
    (relative L2, median tensor and whole; measured 0.9% / 1.0%), and no
    further from it than JAX's float32 step (measured 19% / 16%: the
    gradient is ill-conditioned at this size, and the layer's own
    gradients equal JAX's, ``test_moe_apply_gradients_equal_jax``), so
    the 2%-beyond-5e-6 share of ``tests/test_torch_port_supervised_
    step.py`` does not hold against JAX here (3.7% of the elements);
  - one bfloat16 step is held by ``tests/test_torch_port_bf16_step.py``'s
    criteria (loss 1e-2 relative, parameters 2.5 lr, the gradient's
    median tensor and whole within its Xception bound where a control
    step misses), in eval mode (the ``--ref_mode_quirks`` latch, as
    ``chip_smoke.py`` holds Xception's bf16 step): in train mode bf16
    routes tokens to other experts than float64 does.  The head bias is
    left out of the whole: JAX sums its gradient in bf16 (2^-7, where the
    port's float64 step gives 0.0738; asserted over 50% off), and the
    port's is held to its float64 step within 1%;
  - one ``--accum 2`` step equals its manual two-microbatch reference bit
    for bit, each microbatch's loss carrying its own aux term, as
    ``tests/test_torch_port_accum.py`` holds accumulated steps;
  - a port run's ``weights/latest.pt`` loads through ``cli.infer._load``
    ``strict=True`` with its MoE block.
* ``--moe_shards 2`` (refused until it was ported): built in one process,
  the engine holds the option and every expert
  (``tests/test_torch_port_ep.py`` runs it over ranks).
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_bf16_step import (
    GRAD_RTOL,
    _losses_close,
    _params_close,
    jax_moments,
)
from tests.test_torch_port_supervised import _np_tree
from vfd_gan_tpu_torch.ops.augment import augment_clips
from vfd_gan_tpu.config import Config as JaxConfig
from vfd_gan_tpu.models import build_mask_model as jax_build
from vfd_gan_tpu.ops import augment as jaug
from vfd_gan_tpu.parallel.moe import moe_apply as jax_moe_apply
from vfd_gan_tpu.train.state import NetState as JaxNetState
from vfd_gan_tpu.train.state import make_adam
from vfd_gan_tpu.train.supervised_engine import (
    SupervisedEngine as JaxSupervisedEngine,
)
from vfd_gan_tpu_torch.cli import infer, trainer
from vfd_gan_tpu_torch.config import Config
from vfd_gan_tpu_torch.models.xception3d import Xception3D
from vfd_gan_tpu_torch.ops import augment
from vfd_gan_tpu_torch.ops.image import to_channel_first, to_channel_last
from vfd_gan_tpu_torch.ops.losses import bce
from vfd_gan_tpu_torch.parallel.moe import capacity, moe_apply
from vfd_gan_tpu_torch.train import supervised_engine
from vfd_gan_tpu_torch.train.state import relative_distances
from vfd_gan_tpu_torch.train.supervised_engine import SupervisedEngine
from vfd_gan_tpu_torch.utils.weights import xception_state_dict
from test_torch_port_threads import one_torch_thread  # noqa: F401

E, D, T = 4, 8, 16
ATOL = 1e-5
B, NFR, S, XWIDTH, EXPERTS = 2, 8, 32, 0.0625, 4
CPU = torch.device("cpu")
# the float32 step's gradient against the port's float64 step (docstring)
F64_RTOL = 0.1


def _layer_inputs(seed):
    rng = np.random.default_rng(seed)
    params = {"w": (rng.normal(size=(E, D, D)) * 0.4).astype(np.float32),
              "b": (rng.normal(size=(E, D)) * 0.1).astype(np.float32)}
    router = rng.normal(size=(D, E)).astype(np.float32)
    x = rng.normal(size=(T, D)).astype(np.float32)
    return params, router, x


def _jax_expert(p, h):
    return jnp.tanh(h @ p["w"] + p["b"])


def _port_layer(params, router, x, cf):
    w, b = params["w"], params["b"]
    return moe_apply(lambda h: torch.tanh(torch.matmul(h, w) + b[:, None]),
                     router, x, capacity_factor=cf)


def _torch(*arrays):
    return [torch.from_numpy(a).requires_grad_() for a in arrays]


@pytest.mark.parametrize("cf", [float(E), 0.5], ids=["no_drops", "drops"])
def test_moe_apply_equals_jax(cf):
    params, router, x = _layer_inputs(0)
    want, jaux = jax_moe_apply(_jax_expert, jax.tree_util.tree_map(
        jnp.asarray, params), jnp.asarray(router), jnp.asarray(x),
        capacity_factor=cf)
    want = np.asarray(want)
    w, b, r, xt = _torch(params["w"], params["b"], router, x)
    got, aux = _port_layer({"w": w, "b": b}, r, xt, cf)
    got = got.detach().numpy()
    assert float(aux["dropped_frac"]) == float(jaux["dropped_frac"])
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(aux["load_balance_loss"].detach()),
                               float(jaux["load_balance_loss"]), rtol=1e-6)
    if cf == float(E):
        assert float(aux["dropped_frac"]) == 0.0
        # the dense oracle: every token through its argmax expert, gated
        with torch.no_grad():
            probs = torch.softmax(xt @ r, -1)
            choice = probs.argmax(-1)
            dense = torch.tanh(torch.einsum("td,tde->te", xt, w[choice])
                               + b[choice]) * probs.amax(-1)[:, None]
        np.testing.assert_allclose(got, dense.numpy(), rtol=1e-5, atol=1e-6)
    else:
        assert capacity(T, E, cf) == 2
        assert 0 < float(aux["dropped_frac"]) < 1


@pytest.mark.parametrize("cf", [float(E), 0.5], ids=["no_drops", "drops"])
def test_moe_apply_gradients_equal_jax(cf):
    params, router, x = _layer_inputs(3)
    tgt = np.random.default_rng(9).normal(size=(T, D)).astype(np.float32)

    def jax_loss(p, r, x):
        y, aux = jax_moe_apply(_jax_expert, p, r, x, capacity_factor=cf)
        return jnp.mean((y - tgt) ** 2) + 0.1 * aux["load_balance_loss"]

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(router),
        jnp.asarray(x))
    w, b, r, xt = _torch(params["w"], params["b"], router, x)
    y, aux = _port_layer({"w": w, "b": b}, r, xt, cf)
    loss = torch.mean((y - torch.from_numpy(tgt)) ** 2) \
        + 0.1 * aux["load_balance_loss"]
    loss.backward()
    for got, ref in ((w.grad, want[0]["w"]), (b.grad, want[0]["b"]),
                     (r.grad, want[1]), (xt.grad, want[2])):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-6)


# -- Xception with the MoE block --------------------------------------------

def _cfgs(tmp_path, **kw):
    fields = dict(model="xception", batchsize=B, nfr=NFR, isize=S, ep=1,
                  xwidth=XWIDTH, moe_experts=EXPERTS,
                  compute_dtype="float32", tensorboard=False,
                  result_root=str(tmp_path))
    fields.update(kw)
    return JaxConfig(**fields).validate(), Config(**fields).validate()


@pytest.fixture(scope="module")
def jax_xception():
    """The JAX model and random variables of its shapes (``eval_shape``: no
    compile), drawn as its initialisers draw them: kernels, the router and
    the experts ~ N(0, 0.02), BatchNorm scales ~ N(1, 0.02), other biases
    and the statistics at their init values but the head bias."""
    jcfg, _ = _cfgs("results")
    model = jax_build("xception", jcfg, jnp.float32)
    x = jnp.zeros((B, NFR, S, S, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.key(0), "dropout": jax.random.key(0)}, x,
        False))
    shapes = {k: shapes[k] for k in ("params", "batch_stats")}
    rng = np.random.default_rng(0)

    def fill(path, leaf):
        name = path[-1].key
        if name == "var":
            return np.ones(leaf.shape, np.float32)
        if name in ("mean", "experts_b1", "experts_b2") or (
                name == "bias" and "BatchNorm_0" in str(path)):
            return np.zeros(leaf.shape, np.float32)
        if name == "scale":
            return rng.normal(1, 0.02, leaf.shape).astype(np.float32)
        if name == "head_bias":
            return rng.uniform(-0.1, 0.1, leaf.shape).astype(np.float32)
        return rng.normal(0, 0.02, leaf.shape).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    assert set(variables["params"]["moe"]) == {
        "router", "experts_w1", "experts_b1", "experts_w2", "experts_b2"}
    return model, variables


def _port_model(variables, **kw):
    model = Xception3D(3, XWIDTH, moe_experts=EXPERTS, **kw)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           xception_state_dict(variables).items()},
                          strict=True)
    return model


def test_moe_xception_forward_equals_jax(jax_xception):
    model, variables = jax_xception
    x = np.random.default_rng(1).uniform(-1, 1, (B, NFR, S, S, 3)).astype(
        np.float32)
    want = jax.jit(lambda v, x: model.apply(v, x, False))(
        variables, jnp.asarray(x))
    port = _port_model(variables).eval()
    with torch.no_grad():
        got = to_channel_last(port(to_channel_first(torch.from_numpy(x))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    assert float(port.moe.aux["dropped_frac"]) < 1


def _batch_and_draws():
    s = augment.staging_size(S)
    rng = np.random.default_rng(4)
    data = rng.integers(0, 256, (B, NFR, s, s, 3), dtype=np.uint8)
    mask = np.zeros((B, NFR, s, s, 1), np.uint8)
    mask[:, :, 4:s - 4, 5:s - 6] = 255
    draws = (np.linspace(-0.17, 0.15, B).astype(np.float32),
             np.arange(B, dtype=np.int32) % 2, np.ones(B, np.int32),
             np.arange(B) % 2 == 0)
    return {"data": data, "real": data, "mask": mask}, draws


def _jax_step(monkeypatch, jcfg, variables, batch, draws, dtype,
              train_mode=True):
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, inputs, *a, **k: inputs)
    monkeypatch.setattr(jaug, "sample_clip_params",
                        lambda *a, **k: tuple(map(jnp.asarray, draws)))
    jeng = object.__new__(JaxSupervisedEngine)
    jeng.cfg, jeng.pipe = jcfg, None
    jeng.model = jax_build("xception", jcfg, dtype)
    jeng.tx = make_adam(jcfg.lr, jcfg.beta1)
    return jax.jit(jeng._train_step_impl, static_argnums=(3,))(
        JaxNetState.create(variables, jeng.tx),
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(0),
        train_mode)


def _port_engine(monkeypatch, cfg, variables, draws):
    monkeypatch.setattr(supervised_engine, "sample_clip_params",
                        lambda *a, **k: (torch.from_numpy(draws[0]),
                                         torch.from_numpy(draws[1]).long(),
                                         torch.from_numpy(draws[2]).long(),
                                         torch.from_numpy(draws[3])))
    eng = SupervisedEngine(cfg, None, None, device=CPU)
    eng.model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                               xception_state_dict(variables).items()},
                              strict=True)
    for m in eng.model.modules():
        if hasattr(m, "drop_rate"):
            m.drop_rate = 0.0
    return eng


def _f64_moments(monkeypatch, cfg, variables, batch, draws) -> dict:
    """Adam's first moments after the port's step in float64 (the model
    and the augmented clip; the head's sigmoid stays float32)."""
    eng = _port_engine(monkeypatch, cfg, variables, draws)
    eng.global_step = 0 if not cfg.ref_mode_quirks else cfg.freq + 1
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    data, _, gt = augment_clips(supervised_engine.sample_clip_params(),
                                b["data"], b["real"], b["mask"], S)
    eng.model.double()
    eng.model.moe.dtype = torch.float64
    eng.net.optimizer = torch.optim.Adam(eng.model.parameters(), lr=cfg.lr,
                                         betas=(cfg.beta1, 0.999))
    eng._step(data.double(), gt)
    return eng.net.first_moments()


def test_moe_xception_step_matches_jax(jax_xception, tmp_path, monkeypatch):
    _, variables = jax_xception
    jcfg, cfg = _cfgs(tmp_path)
    batch, draws = _batch_and_draws()
    state, loss, _ = _jax_step(monkeypatch, jcfg, variables, batch, draws,
                               jnp.float32)
    eng = _port_engine(monkeypatch, cfg, variables, draws)
    got = eng._train_step_impl({k: torch.from_numpy(v)
                                for k, v in batch.items()})
    # the aux term is in the loss: without it the loss is bce alone
    aux = float(eng.model.moe.aux["load_balance_loss"])
    assert aux > 0.5
    np.testing.assert_allclose(float(got["loss/err/train"]), float(loss),
                               rtol=0, atol=ATOL)
    new = xception_state_dict(_np_tree(state.variables()))
    sd = eng.model.state_dict()
    _params_close(sd, new)
    for k, v in new.items():
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), v, rtol=0, atol=ATOL,
                                       err_msg=k)
    old = xception_state_dict(variables)
    moved = np.abs(sd["moe.router"].numpy() - old["moe.router"]).max()
    assert 0.5 * cfg.lr < moved < 2 * cfg.lr
    exact = _f64_moments(monkeypatch, cfg, variables, batch, draws)
    median, whole = relative_distances(eng.net.first_moments(), exact)
    jax_median, jax_whole = relative_distances(
        jax_moments(state, xception_state_dict), exact)
    assert median <= F64_RTOL and whole <= F64_RTOL, (median, whole)
    assert median <= jax_median and whole <= jax_whole, (jax_median,
                                                         jax_whole)


def test_moe_xception_bf16_step_matches_jax(jax_xception, tmp_path,
                                            monkeypatch):
    _, variables = jax_xception
    jcfg, cfg = (dataclasses.replace(c, compute_dtype="bfloat16",
                                     ref_mode_quirks=True)
                 for c in _cfgs(tmp_path))
    batch, draws = _batch_and_draws()
    state, loss, _ = _jax_step(monkeypatch, jcfg, variables, batch, draws,
                               jnp.bfloat16, train_mode=False)

    def port_step(data):
        eng = _port_engine(monkeypatch, cfg, variables, draws)
        eng.global_step = cfg.freq + 1          # the latch: eval mode
        got = eng._train_step_impl({"data": torch.from_numpy(data),
                                    "real": torch.from_numpy(data),
                                    "mask": torch.from_numpy(batch["mask"])})
        assert not eng.model.training
        return eng, got

    # the control: the same step on the clip reversed in time and mirrored
    control = port_step(batch["data"][:, ::-1, :, ::-1].copy())[0].net
    eng, got = port_step(batch["data"])
    assert eng.model.moe.dtype == torch.bfloat16
    new = xception_state_dict(_np_tree(state.variables()))
    _losses_close({"loss/err/train": got["loss/err/train"]},
                  {"loss/err/train": loss})
    _params_close(eng.model.state_dict(), new)
    # moments_close's criterion without the head bias (docstring)
    head = "conv_last.bias"
    want = jax_moments(state, xception_state_dict)
    mine, ctl = eng.net.first_moments(), control.first_moments()
    keys = [k for k in mine if k != head]
    median, whole = relative_distances({k: mine[k] for k in keys},
                                       {k: want[k] for k in keys})
    missed, _ = relative_distances({k: ctl[k] for k in keys},
                                   {k: want[k] for k in keys})
    rtol = GRAD_RTOL["xception"]
    assert median <= rtol and whole <= rtol < missed, (median, whole, missed)
    exact = _f64_moments(monkeypatch, dataclasses.replace(
        cfg, compute_dtype="float32"), variables, batch, draws)
    np.testing.assert_allclose(float(mine[head].norm()),
                               float(exact[head].norm()), rtol=1e-2)
    assert abs(float(want[head].norm()) - float(exact[head].norm())) \
        > 0.5 * float(exact[head].norm())
    # eval mode: no BatchNorm statistic moves, on either side
    sd = eng.model.state_dict()
    for k, v in new.items():
        if "running" in k:
            np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


def test_moe_xception_accum_step_equals_manual_reference(tmp_path):
    """``--accum 2``: one step of the engine against the same two
    microbatches by hand, from one state: bce plus ``moe_aux_w`` times each
    microbatch's own load-balancing loss, the ``.grad`` summed and halved,
    one Adam step; bit for bit."""
    _, cfg = _cfgs(tmp_path, accum=2)
    rng = np.random.default_rng(7)
    data = torch.from_numpy(rng.uniform(-1, 1, (B, NFR, S, S, 3)).astype(
        np.float32))
    gt = torch.from_numpy((rng.uniform(size=(B, NFR, S, S, 1)) > 0.7)
                          .astype(np.float32))
    engines = [SupervisedEngine(cfg, None, None, device=CPU)
               for _ in range(2)]
    for eng in engines:
        for m in eng.model.modules():
            if hasattr(m, "drop_rate"):
                m.drop_rate = 0.0
    got = engines[0]._step(data, gt)

    ref = engines[1]
    model = ref.model.train()
    params = list(model.parameters())
    total, losses = [None] * len(params), []
    for d, g in zip(data.chunk(2), gt.chunk(2)):
        ref.net.optimizer.zero_grad(set_to_none=True)
        loss = bce(to_channel_last(model(to_channel_first(d))), g) \
            + cfg.moe_aux_w * model.moe.aux["load_balance_loss"]
        loss.backward()
        losses.append(loss.detach())
        for i, p in enumerate(params):
            if p.grad is not None:
                total[i] = p.grad.clone() if total[i] is None \
                    else total[i] + p.grad
    for a, p in zip(total, params):
        p.grad = None if a is None else a / 2
    ref.net.optimizer.step()

    assert torch.equal(got["loss/err/train"], (losses[0] + losses[1]) / 2)
    for (k, a), b in zip(engines[0].model.state_dict().items(),
                         ref.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_latest_pt_of_a_moe_run_loads_through_infer(tmp_path):
    engine = trainer.main([
        "--model", "xception", "--xwidth", str(XWIDTH), "--moe_experts",
        str(EXPERTS), "--batchsize", "2", "--nfr", str(NFR), "--isize",
        str(S), "--compute_dtype", "float32", "--synthetic_data", "2",
        "--synthetic_test_batches", "1", "--ep", "1", "--freq", "100",
        "--max_steps", "1", "--autosave_every", "1", "--no-tensorboard",
        "--device", "cpu", "--result_root", str(tmp_path)])
    latest, = tmp_path.rglob("latest.pt")
    model, name = infer._load(str(latest), CPU)
    assert isinstance(model, Xception3D) and not model.training
    assert name == "XceptionNet" and model.moe is not None
    assert model.moe.router.shape[1] == EXPERTS
    for k, v in engine.model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


def test_moe_shards_is_refused_as_parallelism(tmp_path):
    """Ported since: the engine is built and holds the option (the name is
    the refusal test's).  Built in one process it holds the 4 experts;
    the command starts an ep group (``tests/test_torch_port_ep.py``)."""
    engine = trainer.build_engine([
        "--model", "xception", "--xwidth", str(XWIDTH), "--moe_experts",
        "4", "--moe_shards", "2", "--synthetic_data", "2", "--device",
        "cpu", "--no-tensorboard", "--result_root", str(tmp_path)])
    try:
        assert engine.cfg.moe_shards == 2 and engine.shards is None
        assert engine.model.moe.experts_w1.shape[0] == 4
    finally:
        engine.close()
