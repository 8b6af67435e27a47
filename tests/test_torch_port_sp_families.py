"""``--sp`` for Xception and GANomaly, and MyGAN's ``--accum``,
``--int8_disc``, ``--cache_gt_flow`` and ``--ref_mode_quirks`` under it,
on the CPU over gloo ranks: against the same steps in one process, and
against JAX's step on a ``{"dp": 1, "sp": 2}`` mesh.

Two groups of ranks are started once for the module, side by side
(``ranks``): one of 2 ranks (an sp 2 row) and one of 8 (an sp 8 row:
one frame a shard).  The ranks run ``vfd_gan_tpu_torch.tools.
dp_equivalence`` (no rank imports JAX or this file), each group meeting
through a file under the test's tmp dir and writing to a log file of its
own, with a join timeout of 400 s.

* float64, sp 2 against sp 1 in one process (references in the grid's
  two-pass BatchNorm arithmetic, ``dp_equivalence.OneProcess``), within
  1e-9 (the relative L2 distance of each kind's whole set: parameters,
  BatchNorm buffers, Adam's two moments, the losses), the ranks of a row
  one replica bit for bit, the sweep's scores and saved ``.pth`` names
  sp 1's:
  - Xception (``--xwidth 0.0625``, 32^2, nfr 8, b2), with
    ``--moe_experts 2`` at capacity factor 0.5 (C 16 of 64 tokens an
    expert: half the tokens drop, in sp 1 as in sp 2), with
    ``--ref_mode_quirks --freq 1`` (3 steps: steps 2 and 3 past the
    latch, in eval mode), and with ``--accum 2`` at b4 (microbatches of
    two clips: at b2 a microbatch is one clip, whose BatchNorms over 32
    values a channel amplify the round-off between one sum and the
    grid's two partial sums to 4.5e-9 in Adam's moments, measured; at b4
    3.7e-11);
  - GANomaly (16^2, nfr 8, b2; seed 2, whose sweep batch holds a fake
    and a real clip, so the frame ROC is defined and a ``.pth`` pair is
    saved);
  - MyGAN (64^2, nfr 16, b2, ngf = ndf = 2, the flow stand-in of
    ``tests/test_torch_port_dp.py``) with each of ``--accum 2``,
    ``--int8_disc``, ``--cache_gt_flow`` (a sweep after step 1 fills the
    cache, the final one reads it) and ``--ref_mode_quirks`` (a sweep
    after step 1 runs G and D in train mode and moves their statistics
    and the dropout generator before step 2).
* the controls land at least 1000x farther than the sp 2 run and 1000x
  past the bound in every kind: BatchNorm statistics over the rank's
  frames alone (Xception and GANomaly), the MoE slots counted on each
  rank alone, the int8 absmax of each rank's tensor alone.
* one frame a shard: an 8-rank row at ``--nfr 8 --sp 8`` for Xception
  and GANomaly in float64 against sp 1; MyGAN's refusal of a one-frame
  shard (its flow pairs frames) beside JAX's rule, which takes it.
* float32: the port's sp 2 step of Xception (plain, and with
  ``--moe_experts 2`` at capacity factor 0.5) and of GANomaly passes
  ``parallel/verify.py``'s gate against JAX's step on a ``{"dp": 1,
  "sp": 2}`` mesh, with JAX's sp 1 step as the yardstick (augment draws
  given, dropout off); with MoE every token's slot and kept flag equal
  JAX's.
* the MoE eval routing: the port's eval forward of ``--moe_experts 4``
  Xception and JAX's, on the same weights and clip, route alike: the same
  slots, the same kept set and ``dropped_frac``.
* the trainer's ``--model xception --dp 2 --sp 2`` command (4 ranks,
  rank 0 alone writes).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tests.test_torch_port_supervised_step import _identity_dropout
from vfd_gan_tpu.config import Config as JaxConfig
from vfd_gan_tpu.models import build_mask_model as jax_build
from vfd_gan_tpu.models import ganomaly as jganomaly
from vfd_gan_tpu.models import moe_block as jmoe_block
from vfd_gan_tpu.ops import augment as jaug
from vfd_gan_tpu.parallel import moe as jmoe
from vfd_gan_tpu.train import ganomaly_engine as jganomaly_engine
from vfd_gan_tpu.train.state import NetState as JaxNetState
from vfd_gan_tpu.train.state import make_adam
from vfd_gan_tpu.train.supervised_engine import (
    SupervisedEngine as JaxSupervisedEngine,
)
from vfd_gan_tpu_torch.cli import trainer
from vfd_gan_tpu_torch.models.xception3d import Xception3D
from vfd_gan_tpu_torch.ops.augment import staging_size
from vfd_gan_tpu_torch.ops.image import to_channel_first
from vfd_gan_tpu_torch.parallel import verify
from vfd_gan_tpu_torch.parallel.moe import moe_apply
from vfd_gan_tpu_torch.utils.weights import (
    ganomaly_discriminator_state_dict,
    ganomaly_generator_state_dict,
    xception_state_dict,
)
from test_torch_port_sp import _children, _Ranks
from test_torch_port_threads import one_torch_thread  # noqa: F401

BOUND = 1e-9
_COMMON = ["--compute_dtype", "float32", "--synthetic_test_batches", "1",
           "--synthetic_thick_masks", "--ep", "1"]


def _xception(sp: int, *extra, batch: int = 2, nfr: int = 8) -> list:
    return ["--model", "xception", "--xwidth", "0.0625", "--batchsize",
            str(batch), "--nfr", str(nfr), "--isize", "32", "--sp", str(sp),
            "--synthetic_data", "3", "--seed", "3", *extra, *_COMMON]


def _ganomaly(sp: int, *extra, nfr: int = 8) -> list:
    return ["--model", "ganomaly", "--batchsize", "2", "--nfr", str(nfr),
            "--isize", "16", "--sp", str(sp), "--synthetic_data", "2",
            "--seed", "2", *extra, *_COMMON]


def _mygan(sp: int, *extra) -> list:
    return ["--model", "mygan", "--batchsize", "2", "--nfr", "16",
            "--isize", "64", "--ngf", "2", "--ndf", "2", "--sp", str(sp),
            "--synthetic_data", "2", "--seed", "3", *extra, *_COMMON]


MOE = ("--moe_experts", "2")
# name: (command line at sp, case settings); each run at sp 2 against sp 1
RUNS = {
    "xception": (_xception, (), {}),
    "xception-moe": (_xception, MOE, {"moe_capacity": 0.5}),
    "xception-accum": (lambda sp, *e: _xception(sp, *e, batch=4),
                       ("--accum", "2"), {}),
    "xception-quirks": (_xception, ("--ref_mode_quirks", "--freq", "1"),
                        {"steps": 3}),
    "ganomaly": (_ganomaly, (), {}),
    "mygan-accum": (_mygan, ("--accum", "2"), {"flow": "standin"}),
    "mygan-int8_disc": (_mygan, ("--int8_disc",), {"flow": "standin"}),
    "mygan-cache_gt_flow": (_mygan, ("--cache_gt_flow",),
                            {"flow": "standin", "sweep_at": [1]}),
    "mygan-ref_mode_quirks": (_mygan, ("--ref_mode_quirks",),
                              {"flow": "standin", "sweep_at": [1]}),
}
# control: (the run it is the sp 2 step of, the reduction left local)
CONTROLS = {"xception.bn_sp": ("xception", "bn_sp"),
            "ganomaly.bn_sp": ("ganomaly", "bn_sp"),
            "xception-moe.moe": ("xception-moe", "moe"),
            "mygan-int8_disc.absmax": ("mygan-int8_disc", "absmax")}
# one frame a shard: an sp 8 row
ONE_FRAME = {"xception": lambda sp: _xception(sp, nfr=8),
             "ganomaly": lambda sp: _ganomaly(sp, nfr=8)}
# the float32 steps against JAX: b2, T8, 32^2 (Xception) / 16^2 (GANomaly)
B, T = 2, 8
CF = 0.5                                  # the dropping capacity factor


def _case(run: str, sp: int, **kw) -> dict:
    argv, extra, settings = RUNS[run]
    return {**dict(kind="train", steps=2, float64=True, sweep=True,
                   name=f"{run}.sp{sp}", dp=1 if sp == 1 else 2,
                   argv=argv(sp, *extra)), **settings, **kw}


def _row_cases() -> list:
    refs = [_case(name, 1, arith="dp") for name in RUNS]
    runs = [_case(name, 2, ref=f"{name}.sp1") for name in RUNS]
    controls = [_case(run, 2, name=name, ref=f"{run}.sp1", sweep=False,
                      local_ops=[op])
                for name, (run, op) in CONTROLS.items()]
    return refs + runs + controls


def _one_frame_cases() -> list:
    base = dict(kind="train", steps=2, float64=True, sweep=True)
    return [*(dict(base, name=f"{name}.sp1", dp=1, arith="dp", argv=f(1))
              for name, f in ONE_FRAME.items()),
            *(dict(base, name=f"{name}.sp8", dp=2, ref=f"{name}.sp1",
                   argv=f(8)) for name, f in ONE_FRAME.items())]


# -- the float32 steps' inputs -------------------------------------------

def _jax_xception(moe: bool):
    cfg = JaxConfig(model="xception", batchsize=B, nfr=T, isize=32,
                    xwidth=1 / 16, moe_experts=2 if moe else 0,
                    compute_dtype="float32", tensorboard=False).validate()
    model = jax_build("xception", cfg, jnp.float32)
    if moe:
        model = model.clone(moe_capacity=CF)
    x = jnp.zeros((B, T, 32, 32, 3), jnp.float32)
    variables = jax.jit(lambda k: model.init(
        {"params": k, "dropout": k}, x, False))(jax.random.key(0))
    return cfg, model, jax.tree_util.tree_map(np.asarray, variables)


def _jax_ganomaly():
    cfg = JaxConfig(model="ganomaly", batchsize=B, nfr=T, isize=16,
                    compute_dtype="float32", tensorboard=False).validate()
    g = jganomaly.GanomalyGenerator(isize=16, dtype=jnp.float32)
    d = jganomaly.GanomalyDiscriminator(isize=16, dtype=jnp.float32)
    frames = jnp.zeros((B * T, 16, 16, 3), jnp.float32)
    kg, kd = jax.random.split(jax.random.key(1))
    g_vars = jax.jit(lambda k: g.init({"params": k}, frames, False))(kg)
    d_vars = jax.jit(lambda k: d.init({"params": k}, frames, False))(kd)
    tree = jax.tree_util.tree_map
    return cfg, g, tree(np.asarray, g_vars), d, tree(np.asarray, d_vars)


def _step_batch(size: int) -> tuple[dict, dict]:
    s = staging_size(size)
    rng = np.random.default_rng(4)
    data = rng.integers(0, 256, (B, T, s, s, 3), dtype=np.uint8)
    mask = np.zeros((B, T, s, s, 1), np.uint8)
    mask[:, :, 3:s - 3, 4:s - 5] = 255
    batch = {"data": data, "real": data, "mask": mask}
    draws = {"angle": np.linspace(-0.17, 0.15, B).astype(np.float32),
             "flip": np.arange(B, dtype=np.int32) % 2,
             "crop": np.ones(B, np.int32), "pick": np.arange(B) % 2 == 0}
    return batch, draws


@pytest.fixture(scope="module")
def jax_nets():
    return {"xception": _jax_xception(False),
            "xception-moe": _jax_xception(True),
            "ganomaly": _jax_ganomaly()}


STEPS = {"xception": (32, ()), "xception-moe": (32, MOE),
         "ganomaly": (16, ())}


def _step_cases(root, jax_nets) -> list:
    cases = []
    for name, (size, extra) in STEPS.items():
        batch, draws = _step_batch(size)
        np.savez(root / f"{name}.batch.npz", **batch)
        np.savez(root / f"{name}.draws.npz", **draws)
        if name == "ganomaly":
            _, _, g_vars, _, d_vars = jax_nets[name]
            state = {"netG": ganomaly_generator_state_dict(g_vars),
                     "netD": ganomaly_discriminator_state_dict(d_vars)}
            state = {net: {k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()}
                     for net, sd in state.items()}
            argv = ["--model", "ganomaly", "--batchsize", str(B), "--nfr",
                    str(T), "--isize", "16", "--sp", "2", "--synthetic_data",
                    "1", *_COMMON]
        else:
            state = {k: torch.from_numpy(np.array(v)) for k, v in
                     xception_state_dict(jax_nets[name][2]).items()}
            argv = ["--model", "xception", "--xwidth", "0.0625",
                    "--batchsize", str(B), "--nfr", str(T), "--isize", "32",
                    "--sp", "2", "--synthetic_data", "1", *extra, *_COMMON]
        torch.save(state, root / f"{name}.state.pt")
        cases.append(dict(kind="step_core", name=f"{name}.core", argv=argv,
                          state=str(root / f"{name}.state.pt"),
                          batch=str(root / f"{name}.batch.npz"),
                          draws=str(root / f"{name}.draws.npz"),
                          **({"moe_capacity": CF} if extra else {})))
    return cases


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory, jax_nets, request):
    """Started before the module's first test: the JAX steps run while the
    ranks compute."""
    group = _Ranks(tmp_path_factory.mktemp("sp_families"), 10)
    # the claim on the rank slots given back however the module ends
    request.addfinalizer(group.close)
    group.start(_one_frame_cases(), world=8)
    group.start([*_step_cases(group.root, jax_nets), *_row_cases()],
                world=2)
    yield group


# The tests that run JAX come first: the ranks compute meanwhile.

# -- float32: the sp 2 steps against JAX's on a {"dp": 1, "sp": 2} mesh -----

def _mesh(sp: int) -> Mesh:
    return Mesh(np.asarray(jax.devices()[:sp]).reshape(1, sp), ("dp", "sp"))


def _sharded(batch: dict, sp: int) -> dict:
    frames = NamedSharding(_mesh(sp), P("dp", "sp"))
    return {k: jax.device_put(jnp.asarray(v), frames)
            for k, v in batch.items()}


def _recording_moe(store: list):
    """JAX's ``moe_apply``, also handing each token's slot and kept flag
    (its own formulas) to ``store``."""
    def moe_apply(expert_fn, expert_params, router_w, x, **kw):
        y, aux = jmoe.moe_apply(expert_fn, expert_params, router_w, x, **kw)
        e = router_w.shape[-1]
        c = jmoe.capacity(x.shape[0], e, kw["capacity_factor"])
        probs = jax.nn.softmax((x @ router_w).astype(jnp.float32), -1)
        onehot = jax.nn.one_hot(jnp.argmax(probs, -1), e, dtype=jnp.int32)
        slot = jnp.max(jnp.cumsum(onehot, 0) * onehot - 1, -1)
        jax.debug.callback(
            lambda s, d: store.append((np.asarray(s), float(d))), slot,
            aux["dropped_frac"])
        return y, aux
    return moe_apply


def _jax_xception_step(jax_nets, name: str, sp: int, monkeypatch):
    cfg, model, variables = jax_nets[name]
    batch, draws = _step_batch(32)
    monkeypatch.setattr(fnn.Dropout, "__call__", _identity_dropout)
    monkeypatch.setattr(jaug, "sample_clip_params", lambda *a, **k: tuple(
        jnp.asarray(draws[k]) for k in ("angle", "flip", "crop", "pick")))
    routing = []
    monkeypatch.setattr(jmoe_block, "moe_apply", _recording_moe(routing))
    jeng = object.__new__(JaxSupervisedEngine)
    jeng.cfg, jeng.model, jeng.pipe = cfg, model, None
    jeng.tx = make_adam(cfg.lr, cfg.beta1)
    rep = NamedSharding(_mesh(sp), P())
    state = jax.device_put(JaxNetState.create(variables, jeng.tx), rep)
    state, loss, _ = jax.jit(jeng._train_step_impl, static_argnums=(3,))(
        state, _sharded(batch, sp), jax.random.key(0), True)
    sd = xception_state_dict(jax.tree_util.tree_map(
        np.asarray, state.variables()))
    return {"loss/err/train": float(loss)}, sd, routing


def _jax_ganomaly_step(jax_nets, sp: int, monkeypatch):
    cfg, g, g_vars, d, d_vars = jax_nets["ganomaly"]
    batch, draws = _step_batch(16)
    monkeypatch.setattr(jaug, "sample_clip_params", lambda *a, **k: tuple(
        jnp.asarray(draws[k]) for k in ("angle", "flip", "crop", "pick")))
    jeng = object.__new__(jganomaly_engine.GanomalyEngine)
    jeng.cfg, jeng.netg, jeng.netd = cfg, g, d
    jeng.tx_g = make_adam(cfg.lr, cfg.beta1)
    jeng.tx_d = make_adam(cfg.lr, cfg.beta1)
    rep = NamedSharding(_mesh(sp), P())
    g_state, d_state, metrics, _ = jax.jit(jeng._train_step_impl)(
        jax.device_put(JaxNetState.create(g_vars, jeng.tx_g), rep),
        jax.device_put(JaxNetState.create(d_vars, jeng.tx_d), rep),
        _sharded(batch, sp), jax.random.key(0))
    tree = jax.tree_util.tree_map
    sd = {**{f"netG.{k}": v for k, v in ganomaly_generator_state_dict(
              tree(np.asarray, g_state.variables())).items()},
          **{f"netD.{k}": v for k, v in ganomaly_discriminator_state_dict(
              tree(np.asarray, d_state.variables())).items()}}
    return {k: float(v) for k, v in metrics.items()}, sd, []


def _leaves(sd: dict) -> list:
    return [np.asarray(sd[k], np.float32) for k in sorted(sd)
            if not k.endswith("num_batches_tracked")]


def _jax_step(jax_nets, name, sp, monkeypatch):
    if name == "ganomaly":
        return _jax_ganomaly_step(jax_nets, sp, monkeypatch)
    return _jax_xception_step(jax_nets, name, sp, monkeypatch)


@pytest.mark.parametrize("name", list(STEPS))
def test_sp2_step_passes_the_gate_against_jax_sp2_mesh(ranks, jax_nets,
                                                       name, monkeypatch):
    """The port's float32 sp 2 step against JAX's on a ``{"dp": 1, "sp":
    2}`` mesh, the gate calibrated by JAX's own sp 1 step; with MoE (half
    the tokens dropped) every token's slot and kept flag are JAX's."""
    replica = _jax_step(jax_nets, name, 2, monkeypatch)
    yardstick = _jax_step(jax_nets, name, 1, monkeypatch)
    got, other = (ranks.result(1, f"{name}.core", r) for r in (0, 1))
    assert got["metrics"] == other["metrics"]
    assert all(torch.equal(v, other["state"][k])
               for k, v in got["state"].items())
    port = {k: v.numpy() for k, v in got["state"].items()}
    assert set(port) == set(replica[1])
    rtol, atol = verify.assert_replica_equivalence(
        (replica[0], _leaves(replica[1])),
        (yardstick[0], _leaves(yardstick[1])),
        (got["metrics"], _leaves(port)), label=f"{name} sp2 port vs JAX")
    assert rtol <= verify.REL_CAP and atol <= verify.ABS_CAP
    if name != "xception-moe":
        return
    # JAX lists the tokens (B, T, H, W): the port's ranks hold frames
    # [0, 4) and [4, 8) of each row
    slots, dropped = replica[2][-1]
    want = slots.reshape(B, T, 2, 2)
    mine = [ranks.result(1, f"{name}.core", r)["routing"] for r in (0, 1)]
    port_slots = np.concatenate([m["slot"].numpy() for m in mine], axis=1)
    port_kept = np.concatenate([m["kept"].numpy() for m in mine], axis=1)
    c = jmoe.capacity(want.size, 2, CF)
    np.testing.assert_array_equal(port_slots, want)
    np.testing.assert_array_equal(port_kept, want < c)
    assert dropped == 1 - port_kept.mean() >= 0.5


# -- the MoE eval routing --------------------------------------------------

def _jax_experts(variables):
    params = variables["params"]["moe"]
    experts = {k[len("experts_"):]: jnp.asarray(v) for k, v in params.items()
               if k.startswith("experts_")}

    def expert_fn(p, h):
        h = jax.nn.relu(h @ p["w1"] + p["b1"])
        return h @ p["w2"] + p["b2"]
    return expert_fn, experts, jnp.asarray(params["router"])


def test_moe_eval_routing_is_jaxs(monkeypatch):
    """Why the eval forward of a ``--moe_experts`` Xception at init drops
    tokens and its train steps drop none, in JAX as in the port.  With
    running statistics of 0 and 1 the eval trunk is not normalised: the
    tokens that reach the router are ~1e-6 (here at most 2.2e-6), their
    logits ~1e-8, and every token's float32 softmax lies within 3e-8 of
    1/E, so the argmax is decided by round-off, ties going to the first
    maximal index (expert 0) in both frameworks; where the ties are
    exact, expert 0 takes C = cf T / E = T/2 tokens and drops the other
    half (``dropped_frac`` 0.5, as on the card at full width).  The
    port's and JAX's eval tokens agree to round-off, and no token's top
    two probabilities stand 2 float32 ulps apart; scaled to 1, the same
    tokens take the same slots in JAX's ``moe_apply`` and the port's at
    a dropping capacity; on exactly tied tokens (zeros) both keep the
    first T/2 and drop the rest; in train mode (BatchNorms on the batch)
    both drop none."""
    cfg = JaxConfig(model="xception", batchsize=B, nfr=T, isize=32,
                    xwidth=1 / 16, moe_experts=4, compute_dtype="float32",
                    tensorboard=False).validate()
    model = jax_build("xception", cfg, jnp.float32)
    x = np.random.default_rng(8).uniform(-1, 1, (B, T, 32, 32, 3)).astype(
        np.float32)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: model.init({"params": k, "dropout": k}, jnp.asarray(x),
                             False))(jax.random.key(0)))
    seen = []

    def recording(expert_fn, expert_params, router_w, tokens, **kw):
        y, aux = jmoe.moe_apply(expert_fn, expert_params, router_w, tokens,
                                **kw)
        jax.debug.callback(lambda t, d: seen.append((np.asarray(t),
                                                     float(d))),
                           tokens, aux["dropped_frac"])
        return y, aux

    monkeypatch.setattr(jmoe_block, "moe_apply", recording)
    jax.jit(lambda v, x: model.apply(v, x, False))(variables, jnp.asarray(x))
    jax.jit(lambda v, x: model.apply(
        v, x, True, mutable=["batch_stats", "moe_aux"],
        rngs={"dropout": jax.random.key(1)}))(variables, jnp.asarray(x))
    (jax_tokens, _), (_, jax_train_dropped) = seen

    port = Xception3D(width_mult=1 / 16, moe_experts=4)
    port.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                          xception_state_dict(variables).items()})
    held = {}
    port.moe.register_forward_pre_hook(
        lambda m, args: held.setdefault("x", args[0]))
    with torch.no_grad():
        port.eval()(to_channel_first(torch.from_numpy(x)))
        tokens = held["x"].permute(0, 2, 3, 4, 1).reshape(
            -1, held["x"].shape[1])
        port.train()(to_channel_first(torch.from_numpy(x)),
                     torch.Generator().manual_seed(1))
        train_dropped = float(port.moe.aux["dropped_frac"])
    assert train_dropped == jax_train_dropped == 0.0
    # the eval tokens: unnormalised, tiny, the two frameworks' alike
    scale = float(np.abs(jax_tokens).max())
    assert scale < 1e-5
    np.testing.assert_allclose(tokens.numpy(), jax_tokens, rtol=0,
                               atol=1e-5 * scale)
    expert_fn, experts, router = _jax_experts(variables)
    probs = torch.softmax(tokens @ torch.from_numpy(np.array(router)), -1)
    assert float((probs - 0.25).abs().max()) < 1e-7
    # every decision is a round-off tie: no token's top two probabilities
    # stand 2 float32 ulps apart
    top2 = np.sort(probs.numpy(), -1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0] < 2 * np.spacing(np.float32(0.25))).all()
    # the same tokens scaled to 1 (decisions clear of round-off), at a
    # dropping capacity: JAX's layer and the port's route alike
    scaled = tokens / scale
    store = []
    y, aux = _recording_moe(store)(expert_fn, experts, router,
                                   jnp.asarray(scaled.numpy()),
                                   capacity_factor=CF)
    record = {}
    port_y, port_aux = moe_apply(port.moe._experts, port.moe.router, scaled,
                                 capacity_factor=CF, record=record)
    slots, dropped = store[-1]
    np.testing.assert_array_equal(record["slot"].numpy(), slots)
    np.testing.assert_array_equal(
        record["kept"].numpy(), slots < jmoe.capacity(len(slots), 4, CF))
    assert float(port_aux["dropped_frac"]) == dropped > 0
    np.testing.assert_allclose(port_y.detach().numpy(), np.asarray(y),
                               rtol=1e-5, atol=1e-6)
    # exact ties: zero tokens, every framework's softmax exactly 1/E, all
    # of them to expert 0
    zeros = jnp.zeros(tokens.shape, jnp.float32)
    y, aux = jmoe.moe_apply(expert_fn, experts, router, zeros,
                            capacity_factor=2.0)
    assert not np.asarray(jnp.argmax(jax.nn.softmax(zeros @ router),
                                     -1)).any()
    port_y, port_aux = moe_apply(port.moe._experts, port.moe.router,
                                 torch.zeros(tokens.shape),
                                 capacity_factor=2.0, record=record)
    t = tokens.shape[0]
    assert float(aux["dropped_frac"]) == float(port_aux["dropped_frac"]) \
        == 0.5
    np.testing.assert_array_equal(record["kept"].numpy(),
                                  np.arange(t) < t // 2)
    np.testing.assert_array_equal(record["slot"].numpy(), np.arange(t))
    np.testing.assert_allclose(port_y.detach().numpy(), np.asarray(y),
                               rtol=1e-6, atol=1e-9)


# -- float64: sp 2 == sp 1 ---------------------------------------------------

@pytest.mark.parametrize("name", list(RUNS))
def test_sp2_equals_sp1_in_float64(ranks, name):
    got = ranks.result(1, f"{name}.sp2")
    # the row's ranks hold one replica, bit for bit
    assert got["digest"] == ranks.result(1, f"{name}.sp2", 1)["digest"]
    for kind, (whole, _) in got["distances"].items():
        assert whole <= BOUND, (name, kind, got["distances"])
    if name == "xception-moe":
        want = ranks.reference(1, f"{name}.sp1")["moe_dropped"]
        assert got["moe_dropped"] == want and min(want) >= 0.5


@pytest.mark.parametrize("control", list(CONTROLS))
def test_sp_control_misses(ranks, control):
    """BatchNorm statistics over the rank's frames alone, the MoE slots
    counted on each rank alone, the int8 absmax of each rank's tensor
    alone: each at least 1000x farther from sp 1 than the sp 2 run, and
    1000x past the bound, in every kind."""
    run = CONTROLS[control][0]
    synced = ranks.result(1, f"{run}.sp2")["distances"]
    missed = ranks.result(1, control)["distances"]
    for kind in synced:
        assert missed[kind][0] >= 1000 * max(synced[kind][0], BOUND), \
            (control, kind, missed[kind], synced[kind])


@pytest.mark.parametrize("name", list(RUNS))
def test_sp2_sweep_scores_and_checkpoint_equal_sp1(ranks, name):
    got = ranks.result(1, f"{name}.sp2")
    want = ranks.reference(1, f"{name}.sp1")
    for mine, ref in zip([*got["sweeps"], got["scores"]],
                         [*want["sweeps"], want["scores"]], strict=True):
        assert set(mine) == set(ref)
        for k, v in ref.items():
            assert np.isfinite(v), (k, ref)
            np.testing.assert_allclose(mine[k], v, rtol=1e-9, atol=0,
                                       err_msg=k)
    # GANomaly's frames' scores, from which its ROC is computed, too
    for mine, ref in zip(got["frame_scores"], want["frame_scores"],
                         strict=True):
        assert (mine is None) == (ref is None) == (name != "ganomaly")
        if ref is not None:
            assert torch.equal(mine["labels"], ref["labels"])
            np.testing.assert_allclose(mine["scores"], ref["scores"],
                                       rtol=1e-9, atol=0)
    assert got["saved"] == want["saved"] and want["saved"]
    # rank 0 of the row alone wrote
    assert ranks.result(1, f"{name}.sp2", 1)["saved"] is None


# -- one frame a shard ----------------------------------------------------

@pytest.mark.parametrize("name", list(ONE_FRAME))
def test_one_frame_shards_equal_sp1_in_float64(ranks, name):
    got = ranks.result(0, f"{name}.sp8")
    for r in range(1, 8):
        assert got["digest"] == ranks.result(0, f"{name}.sp8", r)["digest"]
    for kind, (whole, _) in got["distances"].items():
        assert whole <= BOUND, (name, kind, got["distances"])
    want = ranks.reference(0, f"{name}.sp1")
    assert got["saved"] == want["saved"] and want["saved"]
    for k, v in want["scores"].items():
        np.testing.assert_allclose(got["scores"][k], v, rtol=1e-9, atol=0)


def test_mygan_refuses_one_frame_shards_where_jax_takes_them(tmp_path):
    """JAX asks only that sp divide nfr (``vfd_gan_tpu/config.py``); the
    port's MyGAN flow needs a frame pair a shard, so ``--nfr 16 --sp 16``
    is a pinned narrowing (ROADMAP queue 1 item 13c, queue 3)."""
    JaxConfig(model="mygan", nfr=16, sp=16, isize=64).validate()
    with pytest.raises(SystemExit, match=r"a MyGAN shard of nfr / sp = 1 "
                                         r".*queue 1 item 13c"):
        trainer.main(["--model", "mygan", "--nfr", "16", "--isize", "64",
                      "--sp", "16", "--synthetic_data", "2", "--device",
                      "cpu", "--result_root", str(tmp_path)])
    # two frames a shard run (tests/test_torch_port_sp.py's nfr 16, sp 2
    # holds 8; the refusal stops at 2)
    cfg, _, _ = trainer.parse(["--model", "mygan", "--nfr", "16", "--sp",
                               "8", "--synthetic_data", "2"])
    assert cfg.nfr // cfg.sp == 2


# -- the command -------------------------------------------------------------

def test_trainer_xception_dp2_sp2_runs_and_rank0_alone_writes(tmp_path,
                                                              capfd):
    """The command starts the 4 ranks of a dp 2 x sp 2 grid; each trains
    to the end, rank 0 alone writes the run (the sweep's masks gathered
    over each row before the opening)."""
    before = set(_children())
    argv = ["--model", "xception", "--xwidth", "0.0625", "--nfr", "8",
            "--isize", "32", "--batchsize", "4", "--dp", "2", "--sp", "2",
            "--synthetic_data", "2", "--freq", "2", "--device", "cpu",
            "--no-tensorboard", "--result_root", str(tmp_path),
            *_COMMON]
    assert trainer.main(argv) is None
    out = capfd.readouterr().out
    assert out.count("[Done]") == 4 and out.count("SAVE PATH") == 1, out
    runs = list((tmp_path / "xception").rglob("args.txt"))
    assert len(runs) == 1 and '"sp": 2' in runs[0].read_text()
    assert len((runs[0].parent / "metrics.jsonl").read_text()
               .splitlines()) == 1
    assert list((tmp_path / "xception").rglob("*.pth"))
    assert set(_children()) <= before
