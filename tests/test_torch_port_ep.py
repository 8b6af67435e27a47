"""``--moe_shards N``: Xception's MoE block with its experts split over N
replicas of each rank, on the CPU over gloo ranks: against the same steps
in one process, and against JAX's step on a ``{"dp": 2, "ep": 2}`` mesh.

Two groups of ranks are started once for the module, side by side
(``ranks``): one of 2 ranks (ep 2) and one of 4 (ep 4; dp 2 x ep 2; sp 2
x ep 2).  The ranks run ``vfd_gan_tpu_torch.tools.dp_equivalence`` (no
rank imports JAX or this file), each group meeting through a file under
the test's tmp dir and writing to a log file of its own, with a join
timeout of 400 s.  Every run is ``--xwidth 0.0625``, 32^2, nfr 8,
``--moe_experts 4`` at capacity factor 0.5 (C 8 of the 64 tokens of a
b2 step, 16 of 128 at b4: at least half the tokens drop).

* float64, ep N against ep 1 in one process (references in the grid's
  two-pass BatchNorm arithmetic, ``dp_equivalence.OneProcess``), within
  1e-9 (the relative L2 distance of each kind's whole set: parameters,
  BatchNorm buffers, Adam's two moments, the losses), the same kept set
  (every token's first-step kept flag) and dropped fraction each step,
  the sweep's scores and saved ``.pth`` names:
  ``--moe_shards 2``, and at b4 ``--moe_shards 4`` (one expert a rank),
  ``--dp 2 --moe_shards 2`` and ``--sp 2 --moe_shards 2`` (4 ranks),
  ``--moe_shards 2 --accum 2`` (b4) and ``--moe_shards 2
  --ref_mode_quirks --freq 1`` (3 steps: steps 2 and 3 past the latch).
* the controls land at least 1000x farther than the ep 2 run in every
  kind, and 1000x past the bound in the parameters and Adam's moments:
  the combine's backward summed over the ep group, the dispatch's not
  summed, the router's input summed too, the count table over the whole
  world, the expert gradients in the world's flattened all-reduce.
* each rank holds 1/N of the expert leaves' elements and of their Adam
  moments and the whole router; the replicas' trunk parameters are one
  bit for bit after each step.
* float32: the port's ``--dp 2 --moe_shards 2`` step passes
  ``parallel/verify.py``'s gate against JAX's step on a ``{"dp": 2, "ep":
  2}`` mesh (4 of the 8 virtual CPU devices), with JAX's dp 1 step as the
  yardstick (augment draws given, dropout off); every token's slot and
  kept flag are JAX's.
* checkpoints: an ep 2 run's ``latest.pt`` holds the 4 experts and their
  moments and loads ``strict=True`` into a one-process engine, tensor
  for tensor; its best ``.pth`` holds the 4 experts; an ep 2 engine
  restores an ep 1 ``latest.pt`` bit for bit (``--resume``); float64
  resumes across ep 1 -> ep 2 and ep 2 -> ep 1 continue within 1e-9 of the
  uninterrupted run.
* the trainer's ``--moe_shards 2`` command (2 ranks, rank 0 alone
  writes); ``--moe_shards 3`` of 4 experts refused, as JAX refuses it;
  ``--tp 2`` with ``--moe_shards 2`` taken (tp x ep,
  ``tests/test_torch_port_tp_families.py``), with c2plus1d still refused
  with queue 1 item 13.
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
from vfd_gan_tpu.models import moe_block as jmoe_block
from vfd_gan_tpu.ops import augment as jaug
from vfd_gan_tpu.parallel import moe as jmoe
from vfd_gan_tpu.parallel.mesh import state_shardings
from vfd_gan_tpu.train.state import NetState as JaxNetState
from vfd_gan_tpu.train.state import make_adam
from vfd_gan_tpu.train.supervised_engine import (
    SupervisedEngine as JaxSupervisedEngine,
)
from vfd_gan_tpu_torch.cli import trainer
from vfd_gan_tpu_torch.models.xception3d import Xception3D
from vfd_gan_tpu_torch.ops.augment import staging_size
from vfd_gan_tpu_torch.parallel import verify
from vfd_gan_tpu_torch.tools import dp_equivalence as eq
from vfd_gan_tpu_torch.utils.checkpoint import load_state_dict
from vfd_gan_tpu_torch.utils.weights import xception_state_dict
from test_torch_port_sp import _children, _Ranks
from test_torch_port_sp_families import _recording_moe
from test_torch_port_threads import one_torch_thread  # noqa: F401

BOUND = 1e-9
E = 4                                     # the experts
CF = 0.5                                  # the dropping capacity factor
B, T = 2, 8
_COMMON = ["--compute_dtype", "float32", "--synthetic_test_batches", "1",
           "--synthetic_thick_masks", "--ep", "1"]


def _xception(*extra, batch: int = B) -> list:
    return ["--model", "xception", "--xwidth", "0.0625", "--batchsize",
            str(batch), "--nfr", str(T), "--isize", "32", "--moe_experts",
            str(E), "--synthetic_data", "3", "--seed", "3", *extra,
            *_COMMON]


EP2 = ("--moe_shards", "2")
# name: (group of ranks: 0 of 2, 1 of 4; command line, case settings)
RUNS = {
    "ep2": (0, _xception(*EP2), {}),
    "ep2-accum": (0, _xception(*EP2, "--accum", "2", batch=4), {}),
    "ep2-quirks": (0, _xception(*EP2, "--ref_mode_quirks", "--freq", "1"),
                   {"steps": 3}),
    "ep4": (1, _xception("--moe_shards", "4", batch=4), {}),
    "dp2-ep2": (1, _xception("--dp", "2", *EP2, batch=4), {}),
    "sp2-ep2": (1, _xception("--sp", "2", *EP2, batch=4), {}),
}
SHARDS = {"ep2": 2, "ep2-accum": 2, "ep2-quirks": 2, "ep4": 4, "dp2-ep2": 2,
          "sp2-ep2": 2}
# the reference of each run: the same command line in one process (whose
# engine, alone, holds every expert and routes over its own tokens).  The
# 4-rank runs are b4: under dp 2 at b2 a rank's BatchNorms see one clip,
# 32 values a channel, and amplify the round-off between one sum and two
# partial sums to 1.6e-9 in Adam's first moments (measured)
REFS = {"ep2": "plain", "ep2-accum": "accum", "ep2-quirks": "quirks",
        "ep4": "b4", "dp2-ep2": "b4", "sp2-ep2": "b4"}
CONTROLS = ("ep_combine", "ep_dispatch", "ep_router", "ep_table",
            "ep_grads")


def _base(**kw) -> dict:
    return {**dict(kind="train", steps=2, float64=True, sweep=True,
                   moe_capacity=CF), **kw}


def _group_cases(group: int) -> list:
    names = [n for n, (g, _, _) in RUNS.items() if g == group]
    first = {}                   # each reference, from its first run's
    for n in names:
        first.setdefault(REFS[n], n)
    cases = [_base(name=f"{ref}.ref", dp=1, arith="dp", argv=RUNS[n][1],
                   **RUNS[n][2]) for ref, n in first.items()]
    cases += [_base(name=n, ref=f"{REFS[n]}.ref", argv=RUNS[n][1],
                    **RUNS[n][2]) for n in names]
    return cases


def _control_cases() -> list:
    return [_base(name=f"ep2.{op}", ref="plain.ref", argv=RUNS["ep2"][1],
                  sweep=False, local_ops=[op]) for op in CONTROLS]


LAYER = dict(kind="moe_layer", channels=46, experts=E, shape=[B, T, 2, 2],
             capacity=CF)


def _layer_cases() -> list:
    return [dict(LAYER, name=f"layer.{op or 'ep2'}",
                 local_ops=[op] if op else []) for op in (None, *CONTROLS[:4])]


def _checkpoint_cases(root) -> list:
    """float64: an uninterrupted 3-step run; ep 1 (1 step) -> its
    latest.pt -> ep 2 (2 steps), and ep 2 (1 step) -> ep 1 (2 steps).
    float32: ep 1 (1 step) -> ep 2 restored by ``--resume`` (0 steps);
    an ep 2 run (2 steps and a sweep) that writes its latest.pt and its
    best .pth."""
    argv = RUNS["ep2"][1]
    f64 = dict(kind="train", float64=True, moe_capacity=CF, argv=argv,
               arith="dp")
    f32 = dict(kind="train", moe_capacity=CF, argv=argv)
    at = {k: str(root / f"{k}.pt") for k in ("ep1", "ep2", "f32_ep1",
                                             "f32_ep2")}
    return [dict(f64, name="resume.whole", dp=1, steps=3),
            dict(f64, name="resume.ep1", dp=1, steps=1, save=at["ep1"]),
            dict(f64, name="resume.ep1-ep2", steps=2, resume=at["ep1"]),
            dict(f64, name="resume.ep2", steps=1, save=at["ep2"]),
            dict(f64, name="resume.ep2-ep1", dp=1, steps=2,
                 resume=at["ep2"]),
            dict(f32, name="cli.ep1", dp=1, steps=1, save=at["f32_ep1"]),
            dict(f32, name="cli.ep2", steps=0,
                 argv=[*argv, "--resume", at["f32_ep1"]]),
            dict(f32, name="f32.ep2", steps=2, sweep=True,
                 save=at["f32_ep2"])]


# -- the float32 step's inputs ----------------------------------------------

def _jax_xception(mesh=None):
    cfg = JaxConfig(model="xception", batchsize=B, nfr=T, isize=32,
                    xwidth=1 / 16, moe_experts=E, compute_dtype="float32",
                    tensorboard=False).validate()
    model = jax_build("xception", cfg, jnp.float32, mesh=mesh).clone(
        moe_capacity=CF)
    x = jnp.zeros((B, T, 32, 32, 3), jnp.float32)
    variables = jax.jit(lambda k: model.init(
        {"params": k, "dropout": k}, x, False))(jax.random.key(0))
    return cfg, model, jax.tree_util.tree_map(np.asarray, variables)


def _step_batch() -> tuple[dict, dict]:
    s = staging_size(32)
    rng = np.random.default_rng(4)
    data = rng.integers(0, 256, (B, T, s, s, 3), dtype=np.uint8)
    mask = np.zeros((B, T, s, s, 1), np.uint8)
    mask[:, :, 3:s - 3, 4:s - 5] = 255
    batch = {"data": data, "real": data, "mask": mask}
    draws = {"angle": np.linspace(-0.17, 0.15, B).astype(np.float32),
             "flip": np.arange(B, dtype=np.int32) % 2,
             "crop": np.ones(B, np.int32), "pick": np.arange(B) % 2 == 0}
    return batch, draws


def _step_case(root, variables) -> dict:
    batch, draws = _step_batch()
    np.savez(root / "batch.npz", **batch)
    np.savez(root / "draws.npz", **draws)
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                xception_state_dict(variables).items()},
               root / "state.pt")
    argv = ["--model", "xception", "--xwidth", "0.0625", "--batchsize",
            str(B), "--nfr", str(T), "--isize", "32", "--moe_experts",
            str(E), "--dp", "2", *EP2, "--synthetic_data", "1", *_COMMON]
    return dict(kind="step_core", name="dp2-ep2.core", argv=argv,
                state=str(root / "state.pt"), batch=str(root / "batch.npz"),
                draws=str(root / "draws.npz"), moe_capacity=CF)


@pytest.fixture(scope="module")
def jax_net():
    return _jax_xception()


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory, jax_net, request):
    """Started before the module's first test: the JAX steps run while the
    ranks compute."""
    group = _Ranks(tmp_path_factory.mktemp("ep"), 6)
    # the claim on the rank slots given back however the module ends
    request.addfinalizer(group.close)
    group.start([*_group_cases(0), *_control_cases(),
                 *_checkpoint_cases(group.root), *_layer_cases()], world=2)
    group.start([_step_case(group.root, jax_net[2]), *_group_cases(1)],
                world=4)
    yield group


# The tests that run JAX come first: the ranks compute meanwhile.

# -- float32: the dp 2 x ep 2 step against JAX's on a {"dp": 2, "ep": 2} mesh

def _jax_step(jax_net, mesh: Mesh, monkeypatch):
    """JAX's supervised step of the weights ``jax_net`` holds on ``mesh``
    (its ``ep`` axis: the model built with it and the state sharded by
    ``state_shardings``), the batch sharded ``P("dp")``; returns its loss,
    its state dict and the MoE slots it recorded."""
    cfg, _, variables = jax_net
    model = jax_build("xception", cfg, jnp.float32, mesh=mesh).clone(
        moe_capacity=CF)
    batch, draws = _step_batch()
    monkeypatch.setattr(fnn.Dropout, "__call__", _identity_dropout)
    monkeypatch.setattr(jaug, "sample_clip_params", lambda *a, **k: tuple(
        jnp.asarray(draws[k]) for k in ("angle", "flip", "crop", "pick")))
    routing = []
    monkeypatch.setattr(jmoe_block, "moe_apply", _recording_moe(routing))
    jeng = object.__new__(JaxSupervisedEngine)
    jeng.cfg, jeng.model, jeng.pipe = cfg, model, None
    jeng.tx = make_adam(cfg.lr, cfg.beta1)
    state = JaxNetState.create(variables, jeng.tx)
    state = jax.device_put(state, state_shardings(mesh, state))
    rows = NamedSharding(mesh, P("dp"))
    state, loss, _ = jax.jit(jeng._train_step_impl, static_argnums=(3,))(
        state, {k: jax.device_put(jnp.asarray(v), rows)
                for k, v in batch.items()}, jax.random.key(0), True)
    sd = xception_state_dict(jax.tree_util.tree_map(
        np.asarray, state.variables()))
    return {"loss/err/train": float(loss)}, sd, routing


def _leaves(sd: dict) -> list:
    return [np.asarray(sd[k], np.float32) for k in sorted(sd)
            if not k.endswith("num_batches_tracked")]


def test_dp2_ep2_step_passes_the_gate_against_jax_dp2_ep2_mesh(
        ranks, jax_net, monkeypatch):
    """The port's float32 dp 2 x ep 2 step against JAX's on a ``{"dp": 2,
    "ep": 2}`` mesh (its expert leaves split over ``ep``), the gate
    calibrated by JAX's own dp 1 step; every token's slot and kept flag
    (half the tokens or more dropped) are JAX's."""
    devices = np.asarray(jax.devices()[:4]).reshape(2, 2)
    mesh = Mesh(devices, ("dp", "ep"))
    replica = _jax_step(jax_net, mesh, monkeypatch)
    yardstick = _jax_step(jax_net, Mesh(devices[:1, :1], ("dp", "ep")),
                          monkeypatch)
    got = [ranks.result(1, "dp2-ep2.core", r) for r in range(4)]
    for other in got[1:]:
        assert other["metrics"] == got[0]["metrics"]
        assert all(torch.equal(v, other["state"][k])
                   for k, v in got[0]["state"].items())
    port = {k: v.numpy() for k, v in got[0]["state"].items()}
    assert set(port) == set(replica[1])
    assert port["moe.experts_w1"].shape[0] == E
    rtol, atol = verify.assert_replica_equivalence(
        (replica[0], _leaves(replica[1])),
        (yardstick[0], _leaves(yardstick[1])),
        (got[0]["metrics"], _leaves(port)), label="dp2 ep2 port vs JAX")
    assert rtol <= verify.REL_CAP and atol <= verify.ABS_CAP
    # JAX lists the tokens (B, T, H, W); ranks 0 and 2 hold rows 0 and 1
    # (the replicas of a row route alike)
    slots, dropped = replica[2][-1]
    want = slots.reshape(B, T, 2, 2)
    for r in (1, 3):
        for k in ("slot", "kept"):
            assert torch.equal(got[r]["routing"][k],
                               got[r - 1]["routing"][k])
    port_slots = np.concatenate([got[r]["routing"]["slot"].numpy()
                                 for r in (0, 2)])
    port_kept = np.concatenate([got[r]["routing"]["kept"].numpy()
                                for r in (0, 2)])
    c = jmoe.capacity(want.size, E, CF)
    np.testing.assert_array_equal(port_slots, want)
    np.testing.assert_array_equal(port_kept, want < c)
    assert dropped == 1 - port_kept.mean() >= 0.5


# -- float64: ep N == ep 1 ---------------------------------------------------

def _group(name: str) -> int:
    return RUNS[name][0]


def _world(name: str) -> int:
    return 2 if _group(name) == 0 else 4


@pytest.mark.parametrize("name", list(RUNS))
def test_ep_equals_ep1_in_float64(ranks, name):
    got = ranks.result(_group(name), name)
    # every rank's replica of the whole state (experts gathered), bit for
    # bit
    for r in range(1, _world(name)):
        assert got["digest"] == ranks.result(_group(name), name,
                                             r)["digest"]
    for kind, (whole, _) in got["distances"].items():
        assert whole <= BOUND, (name, kind, got["distances"])
    ref = ranks.reference(_group(name), f"{REFS[name]}.ref")
    assert got["moe_dropped"] == ref["moe_dropped"]
    assert min(ref["moe_dropped"]) >= 0.5
    # the kept set: every token's kept flag in the first step, replica 0's
    # ranks side by side (rank (d sp + k) N: rows d, frames k)
    n = SHARDS[name]
    places = [ranks.result(_group(name), name, r)["first_routing"]["kept"]
              for r in range(0, _world(name), n)]
    kept = torch.cat(places, 1 if "--sp" in RUNS[name][1] else 0)
    assert torch.equal(kept, ref["first_routing"]["kept"])


@pytest.mark.parametrize("control", CONTROLS)
def test_ep_control_misses(ranks, control):
    """The combine's backward summed over the ep group, the dispatch's not
    summed, the router's input summed, the count table over the world,
    the experts in the world's gradient all-reduce: each at least 1000x
    farther from ep 1 than the ep 2 run in every kind, and 1000x past the
    bound in the parameters and Adam's moments (the losses and the
    running statistics move at the second step alone, where a parameter
    has moved by about lr)."""
    synced = ranks.result(0, "ep2")["distances"]
    missed = ranks.result(0, f"ep2.{control}")["distances"]
    for kind in synced:
        assert missed[kind][0] > 1000 * synced[kind][0], \
            (control, kind, missed[kind], synced[kind])
    for kind in ("params", "exp_avg", "exp_avg_sq"):
        assert missed[kind][0] >= 1000 * BOUND, (control, kind,
                                                 missed[kind])


@pytest.mark.parametrize("name", list(RUNS))
def test_ep_sweep_scores_and_checkpoint_equal_ep1(ranks, name):
    """The sweep (the experts still sharded, the combine on) scores as ep
    1's, and saves the same best ``.pth``; rank 0 alone writes."""
    got = ranks.result(_group(name), name)
    want = ranks.reference(_group(name), f"{REFS[name]}.ref")
    assert set(got["scores"]) == set(want["scores"])
    for k, v in want["scores"].items():
        assert np.isfinite(v), (k, want["scores"])
        np.testing.assert_allclose(got["scores"][k], v, rtol=1e-9, atol=0,
                                   err_msg=k)
    assert got["saved"] == want["saved"] and want["saved"]
    assert ranks.result(_group(name), name, 1)["saved"] is None


@pytest.mark.parametrize("name", list(RUNS))
def test_each_rank_holds_its_experts_and_one_trunk(ranks, name):
    """Each rank holds 1/N of the expert leaves' elements and of their
    Adam moments, and the whole router; the replicas' trunk parameters
    are one, bit for bit, after each step; a step exchanges over the ep
    group once a microbatch each way, and broadcasts the routing."""
    n = SHARDS[name]
    whole = ranks.reference(_group(name),
                            f"{REFS[name]}.ref")["expert_elements"]
    block = Xception3D(width_mult=1 / 16, moe_experts=E).moe
    assert whole["params"] == sum(p.numel() for p in block.expert_params()) \
        == whole["exp_avg"] == whole["exp_avg_sq"]
    digests = []
    for r in range(_world(name)):
        got = ranks.result(_group(name), name, r)
        held = got["expert_elements"]
        assert held["router"] == whole["router"] == block.router.numel()
        for kind in ("params", "exp_avg", "exp_avg_sq"):
            assert n * held[kind] == whole[kind], (name, r, kind, held)
        digests.append(got["trunk_digests"])
        # a step's exchanges: per microbatch the routing broadcast, the
        # combine and the dispatch's gradient sum
        micro = 2 if "--accum" in RUNS[name][1] else 1
        assert {k: n for k, (n, _) in got["ep_counts"].items()} == {
            "route": micro, "combine": micro, "dispatch": micro}, name
    steps = RUNS[name][2].get("steps", 2)
    assert all(len(d) == steps for d in digests)
    assert all(d == digests[0] for d in digests)


# -- the MoE layer alone (the card's layer reading) -------------------------

def _rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.parametrize("op", [None, *CONTROLS[:4]],
                         ids=["ep2", *CONTROLS[:4]])
def test_moe_layer_equals_one_process_and_each_control_misses(ranks, op):
    """``dp_equivalence``'s ``moe_layer`` case, which ``chip_smoke.py``
    runs at full width: the block over an ep group of 2 against the
    one-process block on the same tokens and upstream gradient, float32.
    Here the ep 2 block is the one-process block bit for bit; each of
    the four layer controls moves one of the readings by over 1e4 x the
    float32 layer's own rounding (its distance from float64)."""
    got = ranks.result(0, f"layer.{op or 'ep2'}")
    alone, exact = got["alone"], got["alone64"]
    kinds = ("out", "x_grad", "router_grad", "experts_grad")
    assert 0 < float(alone["kept"].float().mean()) <= 0.5
    if op is None:
        assert torch.equal(got["kept"], alone["kept"])
        for k in kinds:
            assert torch.equal(got[k], alone[k]), k
            assert _rel(alone[k], exact[k]) < 1e-4, k
        assert got["ep_counts"] == {"route": 1, "combine": 1, "dispatch": 1}
        assert all(torch.equal(got[k], ranks.result(0, "layer.ep2", 1)[k])
                   for k in kinds)
        return
    worst = max(_rel(got[k], alone[k]) / _rel(alone[k], exact[k])
                for k in kinds)
    assert worst > 1e4, (op, worst)


# -- checkpoints ---------------------------------------------------------

def test_latest_pt_of_ep2_is_canonical_and_loads_in_one_process(ranks,
                                                                tmp_path):
    """The ep 2 run's ``latest.pt`` holds the 4 experts and their Adam
    moments, equal to the run's gathered state, and loads ``strict=True``
    into a one-process engine, tensor for tensor; its best ``.pth`` holds
    the 4 experts too."""
    ranks.join()
    path = ranks.root / "f32_ep2.pt"
    tree = torch.load(path, weights_only=False)
    sd = tree["state"]["module"]
    assert sd["moe.experts_w1"].shape[0] == E
    assert sd["moe.router"].shape[1] == E
    run = ranks.result(0, "f32.ep2")
    for kind in ("params", "buffers"):
        for k, v in run[kind].items():
            assert torch.equal(sd[k.removeprefix("state.")], v), k
    engine = trainer.build_engine([
        *RUNS["ep2"][1], "--device", "cpu", "--no-tensorboard",
        "--result_root", str(tmp_path), "--resume", str(path)])
    try:
        assert engine.shards is None       # one process: every expert
        for k, v in engine.model.state_dict().items():
            assert torch.equal(v, sd[k]), k
        state = engine.net.optimizer.state
        for k, p in engine.model.named_parameters():
            for m in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(state[p][m],
                                   run[m][f"state.{k}"]), (k, m)
        assert engine.global_step == tree["step"] == 2
    finally:
        engine.close()
    pth, = (ranks.root / "group0" / "f32.ep2").rglob("*.pth")
    assert pth.name == run["saved"][0]
    model = Xception3D(width_mult=1 / 16, moe_experts=E)
    model.load_state_dict(load_state_dict(str(pth)), strict=True)
    assert model.moe.experts_w2.shape[0] == E


def test_ep2_restores_an_ep1_latest_pt_bit_for_bit(ranks):
    """``--resume`` of an ep 1 run's ``latest.pt`` by ep 2 ranks: the
    whole state loaded, each rank's experts kept (read gathered)."""
    want = ranks.reference(0, "cli.ep1")
    for r in (0, 1):
        got = ranks.result(0, "cli.ep2", r)
        for kind in ("params", "buffers", "exp_avg", "exp_avg_sq"):
            assert set(got[kind]) == set(want[kind]), kind
            for k, v in want[kind].items():
                assert torch.equal(got[kind][k], v), (kind, k)
        assert got["expert_elements"]["params"] * 2 == \
            want["expert_elements"]["params"]


def _state_distance(got: dict, want: dict, kind: str) -> float:
    """The relative L2 distance of all of a kind's tensors as one vector
    (``dp_equivalence.distances``' whole)."""
    diff = torch.cat([(got[kind][k].double() - v.double()).flatten()
                      for k, v in want[kind].items()])
    ref = torch.cat([v.double().flatten() for v in want[kind].values()])
    return float(diff.norm() / ref.norm())


def test_resume_across_ep1_and_ep2_continues_the_run(ranks):
    """float64: ep 1 (1 step) -> ep 2 (2 steps), and ep 2 (1 step) -> ep
    1 (2 steps), each within 1e-9 of the uninterrupted 3-step run, its
    last two steps' losses too."""
    whole = ranks.reference(0, "resume.whole")
    for got in (ranks.result(0, "resume.ep1-ep2"),
                ranks.reference(0, "resume.ep2-ep1")):
        for kind in ("params", "buffers", "exp_avg", "exp_avg_sq"):
            assert set(got[kind]) == set(whole[kind]), kind
            assert _state_distance(got, whole, kind) <= BOUND, kind
        for mine, ref in zip(got["losses"], whole["losses"][1:],
                             strict=True):
            for k, v in ref.items():
                np.testing.assert_allclose(mine[k], v, rtol=1e-9, atol=0)
    # the ep 2 ranks hold one replica of the whole state
    assert eq._digest(ranks.result(0, "resume.ep1-ep2", 1)) == \
        eq._digest(ranks.result(0, "resume.ep1-ep2"))


# -- the command -------------------------------------------------------------

def test_trainer_moe_shards_2_runs_and_rank0_alone_writes(tmp_path, capfd):
    """The command starts 2 ranks, an ep group; each trains to the end,
    rank 0 alone writes the run and its best ``.pth`` (4 experts)."""
    before = set(_children())
    argv = [*RUNS["ep2"][1], "--freq", "2", "--synthetic_data", "2",
            "--device", "cpu", "--no-tensorboard", "--result_root",
            str(tmp_path)]
    assert trainer.main(argv) is None
    out = capfd.readouterr().out
    assert out.count("[Done]") == 2 and out.count("SAVE PATH") == 1, out
    runs = list((tmp_path / "xception").rglob("args.txt"))
    assert len(runs) == 1 and '"moe_shards": 2' in runs[0].read_text()
    pth, = (tmp_path / "xception").rglob("*.pth")
    assert load_state_dict(str(pth))["moe.experts_w1"].shape[0] == E
    assert set(_children()) <= before


def test_moe_shards_that_do_not_divide_the_experts_are_refused_as_jax(
        tmp_path):
    with pytest.raises(ValueError, match="moe_shards must divide"):
        JaxConfig(model="xception", isize=32, nfr=8, moe_experts=4,
                  moe_shards=3).validate()
    with pytest.raises(ValueError, match="moe_shards must divide"):
        trainer.main([*_xception("--moe_shards", "3"), "--device", "cpu",
                      "--result_root", str(tmp_path)])


def test_tp_is_still_refused_with_item_13(tmp_path):
    """``--tp`` with ``--moe_shards`` runs since (tp x ep,
    ``tests/test_torch_port_tp_families.py``); item 13 tp still refuses
    ``--tp`` where the port does not take it yet (c2plus1d)."""
    from vfd_gan_tpu_torch.config import parse_args
    from vfd_gan_tpu_torch.train.engine_base import UNPORTED

    unported, _ = UNPORTED["tp"]
    assert unported(parse_args([*_xception(*EP2), "--tp", "2"])) is None
    with pytest.raises(SystemExit, match=r"queue 1 item 13 \(parallelism"):
        trainer.main(["--model", "c2plus1d", "--batchsize", "4", "--nfr",
                      "16", "--isize", "32", "--tp", "2",
                      "--synthetic_data", "2", "--device", "cpu",
                      "--result_root", str(tmp_path)])
