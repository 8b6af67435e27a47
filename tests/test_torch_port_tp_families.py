"""``--tp N`` for Xception (alone and with ``--moe_experts``,
``--moe_shards``, ``--accum``, ``--ref_mode_quirks``, ``--dp`` and
``--sp``) and GANomaly (alone, with ``--dp`` and ``--sp``), on the CPU
over gloo ranks: against the same steps in one process, against JAX's
``state_shardings`` and against JAX's step on a ``{"dp": 1, "tp": 2}``
mesh.

Two groups of ranks are started once for the module (``ranks``, claimed
from the session's ``rank_slots``): one of 4 (its one-process references
first, four at a time, then dp 2 x tp 2, sp 2 x tp 2 and tp 2 x ep 2)
and one of 2 (tp 2), which waits for its references in the 4 ranks'
directory.  The ranks run ``vfd_gan_tpu_torch.tools.dp_equivalence`` (no
rank imports JAX or this file), each group writing to a log file of its
own.  Xception runs at ``--xwidth 0.05`` (widths 2, 3, 6, 13, 36, 51, 77,
102: at tp 2 split and whole segments alternate), 32^2, nfr 8; GANomaly at
16^2, nfr 8, seed 2 (its sweep batch holds a fake and a real clip, so the
frame ROC is defined and a ``.pth`` pair is saved).

* float64, each run against tp 1 in one process within 1e-9 (the
  relative L2 distance of each kind's whole set: parameters, BatchNorm
  buffers, Adam's two moments, the losses), the ranks of a run one
  replica bit for bit, the sweep's scores and saved ``.pth`` names tp
  1's; Xception's decoder dropout is on, so each rank draws tp 1's masks.
* the controls land at least 1000x farther than the tp 2 step (one step
  each): the copy-in's backward not summed, the gather's backward summed,
  the decoder dropout drawn on the rank's slice (Xception), a transposed
  conv's weight cut on dim 0 (GANomaly).
* the split leaf set is JAX's ``state_shardings`` on a ``tp`` mesh, leaf
  for leaf (through ``utils/weights.py``'s names), for Xception, its MoE
  block at ``--moe_shards`` 1 and 2 (the expert leaves then on ``ep``,
  none on both axes) and GANomaly's G and D; a rank's parameter and Adam
  elements follow from it, and a step gathers once a split segment a
  forward; the full-width counts from the shapes.
* each module alone (``dp_equivalence``'s ``tp_block``: an Xception
  SepaConv, the MoE block, a GANomaly decoder stage) against one process,
  and its copy-in and gather controls, as ``chip_smoke.py`` runs them at
  full width.
* float32: the port's tp 2 step of Xception and of GANomaly passes
  ``parallel/verify.py``'s gate against JAX's on a ``{"dp": 1, "tp": 2}``
  mesh (its state sharded by ``state_shardings``), JAX's tp 1 step the
  yardstick (augment draws given, dropout off).
* checkpoints: a tp 2 run's ``latest.pt`` holds the tp 1 shapes and
  loads with ``strict=True``, as do its best ``.pth`` files; float64
  resumes across tp 1 -> tp 2 and tp 2 -> tp 1 continue within 1e-9 of
  the uninterrupted run.
* the trainer's ``--tp 2`` commands (2 ranks, rank 0 alone writes).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tests.test_torch_port_supervised_step import _identity_dropout
from vfd_gan_tpu.config import Config as JaxConfig
from vfd_gan_tpu.models import build_mask_model as jax_build
from vfd_gan_tpu.models import ganomaly as jganomaly
from vfd_gan_tpu.ops import augment as jaug
from vfd_gan_tpu.parallel.mesh import make_mesh, state_shardings
from vfd_gan_tpu.train import ganomaly_engine as jganomaly_engine
from vfd_gan_tpu.train.state import NetState as JaxNetState
from vfd_gan_tpu.train.state import make_adam
from vfd_gan_tpu.train.supervised_engine import (
    SupervisedEngine as JaxSupervisedEngine,
)
from vfd_gan_tpu_torch.cli import infer, trainer
from vfd_gan_tpu_torch.models.ganomaly import (
    GanomalyDiscriminator,
    GanomalyGenerator,
)
from vfd_gan_tpu_torch.models.xception3d import Xception3D
from vfd_gan_tpu_torch.ops.augment import staging_size
from vfd_gan_tpu_torch.parallel import verify
from vfd_gan_tpu_torch.parallel.tensor import (
    StateShards,
    held_elements,
    split_tensors,
    splits,
)
from vfd_gan_tpu_torch.tools import dp_equivalence as eq
from vfd_gan_tpu_torch.utils.checkpoint import load_state_dict
from vfd_gan_tpu_torch.utils.weights import (
    ganomaly_discriminator_state_dict,
    ganomaly_generator_state_dict,
    xception_state_dict,
)
from test_torch_port_sp import _children, _Ranks
from test_torch_port_threads import one_torch_thread  # noqa: F401

BOUND = 1e-9
WIDTH, E, CF = 0.05, 4, 0.5      # --xwidth, --moe_experts, capacity factor
B, T = 2, 8
_COMMON = ["--compute_dtype", "float32", "--synthetic_test_batches", "1",
           "--synthetic_thick_masks", "--ep", "1"]


def _xception(*extra, batch: int = B) -> list:
    return ["--model", "xception", "--xwidth", str(WIDTH), "--batchsize",
            str(batch), "--nfr", str(T), "--isize", "32",
            "--synthetic_data", "3", "--seed", "3", *extra, *_COMMON]


def _ganomaly(*extra, batch: int = B) -> list:
    return ["--model", "ganomaly", "--batchsize", str(batch), "--nfr",
            str(T), "--isize", "16", "--synthetic_data", "2", "--seed", "2",
            *extra, *_COMMON]


TP2 = ("--tp", "2")
MOE = ("--moe_experts", str(E))
QUIRKS = ("--ref_mode_quirks", "--freq", "1")
# the one-process references (tp 1): name -> (command line, steps, case
# settings), run by the 4-rank group, four at a time
REFS = {
    "x.ref": (_xception(), 2, {}),
    "xm.ref": (_xception(*MOE), 2, {"moe_capacity": CF}),
    "xm2.ref": (_xception("--moe_experts", "2"), 2, {"moe_capacity": CF}),
    "xa.ref": (_xception("--accum", "2", batch=4), 2, {}),
    "xq.ref": (_xception(*QUIRKS), 2, {"sweep_at": [1]}),
    "g.ref": (_ganomaly(), 2, {}),
    "x.ref.b4": (_xception(batch=4), 1, {}),
    "g.ref.b4": (_ganomaly(batch=4), 1, {}),
}
# the runs: name -> (group: 0 of 4 ranks, 1 of 2; reference; the
# reference's command line with these flags)
RUNS = {
    "x.tp2": (1, "x.ref", TP2),
    "xm.tp2": (1, "xm.ref", TP2),
    "xa.tp2": (1, "xa.ref", TP2),
    "xq.tp2": (1, "xq.ref", TP2),
    "g.tp2": (1, "g.ref", TP2),
    "x.dp2-tp2": (0, "x.ref.b4", ("--dp", "2", *TP2)),
    "x.sp2-tp2": (0, "x.ref", ("--sp", "2", *TP2)),
    "xm.tp2-ep2": (0, "xm.ref", (*TP2, "--moe_shards", "2")),
    # one expert a rank, which the tp rule alone would also split
    "xm2.tp2-ep2": (0, "xm2.ref", (*TP2, "--moe_shards", "2")),
    "g.dp2-tp2": (0, "g.ref.b4", ("--dp", "2", *TP2)),
    "g.sp2-tp2": (0, "g.ref", ("--sp", "2", *TP2)),
}
WORLD = {0: 4, 1: 2}
# control: the family whose one tp 2 step it breaks
CONTROLS = {"tp_copy": "x", "tp_gather": "x", "tp_dropout": "x",
            "tp_deconv_dim0": "g"}
FAMILIES = {"x": _xception, "g": _ganomaly}
# each module alone (dp_equivalence's tp_block), as chip_smoke.py's
# tp-families phase runs it at full width
BLOCKS = {"sepaconv": dict(block="sepaconv", cin=36, cout=36,
                           shape=[2, 4, 4, 4]),
          "moe": dict(block="moe", cin=36, cout=36, experts=E,
                      capacity=2.0, shape=[2, 4, 4, 4]),
          "deconv2d": dict(block="deconv2d", cin=16, cout=8,
                           shape=[8, 4, 4])}
BLOCK_OPS = (None, "tp_copy", "tp_gather")
F64 = dict(kind="train", float64=True)


def _ref_cases() -> list:
    return [dict(F64, name=name, dp=1, arith="dp", argv=argv, steps=steps,
                 sweep=True, **settings)
            for name, (argv, steps, settings) in REFS.items()]


def _run_cases(group: int, root) -> list:
    out = []
    for name, (g, ref, flags) in RUNS.items():
        if g != group:
            continue
        argv, steps, settings = REFS[ref]
        out.append(dict(F64, name=name, argv=[*argv, *flags], steps=steps,
                        sweep=True, **settings,
                        ref=ref if group == 0
                        else str(root / "group0" / ref)))
    return out


def _checkpoint_cases(root) -> list:
    """float64, for each family: tp 1 (1 step) -> its latest.pt -> tp 2 (1
    step), and tp 2 (1 step; against the tp 1 step, the controls'
    yardstick) -> its latest.pt -> tp 1 (1 step), each resume against the
    reference's 2 steps."""
    cases = []
    for f, family in FAMILIES.items():
        at = {k: str(root / f"{f}.{k}.pt") for k in ("tp1", "tp2")}
        f64 = dict(F64, steps=1, arith="dp", argv=family(*TP2))
        cases.append([
            dict(f64, name=f"resume.{f}.tp1", dp=1, save=at["tp1"],
                 argv=family()),
            dict(f64, name=f"resume.{f}.tp2", save=at["tp2"],
                 ref=f"resume.{f}.tp1", sweep=True),
            dict(f64, name=f"resume.{f}.tp1-tp2", resume=at["tp1"]),
            dict(f64, name=f"resume.{f}.tp2-tp1", dp=1, resume=at["tp2"],
                 argv=family())])
    return cases


def _control_cases() -> list:
    return [dict(F64, name=f"{f}.tp2.{op}", ref=f"resume.{f}.tp1",
                 argv=FAMILIES[f](*TP2), steps=1, local_ops=[op])
            for op, f in CONTROLS.items()]


def _block_cases() -> list:
    return [dict(b, kind="tp_block", name=f"block.{k}.{op or 'tp2'}",
                 local_ops=[op] if op else [])
            for k, b in BLOCKS.items() for op in BLOCK_OPS]


# -- the float32 steps' inputs -------------------------------------------

def _jax_xception():
    cfg = JaxConfig(model="xception", batchsize=B, nfr=T, isize=32,
                    xwidth=WIDTH, compute_dtype="float32",
                    tensorboard=False).validate()
    model = jax_build("xception", cfg, jnp.float32)
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
    return {"xception": _jax_xception(), "ganomaly": _jax_ganomaly()}


STEPS = {"xception": 32, "ganomaly": 16}


def _core_cases(root, jax_nets) -> list:
    cases = []
    for name, size in STEPS.items():
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
            argv = _ganomaly(*TP2, "--synthetic_data", "1")
        else:
            state = {k: torch.from_numpy(np.array(v)) for k, v in
                     xception_state_dict(jax_nets[name][2]).items()}
            argv = _xception(*TP2, "--synthetic_data", "1")
        torch.save(state, root / f"{name}.state.pt")
        cases.append(dict(kind="step_core", name=f"{name}.core", argv=argv,
                          state=str(root / f"{name}.state.pt"),
                          batch=str(root / f"{name}.batch.npz"),
                          draws=str(root / f"{name}.draws.npz")))
    return cases


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory, request):
    """Started before the module's first test: the JAX functions run while
    the ranks compute (the 4 ranks start before JAX inits the weights of
    the 2 ranks' float32 steps)."""
    group = _Ranks(tmp_path_factory.mktemp("tp_families"),
                   sum(WORLD.values()))
    # the claim on the rank slots given back however the module ends
    request.addfinalizer(group.close)
    root = group.root
    group.start([*_ref_cases(), *_run_cases(0, root)], world=WORLD[0])
    jax_nets = request.getfixturevalue("jax_nets")
    (x_first, *x_rest), (g_first, *g_rest) = _checkpoint_cases(root)
    group.start([*_core_cases(root, jax_nets), x_first, g_first,
                 x_rest[0], g_rest[0], *_control_cases(),
                 *_run_cases(1, root), *x_rest[1:], *g_rest[1:],
                 *_block_cases()], world=WORLD[1])
    yield group


# The tests that need no rank come first, then those that run JAX: the
# ranks compute meanwhile.

# -- the split leaf set is JAX's state_shardings ------------------------------

def _jax_marks(variables: dict, bridge, mesh) -> dict:
    """The port's names of the leaves that JAX's ``state_shardings``
    shards over each axis of ``mesh`` (``{"tp": set, "ep": set}``, marked
    through the weight bridge), after checking that each Adam moment
    follows its leaf."""
    tx = make_adam(2e-4, 0.5)
    state = jax.eval_shape(lambda v: JaxNetState.create(v, tx), variables)
    specs = state_shardings(mesh, state)
    out = {}
    for axis in ("tp", "ep"):
        def marked(spec):
            return axis in tuple(spec.spec)

        params = jax.tree_util.tree_map(marked, specs.params)
        assert params == jax.tree_util.tree_map(
            marked, specs.opt_state[0].mu)
        marks = {kind: jax.tree_util.tree_map(
            lambda s, v: np.full(v.shape, float(marked(s))),
            getattr(specs, kind), variables[kind])
            for kind in ("params", "batch_stats")}
        out[axis] = set()
        for k, v in bridge(marks).items():
            if v.ndim and v.all():
                out[axis].add(k)
            else:
                assert not v.any(), k
    return out


def _port_split(module, ep: int = 1) -> set:
    names = {id(t): k for k, t in (*module.named_parameters(),
                                   *module.named_buffers())}
    return {names[id(getattr(m, n))]
            for m, n, *_ in split_tensors(module, 2, ep)}


def _jax_variables(name: str):
    """JAX's initial variables (shapes) and the port's module of a
    split-set case, and the bridge to the port's names."""
    if name.startswith("xception"):
        experts = {"xception": 0, "xception-moe": E,
                   "xception-moe2": 2}[name]
        cfg = JaxConfig(model="xception", batchsize=B, nfr=T, isize=32,
                        xwidth=WIDTH, moe_experts=experts,
                        compute_dtype="float32").validate()
        model = jax_build("xception", cfg, jnp.float32)
        x = jnp.zeros((B, T, 32, 32, 3), jnp.float32)
        variables = jax.eval_shape(lambda k: model.init(
            {"params": k, "dropout": k}, x, False), jax.random.key(0))
        port = Xception3D(width_mult=WIDTH, moe_experts=experts)
        return variables, port, xception_state_dict
    frames = jnp.zeros((B * T, 16, 16, 3), jnp.float32)
    if name == "ganomaly-G":
        net, port = jganomaly.GanomalyGenerator(isize=16), \
            GanomalyGenerator(16)
        bridge = ganomaly_generator_state_dict
    else:
        net, port = jganomaly.GanomalyDiscriminator(isize=16), \
            GanomalyDiscriminator(16)
        bridge = ganomaly_discriminator_state_dict
    variables = jax.eval_shape(lambda k: net.init({"params": k}, frames,
                                                  False), jax.random.key(0))
    return variables, port, bridge


@pytest.mark.parametrize("name, ep", [("xception", 1), ("xception-moe", 1),
                                      ("xception-moe", 2),
                                      ("xception-moe2", 2), ("ganomaly-G", 1),
                                      ("ganomaly-D", 1)])
def test_split_leaves_are_jax_state_shardings_leaf_for_leaf(name, ep):
    """The tensors the port splits over tp 2 are the leaves JAX's
    ``state_shardings`` shards over ``tp``, by name; with ``--moe_shards
    2`` the expert leaves are ``ep``'s (``StateShards``' ep entries) and
    no leaf is on both axes, before and after the rank keeps its experts
    (one of two: ``xception-moe2``); split and whole segments alternate
    in each net (a transposed conv's weight split on its dim 1)."""
    variables, port, bridge = _jax_variables(name)
    mesh = make_mesh(1, 1, 2, ep=ep)
    want = _jax_marks(variables, bridge, mesh)
    assert _port_split(port, ep) == want["tp"]
    assert want["tp"] and len(want["tp"]) < len(port.state_dict())
    whole = {k for k, v in port.state_dict().items() if v.dim()} \
        - want["tp"] - want["ep"]
    assert whole, name
    if ep > 1:
        experts = {f"moe.{k}" for k in ("experts_w1", "experts_b1",
                                        "experts_w2", "experts_b2")}
        places = {"tp": _Place(), "ep": _Place()}
        shards = StateShards([port], places["tp"], places["ep"])
        names = {id(t): k for k, t in (*port.named_parameters(),
                                       *port.named_buffers())}
        assert {axis: {names[id(getattr(m, n))] for m, n, *_, place
                       in shards.tensors if place is on}
                for axis, on in places.items()} == want
        assert want["ep"] == experts and not want["ep"] & want["tp"]
        assert "moe.router" in want["tp"]
        shards.release()
        assert port.moe.experts_w1.shape[0] == port.moe.n_experts // 2
        assert _port_split(port, 2) == want["tp"]
    if name == "ganomaly-G":
        for m, n, channels, dim in split_tensors(port, 2):
            if isinstance(m, nn.ConvTranspose2d):
                assert dim == 1 and m.weight.shape[1] == channels


class _Place:
    """A group's place for ``StateShards``: rank 0 of 2."""
    index, size = 0, 2
    local_ops = frozenset()


@pytest.mark.parametrize("net, tp, whole, held", [
    ("xception", 2, 203_136_513, 101_568_401),
    ("xception-moe", 2, 207_385_121, 103_692_705),
    ("ganomaly-G", 2, 38_359_424, 19_181_248),
    ("ganomaly-D", 2, 11_164_416, 5_590_400),
    ("xception", 4, 203_136_513, 50_784_345)])
def test_full_width_parameters_a_rank(net, tp, whole, held):
    """At the reference width (Xception ``--xwidth 1``, GANomaly 128^2)
    the parameter elements a rank holds: Xception's all but the head's
    289 at 1/tp (its MoE block's 4,248,608 too), GANomaly's but G's
    3-channel output and D's classifier."""
    module = {"xception": lambda: Xception3D(device="meta"),
              "xception-moe": lambda: Xception3D(moe_experts=E,
                                                 device="meta"),
              "ganomaly-G": lambda: GanomalyGenerator(128, device="meta"),
              "ganomaly-D": lambda: GanomalyDiscriminator(
                  128, device="meta")}[net]()
    assert held_elements(module, 1, buffers=False) == whole
    assert held_elements(module, tp, buffers=False) == held


# -- the trainer's commands -----------------------------------------------

@pytest.mark.parametrize("argv", [
    _xception(*TP2, *MOE, batch=2), _ganomaly(*TP2)],
    ids=["xception-moe", "ganomaly"])
def test_trainer_tp2_runs_and_rank0_alone_writes(tmp_path, capfd, argv):
    """The command starts 2 ranks, a tp group; each trains and sweeps to
    the end, rank 0 alone writes the run and its autosaved ``latest.pt``,
    whole (``strict=True`` loads)."""
    before = set(_children())
    assert trainer.main([*argv, "--freq", "1", "--autosave_every", "1",
                         "--synthetic_data", "1", "--device", "cpu",
                         "--no-tensorboard",
                         "--result_root", str(tmp_path)]) is None
    out = capfd.readouterr().out
    assert out.count("[Done]") == 2 and out.count("SAVE PATH") == 1, out
    runs = list(tmp_path.rglob("args.txt"))
    assert len(runs) == 1 and '"tp": 2' in runs[0].read_text()
    latest, = tmp_path.rglob("latest.pt")
    tree = torch.load(latest, weights_only=False)
    if argv[1] == "xception":
        model = Xception3D(width_mult=WIDTH, moe_experts=E)
        model.load_state_dict(tree["state"]["module"], strict=True)
        # (infer takes the width from the checkpoint's shapes)
        infer._load(str(latest), torch.device("cpu"))
    else:
        GanomalyGenerator(16).load_state_dict(tree["netG"]["module"],
                                              strict=True)
        GanomalyDiscriminator(16).load_state_dict(tree["netD"]["module"],
                                                  strict=True)
    assert set(_children()) <= before


# -- float32: the tp 2 steps against JAX's on a {"dp": 1, "tp": 2} mesh ----

def _mesh(tp: int) -> Mesh:
    return Mesh(np.asarray(jax.devices()[:tp]).reshape(1, tp), ("dp", "tp"))


def _given_draws(monkeypatch, draws) -> None:
    monkeypatch.setattr(jaug, "sample_clip_params", lambda *a, **k: tuple(
        jnp.asarray(draws[k]) for k in ("angle", "flip", "crop", "pick")))


def _jax_xception_step(jax_nets, tp: int, monkeypatch):
    cfg, model, variables = jax_nets["xception"]
    batch, draws = _step_batch(32)
    monkeypatch.setattr(fnn.Dropout, "__call__", _identity_dropout)
    _given_draws(monkeypatch, draws)
    jeng = object.__new__(JaxSupervisedEngine)
    jeng.cfg, jeng.model, jeng.pipe = cfg, model, None
    jeng.tx = make_adam(cfg.lr, cfg.beta1)
    mesh = _mesh(tp)
    state = JaxNetState.create(variables, jeng.tx)
    state = jax.device_put(state, state_shardings(mesh, state))
    rows = NamedSharding(mesh, P("dp"))
    state, loss, _ = jax.jit(jeng._train_step_impl, static_argnums=(3,))(
        state, {k: jax.device_put(jnp.asarray(v), rows)
                for k, v in batch.items()}, jax.random.key(0), True)
    sd = xception_state_dict(jax.tree_util.tree_map(
        np.asarray, state.variables()))
    return {"loss/err/train": float(loss)}, sd


def _jax_ganomaly_step(jax_nets, tp: int, monkeypatch):
    cfg, g, g_vars, d, d_vars = jax_nets["ganomaly"]
    batch, draws = _step_batch(16)
    _given_draws(monkeypatch, draws)
    jeng = object.__new__(jganomaly_engine.GanomalyEngine)
    jeng.cfg, jeng.netg, jeng.netd = cfg, g, d
    jeng.tx_g = make_adam(cfg.lr, cfg.beta1)
    jeng.tx_d = make_adam(cfg.lr, cfg.beta1)
    mesh = _mesh(tp)
    g_state = JaxNetState.create(g_vars, jeng.tx_g)
    d_state = JaxNetState.create(d_vars, jeng.tx_d)
    rows = NamedSharding(mesh, P("dp"))
    g_state, d_state, metrics, _ = jax.jit(jeng._train_step_impl)(
        jax.device_put(g_state, state_shardings(mesh, g_state)),
        jax.device_put(d_state, state_shardings(mesh, d_state)),
        {k: jax.device_put(jnp.asarray(v), rows) for k, v in batch.items()},
        jax.random.key(0))
    tree = jax.tree_util.tree_map
    sd = {**{f"netG.{k}": v for k, v in ganomaly_generator_state_dict(
              tree(np.asarray, g_state.variables())).items()},
          **{f"netD.{k}": v for k, v in ganomaly_discriminator_state_dict(
              tree(np.asarray, d_state.variables())).items()}}
    return {k: float(v) for k, v in metrics.items()}, sd


def _leaves(sd: dict) -> list:
    return [np.asarray(sd[k], np.float32) for k in sorted(sd)
            if not k.endswith("num_batches_tracked")]


@pytest.mark.parametrize("name", list(STEPS))
def test_tp2_step_passes_the_gate_against_jax_tp2_mesh(ranks, jax_nets,
                                                       name, monkeypatch):
    """The port's float32 tp 2 step against JAX's on a ``{"dp": 1, "tp":
    2}`` mesh (every divisible leaf sharded over ``tp``), the gate
    calibrated by JAX's own tp 1 step; both ranks' states and metrics
    bit-equal."""
    step = _jax_ganomaly_step if name == "ganomaly" else _jax_xception_step
    replica = step(jax_nets, 2, monkeypatch)
    yardstick = step(jax_nets, 1, monkeypatch)
    got, other = (ranks.result(1, f"{name}.core", r) for r in (0, 1))
    assert got["metrics"] == other["metrics"]
    assert all(torch.equal(v, other["state"][k])
               for k, v in got["state"].items())
    port = {k: v.numpy() for k, v in got["state"].items()}
    assert set(port) == set(replica[1])
    rtol, atol = verify.assert_replica_equivalence(
        (replica[0], _leaves(replica[1])),
        (yardstick[0], _leaves(yardstick[1])),
        (got["metrics"], _leaves(port)), label=f"{name} tp2 port vs JAX")
    assert rtol <= verify.REL_CAP and atol <= verify.ABS_CAP


# -- float64: tp N == tp 1 ---------------------------------------------------

@pytest.mark.parametrize("name", list(RUNS))
def test_tp_equals_tp1_in_float64(ranks, name):
    """Each run within 1e-9 of tp 1 in every kind, its ranks (every tp,
    dp, sp and ep replica's whole state) one replica bit for bit; with
    the decoder dropout on (Xception), so each rank drew tp 1's masks;
    after the state read no buffer requires grad."""
    group = RUNS[name][0]
    got = ranks.result(group, name)
    for r in range(1, WORLD[group]):
        assert got["digest"] == ranks.result(group, name, r)["digest"]
    for kind, (whole, _) in got["distances"].items():
        assert whole <= BOUND, (name, kind, got["distances"])
    # gathered and released, no running statistic requires grad (cuDNN's
    # eval-mode BatchNorm refuses one that does)
    assert got["grad_buffers"] == []


@pytest.mark.parametrize("name", list(RUNS))
def test_tp_sweep_scores_and_checkpoint_names_equal_tp1(ranks, name):
    """The sweep scores as tp 1's and saves the same best ``.pth`` names;
    rank 0 alone writes."""
    group, ref, _ = RUNS[name]
    got = ranks.result(group, name)
    want = ranks.reference(0, ref)
    assert set(got["scores"]) == set(want["scores"])
    for k, v in want["scores"].items():
        assert np.isfinite(v), (k, want["scores"])
        np.testing.assert_allclose(got["scores"][k], v, rtol=1e-9, atol=0,
                                   err_msg=k)
    assert got["saved"] == want["saved"] and want["saved"]
    assert ranks.result(group, name, 1)["saved"] is None


@pytest.mark.parametrize("control", list(CONTROLS))
def test_tp_control_misses(ranks, control):
    """The copy-in's backward not summed, the gather's backward summed,
    the decoder dropout drawn on the slice, a transposed conv's weight cut
    on dim 0: after one tp 2 step each at least 1000x farther from the tp
    1 step than the tp 2 step is, and 1000x past the bound, in Adam's
    moments (the step's gradient)."""
    f = CONTROLS[control]
    synced = ranks.result(1, f"resume.{f}.tp2")["distances"]
    missed = ranks.result(1, f"{f}.tp2.{control}")["distances"]
    for kind in ("exp_avg", "exp_avg_sq"):
        assert missed[kind][0] > 1000 * synced[kind][0], \
            (control, kind, missed[kind], synced[kind])
        assert missed[kind][0] >= 1000 * BOUND, (control, kind,
                                                 missed[kind])


def _rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.parametrize("block", list(BLOCKS))
@pytest.mark.parametrize("op", BLOCK_OPS, ids=["tp2", *BLOCK_OPS[1:]])
def test_block_alone_equals_one_process_and_each_control_misses(
        ranks, block, op):
    """``dp_equivalence``'s ``tp_block`` case, which ``chip_smoke.py`` runs
    at full width: the module over a tp group of 2 against the one-process
    module on the same input and upstream gradient, float32, within 3x
    its own rounding (its distance from float64), both ranks alike; each
    control moves a reading by over 1e4 x that rounding."""
    got = ranks.result(1, f"block.{block}.{op or 'tp2'}")
    alone, exact = got["alone"], got["alone64"]
    kinds = ("out", "x_grad", "grads")
    if op is None:
        for k in kinds:
            assert _rel(got[k], alone[k]) <= 3 * _rel(alone[k], exact[k]), k
            assert _rel(alone[k], exact[k]) < 1e-6, k
            assert torch.equal(
                got[k], ranks.result(1, f"block.{block}.tp2", 1)[k])
        return
    worst = max(_rel(got[k], alone[k]) / _rel(alone[k], exact[k])
                for k in kinds)
    assert worst > 1e4, (block, op, worst)


def _segments(module, ep: int = 1) -> int:
    """The column-parallel segments of a net at tp 2: each conv whose
    outputs split (its BatchNorm and activation), and in the MoE block
    the router and, but under ``--moe_shards``, the experts' two
    products."""
    n = sum(splits(m.out_channels, 2) for m in module.modules()
            if isinstance(m, (nn.Conv3d, nn.Conv2d, nn.ConvTranspose2d)))
    moe = getattr(module, "moe", None)
    if moe is not None:
        n += splits(moe.n_experts, 2) + 2 * (ep == 1) * splits(
            moe.channels, 2)
    return n


@pytest.mark.parametrize("name", ["x.tp2", "xm.tp2", "xm.tp2-ep2",
                                  "xm2.tp2-ep2", "xa.tp2", "g.tp2",
                                  "g.sp2-tp2"])
def test_each_rank_holds_its_slices_and_gathers_once_a_segment(ranks,
                                                               name):
    """Each rank's parameter elements and each Adam moment's are JAX's
    split set at 1/2 and the rest whole (under tp x ep the experts at
    1/2 by ep); a step gathers once a split segment a forward (Xception
    once, twice under ``--accum 2``; GANomaly's G once, D four times:
    real and fake in the G step and in the D step), and sums a copy-in's
    gradient wherever its input is differentiated."""
    group, ref, flags = RUNS[name]
    argv, ep = REFS[ref][0], 2 if "ep2" in name else 1
    experts = int(argv[argv.index("--moe_experts") + 1]) \
        if "--moe_experts" in argv else 0
    if name.startswith("x"):
        nets = [Xception3D(width_mult=WIDTH, moe_experts=experts)]
        micro = 2 if "--accum" in REFS[ref][0] else 1
        gathers = micro * _segments(nets[0], ep)
        # the first conv's input, the clip, takes no gradient
        copies = gathers - micro * splits(nets[0].conv1.out_channels, 2)
    else:
        nets = [GanomalyGenerator(16), GanomalyDiscriminator(16)]
        g, d = (_segments(n) for n in nets)
        gathers = g + 4 * d
        # G's but its first encoder's stem (on the frames); D's fake pass
        # in the G step all; the no-grad real pass none; the D step's two
        # passes but their stems (inputs detached)
        copies = g - 1 + d + 2 * (d - 1)
    # (under tp x ep the experts are ep's halves: as many elements)
    params = sum(held_elements(n, 2, buffers=False) for n in nets)
    state = sum(held_elements(n, 2) for n in nets)
    for r in range(WORLD[group]):
        got = ranks.result(group, name, r)
        held = got["tp_elements"]
        assert held == {"state": state, "params": params,
                        "exp_avg": params, "exp_avg_sq": params}, held
        counts = {k: n for k, (n, _) in got["tp_counts"].items()}
        assert counts == {"gather": gathers, "copy": copies}, counts


# -- checkpoints ---------------------------------------------------------

def _state_distance(got: dict, want: dict, kind: str) -> float:
    diff = torch.cat([(got[kind][k].double() - v.double()).flatten()
                      for k, v in want[kind].items()])
    ref = torch.cat([v.double().flatten() for v in want[kind].values()])
    return float(diff.norm() / ref.norm())


@pytest.mark.parametrize("family", list(FAMILIES))
def test_latest_pt_and_pth_of_tp2_are_canonical_and_load_strict(ranks,
                                                                family):
    """A tp 2 run's ``latest.pt`` (the float64 one-step run's) holds the
    tp 1 shapes, Adam's moments too, and loads with ``strict=True``; so
    do the best ``.pth`` files of its sweep."""
    ranks.join()
    tree = torch.load(ranks.root / f"{family}.tp2.pt", weights_only=False)
    if family == "x":
        nets = {"state": Xception3D(width_mult=WIDTH)}
    else:
        nets = {"netG": GanomalyGenerator(16),
                "netD": GanomalyDiscriminator(16)}
    for net, module in nets.items():
        saved = tree[net]["module"]
        assert {k: v.shape for k, v in saved.items()} == {
            k: v.shape for k, v in module.state_dict().items()}, net
        module.load_state_dict(saved, strict=True)
        moments = tree[net]["optimizer"]["state"]
        assert [tuple(moments[i]["exp_avg"].shape) for i in sorted(moments)] \
            == [tuple(p.shape) for p in module.parameters()], net
    pths = sorted((ranks.root / "group1" / f"resume.{family}.tp2")
                  .rglob("*.pth"))
    assert [p.name for p in pths] == \
        ranks.result(1, f"resume.{family}.tp2")["saved"] and pths
    for pth in pths:
        if family == "x":
            model, _ = infer._load(str(pth), torch.device("cpu"))
            assert isinstance(model, Xception3D)
        else:
            net = "netG" if pth.name.endswith("_netG.pth") else "netD"
            nets[net].load_state_dict(load_state_dict(str(pth)), strict=True)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_resume_across_tp1_and_tp2_continues_the_run(ranks, family):
    """float64: tp 1 (1 step) -> tp 2 (1 step), and tp 2 (1 step) -> tp 1
    (1 step), each within 1e-9 of the uninterrupted 2-step run (the
    reference), its second step's losses too."""
    whole = ranks.reference(0, f"{family}.ref")
    for got in (ranks.result(1, f"resume.{family}.tp1-tp2"),
                ranks.reference(1, f"resume.{family}.tp2-tp1")):
        for kind in ("params", "buffers", "exp_avg", "exp_avg_sq"):
            assert set(got[kind]) == set(whole[kind]), kind
            assert _state_distance(got, whole, kind) <= BOUND, kind
        for mine, ref in zip(got["losses"], whole["losses"][1:],
                             strict=True):
            for k, v in ref.items():
                np.testing.assert_allclose(mine[k], v, rtol=1e-9, atol=0)
    assert eq._digest(ranks.result(1, f"resume.{family}.tp1-tp2", 1)) == \
        eq._digest(ranks.result(1, f"resume.{family}.tp1-tp2"))
