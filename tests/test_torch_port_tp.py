"""``--tp N`` for MyGAN: every conv's output channels split over N ranks by
JAX's ``param_spec`` rule, on the CPU over gloo ranks: against the same
steps in one process, against JAX's ``state_shardings`` and against
JAX's step on a ``{"dp": 1, "tp": 2}`` mesh.

Two groups of ranks are started once for the module, side by side
(``ranks``): one of 2 ranks (tp 2) and one of 4 (dp 2 x tp 2, sp 2 x tp
2).  The ranks run ``vfd_gan_tpu_torch.tools.dp_equivalence`` (no rank
imports JAX or this file), each group meeting through a file under the
test's tmp dir and writing to a log file of its own, with a join timeout
of 400 s.  Every run is MyGAN at 64^2, nfr 16, b4, ngf = ndf = 4 (JAX's
tp test's config, ``tests/test_dp_equivalence.py``), where both nets mix
split and whole convs: G's spatial convs of ``dconv4``, ``dconv5``,
``uconv3`` and ``uconv2`` and D's of ``spatdisc.dconv1``,
``spatdisc.dconv3`` and ``tempdisc.dconv2`` have odd widths and run
whole on every rank, often in a block whose temporal conv is split.

* float64 (the flow stand-in of ``tests/test_torch_port_dp.py``), tp 2
  (b2, 2 steps), dp 2 x tp 2 and sp 2 x tp 2 (b4, 1 step), each with the
  sweep, against tp 1 in one process (``dp_equivalence.OneProcess``), within
  1e-9 (the relative L2 distance of each kind's whole set: parameters,
  BatchNorm buffers, Adam's two moments, the losses); the sweep's scores
  and saved ``.pth`` names; the ranks' whole states bit for bit.
* the controls land at least 1000x farther in every kind (one tp 2
  step each): the BatchNorm sums over the whole grid, the copy-in's backward not
  summed, the gather's backward summed, the split gradients in the
  world's flattened mean.
* the split leaf set is JAX's ``state_shardings`` on a ``tp`` mesh, leaf
  for leaf (through ``utils/weights.py``'s names), a rank's parameter and
  Adam elements follow from it, a step makes one gather a split segment
  a forward; the full-width counts (62% of G's elements a rank at tp 2,
  82% of D's) from the shapes.
* float32: the port's tp 2 ``_gan_core`` step passes ``parallel/
  verify.py``'s gate against JAX's on a ``{"dp": 1, "tp": 2}`` mesh (its
  state sharded by ``state_shardings``), JAX's tp 1 step the yardstick.
* checkpoints: a tp 2 run's ``latest.pt`` holds the tp 1 shapes, equal to
  the run's gathered state, and loads into ``infer`` with ``strict=True``,
  as do its best ``.pth`` files; float64 resumes across tp 1 -> tp 2 and
  tp 2 -> tp 1 continue within 1e-9 of the uninterrupted run.
* G's dconv5 (ngf 4: its spatial conv whole, its temporal conv split)
  alone over the 2 ranks against the one-process block, and its copy-in
  and gather controls (``chip_smoke.py``'s block reading, at full width
  there).
* the trainer's ``--tp 2`` command (2 ranks, rank 0 alone writes); ``--tp
  2`` with c2plus1d, AnoGAN and clstm and with each MyGAN option not
  taken yet exits naming item 13 tp where JAX's config takes it; on
  ``cuda`` past the visible cards.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vfd_gan_tpu import config as jconfig
from vfd_gan_tpu.config import Config as JaxConfig
from vfd_gan_tpu.models.mygan import DualDisc as JaxDualDisc
from vfd_gan_tpu.models.mygan import Generator as JaxGenerator
from vfd_gan_tpu.parallel.mesh import make_mesh, param_spec, state_shardings
from vfd_gan_tpu.train.gan_engine import MyGanEngine as JaxGanEngine
from vfd_gan_tpu.train.state import NetState as JaxNetState
from vfd_gan_tpu.train.state import make_adam
from vfd_gan_tpu_torch.cli import infer, trainer
from vfd_gan_tpu_torch.models.mygan import DualDisc, Generator
from vfd_gan_tpu_torch.parallel import mesh, verify
from vfd_gan_tpu_torch.tools import dp_equivalence as eq
from vfd_gan_tpu_torch.parallel.tensor import (
    held_elements,
    split_tensors,
    splits,
)
from vfd_gan_tpu_torch.train.engine_base import (
    TP_UNPORTED_FAMILIES,
    TP_UNPORTED_OPTIONS,
)
from vfd_gan_tpu_torch.utils.checkpoint import load_state_dict
from vfd_gan_tpu_torch.utils.weights import (
    dualdisc_state_dict,
    generator_state_dict,
)
from test_torch_port_sp import _children, _Ranks
from test_torch_port_threads import one_torch_thread  # noqa: F401

BOUND = 1e-9
B, T, S, W = 4, 16, 64, 4                  # batch, frames, size, ngf = ndf
_COMMON = ["--compute_dtype", "float32", "--synthetic_data", "3",
           "--synthetic_test_batches", "1", "--synthetic_thick_masks",
           "--ep", "1", "--seed", "3"]


def _mygan(*extra, batch: int = B) -> list:
    return ["--model", "mygan", "--batchsize", str(batch), "--nfr", str(T),
            "--isize", str(S), "--ngf", str(W), "--ndf", str(W), *extra,
            *_COMMON]


TP2 = ("--tp", "2")
# name: (group of ranks: 0 of 4, 1 of 2; command line; train steps).  The
# 4-rank runs are b4 (a dp rank two clips, as JAX's tp test runs), one
# step and the sweep (the grid's reductions; the 2-rank group's run takes
# the second step on split Adam moments), the tp 2 runs b2 (both ranks
# hold both clips)
RUNS = {"tp2": (1, _mygan(*TP2, batch=2), 2),
        "dp2-tp2": (0, _mygan("--dp", "2", *TP2), 1),
        "sp2-tp2": (0, _mygan("--sp", "2", *TP2), 1)}
WORLD = {0: 4, 1: 2}
# each run's reference (tp 1, its batch and steps), all in the 2-rank
# group's directory (the 4-rank group waits for its reference there)
REFS = {"tp2": "ref", "dp2-tp2": "ref.b4", "sp2-tp2": "ref.b4"}
CONTROLS = ("tp_bn", "tp_copy", "tp_gather", "tp_mean")
F64 = dict(kind="train", float64=True, flow="standin")
# G's dconv5 at ngf 4 alone (its 115-wide spatial conv whole, its 64-wide
# temporal conv split), as chip_smoke.py's tp phase runs it at full width
BLOCK = dict(kind="tp_block", cin=8 * W, cout=16 * W, shape=[2, 4, 4, 4])
BLOCK_OPS = (None, "tp_copy", "tp_gather")


def _group_cases(group: int, root) -> list:
    """The 4-rank group's runs; the 2-rank group's two references first
    (tp 1 in one process, in the grid's two-pass BatchNorm arithmetic,
    ``dp_equivalence.OneProcess``: 2 steps at b2, 1 step at b4, and the
    sweep, one on each rank), its run, the checkpoint cases and the
    controls."""
    runs = [dict(F64, name=n, argv=argv, steps=steps, sweep=True,
                 ref=REFS[n] if g else str(root / "group1" / REFS[n]))
            for n, (g, argv, steps) in RUNS.items() if g == group]
    if group == 0:
        return runs
    refs = [dict(F64, name=name, dp=1, arith="dp", steps=steps, sweep=True,
                 argv=_mygan(batch=b))
            for name, b, steps in (("ref", 2, 2), ("ref.b4", B, 1))]
    first, *checkpoints = _checkpoint_cases(root)
    blocks = [dict(BLOCK, name=f"block.{op or 'tp2'}",
                   local_ops=[op] if op else []) for op in BLOCK_OPS]
    return [*refs, first, *runs, *checkpoints[:1], *_control_cases(),
            *checkpoints[1:], *blocks]


def _control_cases() -> list:
    """One tp 2 step each, against the one-step tp 1 run (the first
    checkpoint case's)."""
    return [dict(F64, name=f"tp2.{op}", ref="resume.tp1",
                 argv=RUNS["tp2"][1], steps=1, local_ops=[op])
            for op in CONTROLS]


def _checkpoint_cases(root) -> list:
    """float64: tp 1 (1 step) -> its latest.pt -> tp 2 (1 step), and tp 2
    (1 step; against the tp 1 step, the controls' yardstick) -> its
    latest.pt -> tp 1 (1 step), each against the reference's 2 steps."""
    argv = RUNS["tp2"][1]
    at = {k: str(root / f"{k}.pt") for k in ("tp1", "tp2")}
    f64 = dict(F64, argv=argv, steps=1, arith="dp")
    return [dict(f64, name="resume.tp1", dp=1, save=at["tp1"]),
            dict(f64, name="resume.tp2", save=at["tp2"], ref="resume.tp1"),
            dict(f64, name="resume.tp1-tp2", resume=at["tp1"]),
            dict(f64, name="resume.tp2-tp1", dp=1, resume=at["tp2"])]


# -- the float32 step's inputs ----------------------------------------------

def _jax_init(module, *inputs):
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: module.init(k, *inputs, False))(jax.random.key(0)))


@pytest.fixture(scope="module")
def jax_gan():
    """MyGAN's G and D (JAX init) and one step's inputs (b2)."""
    x = jnp.zeros((2, T, S, S, 3), jnp.float32)
    netg = JaxGenerator(ngf=W, dtype=jnp.float32, drop_rate=0.0)
    netd = JaxDualDisc(ndf=W, dtype=jnp.float32)
    rng = np.random.default_rng(5)
    return dict(
        netg=netg, netd=netd, g_vars=_jax_init(netg, x),
        d_vars=_jax_init(netd, x, x),
        data=rng.uniform(-1, 1, (2, T, S, S, 3)).astype(np.float32),
        gt=(rng.uniform(size=(2, T, S, S, 1)) > 0.85).astype(np.float32),
        flows=rng.uniform(-1, 1, (4, T, S, S, 3)).astype(np.float32))


def _core_cases(root, jax_gan) -> list:
    for k in ("data", "gt", "flows"):
        np.save(root / f"{k}.npy", jax_gan[k])
    torch.save({"netG": {k: torch.from_numpy(np.array(v)) for k, v in
                         generator_state_dict(jax_gan["g_vars"]).items()},
                "netD": {k: torch.from_numpy(np.array(v)) for k, v in
                         dualdisc_state_dict(jax_gan["d_vars"]).items()}},
               root / "state.pt")
    return [dict(kind="gan_core", name=name, float64=wide,
                 argv=_mygan(*TP2, batch=2),
                 **{k: str(root / f"{k}.npy")
                    for k in ("data", "gt", "flows")},
                 state=str(root / "state.pt"))
            for name, wide in (("core", False), ("core64", True))]


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory, request):
    """Started before the module's first test: the JAX functions run while
    the ranks compute (the 4 ranks start before JAX inits the weights of
    the 2 ranks' float32 step, and wait for their reference at the end of
    their first run)."""
    group = _Ranks(tmp_path_factory.mktemp("tp"), sum(WORLD.values()))
    # the claim on the rank slots given back however the module ends
    request.addfinalizer(group.close)
    # (the 4 ranks' directory is group0, the 2 ranks' group1)
    group.start(_group_cases(0, group.root), world=WORLD[0])
    jax_gan = request.getfixturevalue("jax_gan")
    group.start([*_group_cases(1, group.root),
                 *_core_cases(group.root, jax_gan)], world=WORLD[1])
    yield group


# The tests that need no rank come first, then those that run JAX: the
# ranks compute meanwhile.

# -- the command and the refusals ----------------------------------------------

def test_trainer_tp2_runs_and_rank0_alone_writes(tmp_path, capfd):
    """The command starts 2 ranks, a tp group; each trains and sweeps to
    the end, rank 0 alone writes the run, its best ``.pth`` files and its
    autosaved ``latest.pt``, all whole (``strict=True`` loads)."""
    before = set(_children())
    argv = [*_mygan(*TP2, batch=2), "--ngf", "2", "--ndf", "2", "--freq",
            "1", "--autosave_every", "1", "--synthetic_data", "1",
            "--device", "cpu",
            "--no-tensorboard", "--result_root", str(tmp_path)]
    assert trainer.main(argv) is None
    out = capfd.readouterr().out
    assert out.count("[Done]") == 2 and out.count("SAVE PATH") == 1, out
    runs = list((tmp_path / "mygan").rglob("args.txt"))
    assert len(runs) == 1 and '"tp": 2' in runs[0].read_text()
    latest, = (tmp_path / "mygan").rglob("latest.pt")
    _canonical(torch.load(latest, weights_only=False), 2)
    infer._load(str(latest), torch.device("cpu"))
    pth, = (tmp_path / "mygan").rglob("*_netG.pth")
    model, _ = infer._load(str(pth), torch.device("cpu"))
    assert model.dconv1.conv.temporal_conv.weight.shape[0] == 2
    assert set(_children()) <= before


# the families --tp does not take yet (Xception and GANomaly it takes:
# tests/test_torch_port_tp_families.py)
_FAMILY = {"anogan": ["--nfr", "16", "--isize", "64"],
           "clstm": ["--nfr", "8", "--isize", "32"],
           "c2plus1d": ["--nfr", "16", "--isize", "32"]}
_OPTIONS = {"ae": ["--ae"], "accum": ["--accum", "2"],
            "remat": ["--remat"], "int8_disc": ["--int8_disc"],
            "host_flow": ["--host_flow"],
            "cache_gt_flow": ["--cache_gt_flow"],
            "ref_mode_quirks": ["--ref_mode_quirks"]}
_REFUSED = {**{f"--model {k}": ["--model", k, *v]
               for k, v in _FAMILY.items()},
            **{f"--{k}": ["--model", "mygan", "--nfr", "16", "--isize",
                          "64", *v] for k, v in _OPTIONS.items()}}


def test_the_options_left_are_the_engines():
    assert set(_OPTIONS) == set(TP_UNPORTED_OPTIONS)
    assert set(_FAMILY) == set(TP_UNPORTED_FAMILIES)


def test_tp_refusals_name_item_13_tp_where_jax_takes_them(tmp_path):
    """``--tp 2`` with the three families not taken yet (c2plus1d,
    AnoGAN, clstm) and with each MyGAN option not taken yet exits naming
    the option and ROADMAP queue 1 item 13 tp; JAX's config takes the
    same command line.  (One test over the ten command lines, as ``test_splits_is_param_specs_rule`` is one over its
    shapes: pytest-xdist's loadfile starts the files with the most tests
    first, and at one test a case this file joined the tier's first wave
    of several-rank files.)"""
    for what, refused in _REFUSED.items():
        argv = [*refused, "--batchsize", "4", "--tp", "2"]
        assert jconfig.parse_args(argv).tp == 2, what
        with pytest.raises(SystemExit, match=rf"--tp with {what}: .*queue 1 "
                                             r"item 13 \(parallelism\) tp"):
            trainer.main([*argv, "--synthetic_data", "2", "--device", "cpu",
                          "--result_root", str(tmp_path / what.strip("-"))])


def test_tp_on_cuda_must_fit_the_visible_cards():
    cfg, _, _ = trainer.parse(["--model", "mygan", "--nfr", "16", "--tp",
                               str(max(1, torch.cuda.device_count()) + 1),
                               "--synthetic_data", "2"])
    with pytest.raises(SystemExit, match="channel shards need"):
        mesh.resolve_dp(cfg, "cuda")



# -- the split leaf set is JAX's state_shardings ------------------------------

def _jax_sharded(variables: dict, bridge) -> set:
    """The port's names of the leaves that JAX's ``state_shardings``
    shards over the ``tp`` axis of ``make_mesh(1, 1, 2)`` (the leaves
    marked through the weight bridge), after checking that each Adam
    moment follows its leaf."""
    m = make_mesh(1, 1, 2)
    tx = make_adam(2e-4, 0.5)
    state = jax.eval_shape(lambda v: JaxNetState.create(v, tx), variables)
    specs = state_shardings(m, state)

    def marked(spec):
        return "tp" in tuple(spec.spec)

    params = jax.tree_util.tree_map(marked, specs.params)
    mu = jax.tree_util.tree_map(marked, specs.opt_state[0].mu)
    assert params == mu and params == jax.tree_util.tree_map(
        marked, specs.opt_state[0].nu)
    marks = {"params": jax.tree_util.tree_map(
        lambda s, v: np.full(v.shape, float(marked(s))), specs.params,
        variables["params"]),
        "batch_stats": jax.tree_util.tree_map(
            lambda s, v: np.full(v.shape, float(marked(s))),
            specs.batch_stats, variables["batch_stats"])}
    out = set()
    for k, v in bridge(marks).items():
        if v.ndim and v.all():
            out.add(k)
        else:
            assert not v.any(), k
    return out


def _port_split(module) -> set:
    names = {id(t): k for k, t in (*module.named_parameters(),
                                   *module.named_buffers())}
    return {names[id(getattr(m, n))]
            for m, n, *_ in split_tensors(module, 2)}


def test_split_leaves_are_jax_state_shardings_leaf_for_leaf(jax_gan):
    """The tensors the port splits over tp 2 are the leaves JAX's
    ``state_shardings`` shards over ``tp``, by name, in both nets; both
    mix split and whole convs, some in one block."""
    port = {"netG": Generator(W), "netD": DualDisc(W, T, S)}
    for net, bridge, key in (("netG", generator_state_dict, "g_vars"),
                             ("netD", dualdisc_state_dict, "d_vars")):
        want = _jax_sharded(jax_gan[key], bridge)
        assert _port_split(port[net]) == want, net
        assert want and len(want) < len(port[net].state_dict())
    whole = {"netG": ("dconv4", "dconv5", "uconv3", "uconv2"),
             "netD": ("spatdisc.dconv1", "spatdisc.dconv3",
                      "tempdisc.dconv2")}
    for net, blocks in whole.items():
        split = _port_split(port[net])
        for blk in blocks:
            assert f"{blk}.conv.spatial_conv.weight" not in split
            assert f"{blk}.conv.temporal_conv.weight" in split, blk


def test_splits_is_param_specs_rule():
    for shape in [(3, 3, 4, 8), (3, 57, 32), (115,), (4,), (3, 3, 3, 4, 1),
                  (2048, 1), (), (0,), (6,), (7, 6)]:
        for tp in (2, 3, 4):
            assert splits(shape[-1] if shape else 0, tp) == (
                param_spec(tp, shape) != P()), (shape, tp)


@pytest.mark.parametrize("tp, g_held, d_held", [(2, 8_447_269, 5_220_257),
                                                (4, 10_610_871, 5_391_266)])
def test_full_width_state_a_rank_follows_the_odd_widths(tp, g_held, d_held):
    """At the reference width (``Generator(32)``, ``DualDisc(32, 16,
    128)``) the parameters and running statistics a rank holds: far from
    1/tp, since the R(2+1)D formula's odd mid widths (G's 21, 115, 921,
    345; D's 209, 837, 27) stay whole, as do the heads."""
    g, d = Generator(32), DualDisc(32, 16, 128)
    assert held_elements(g, 1) == 13_538_673
    assert held_elements(d, 1) == 6_332_267
    assert (held_elements(g, tp), held_elements(d, tp)) == (g_held, d_held)
    assert round(held_elements(g, 2) / held_elements(g, 1), 2) == 0.62
    assert round(held_elements(d, 2) / held_elements(d, 1), 2) == 0.82


# -- float32: the tp 2 step against JAX's on a {"dp": 1, "tp": 2} mesh -------

def _jax_step(jax_gan, tp: int):
    """JAX's ``_gan_core`` on a ``(dp 1, tp)`` mesh of CPU devices: the
    batch sharded ``P("dp")``, each state by ``state_shardings``, the
    flows injected."""
    cfg = JaxConfig(model="mygan", isize=S, nfr=T, batchsize=2, ngf=W,
                    ndf=W, compute_dtype="float32").validate()
    jeng = object.__new__(JaxGanEngine)
    jeng.cfg = cfg
    jeng.netg, jeng.netd = jax_gan["netg"], jax_gan["netd"]
    jeng.tx_g = make_adam(cfg.lr, cfg.beta1)
    jeng.tx_d = make_adam(cfg.lr, cfg.beta1)
    flows = jnp.asarray(jax_gan["flows"])
    jeng._flow = lambda v, streams=1: flows
    m = Mesh(np.asarray(jax.devices()[:tp]).reshape(1, tp), ("dp", "tp"))
    rows = NamedSharding(m, P("dp"))
    g = JaxNetState.create(jax_gan["g_vars"], jeng.tx_g)
    d = JaxNetState.create(jax_gan["d_vars"], jeng.tx_d)
    g = jax.device_put(g, state_shardings(m, g))
    d = jax.device_put(d, state_shardings(m, d))
    g_state, d_state, metrics, _ = jax.jit(jeng._gan_core)(
        g, d, jax.device_put(jax_gan["data"], rows),
        jax.device_put(jax_gan["gt"], rows), jax.random.key(0))

    def named(prefix, bridge, state):
        tree = jax.tree_util.tree_map(np.asarray, state.variables())
        return {f"{prefix}.{k}": np.asarray(v)
                for k, v in bridge(tree).items()}

    sd = {**named("netG", generator_state_dict, g_state),
          **named("netD", dualdisc_state_dict, d_state)}
    return {k: float(v) for k, v in metrics.items()}, sd


def _leaves(sd: dict) -> list:
    return [np.asarray(sd[k], np.float32) for k in sorted(sd)
            if not k.endswith("num_batches_tracked")]


# the spatial features' feature matching: telemetry, in no gradient, where
# JAX's float32 is the one off (tests/test_torch_port_sp.py)
FEATURE_MATCH = "g/err_g_adv_s/train"


def test_tp2_step_passes_the_gate_against_jax_tp2_mesh(ranks, jax_gan):
    """The port's float32 tp 2 step against JAX's on a ``{"dp": 1, "tp":
    2}`` mesh (every divisible leaf sharded over ``tp``), the gate
    calibrated by JAX's own tp 1 step; ``g/err_g_adv_s`` held to the
    port's float64 tp 2 step within the gate's rtol."""
    replica = _jax_step(jax_gan, 2)
    yardstick = _jax_step(jax_gan, 1)
    got = ranks.result(1, "core")
    other = ranks.result(1, "core", 1)
    assert got["metrics"] == other["metrics"]
    assert all(torch.equal(v, other["params"][k])
               for k, v in got["params"].items())
    port = {**got["params"], **got["buffers"]}
    assert set(port) == set(replica[1])
    assert port["netG.dconv5.conv.temporal_conv.weight"].shape[0] == 16 * W

    def gated(metrics):
        assert FEATURE_MATCH in metrics
        return {k: v for k, v in metrics.items() if k != FEATURE_MATCH}

    rtol, atol = verify.assert_replica_equivalence(
        (gated(replica[0]), _leaves(replica[1])),
        (gated(yardstick[0]), _leaves(yardstick[1])),
        (gated(got["metrics"]),
         _leaves({k: v.numpy() for k, v in port.items()})),
        label="mygan tp2 port vs JAX")
    assert rtol <= verify.REL_CAP and atol <= verify.ABS_CAP
    wide = ranks.result(1, "core64")["metrics"][FEATURE_MATCH]
    np.testing.assert_allclose(got["metrics"][FEATURE_MATCH], wide,
                               rtol=rtol, atol=0)


# -- float64: tp N == tp 1 ---------------------------------------------------

@pytest.mark.parametrize("name", list(RUNS))
def test_tp_equals_tp1_in_float64(ranks, name):
    group = RUNS[name][0]
    got = ranks.result(group, name)
    for r in range(1, WORLD[group]):
        assert got["digest"] == ranks.result(group, name, r)["digest"]
    for kind, (whole, _) in got["distances"].items():
        assert whole <= BOUND, (name, kind, got["distances"])


@pytest.mark.parametrize("name", list(RUNS))
def test_tp_sweep_scores_and_checkpoint_names_equal_tp1(ranks, name):
    """The sweep (G in eval mode with its convs split, the opening on the
    whole masks on every rank) scores as tp 1's and saves the same best
    ``.pth`` names; rank 0 alone writes."""
    group = RUNS[name][0]
    got = ranks.result(group, name)
    want = ranks.reference(1, REFS[name])
    assert set(got["scores"]) == set(want["scores"])
    for k, v in want["scores"].items():
        assert np.isfinite(v), (k, want["scores"])
        np.testing.assert_allclose(got["scores"][k], v, rtol=1e-9, atol=0,
                                   err_msg=k)
    assert got["saved"] == want["saved"] and want["saved"]
    assert ranks.result(group, name, 1)["saved"] is None


@pytest.mark.parametrize("control", CONTROLS)
def test_tp_control_misses(ranks, control):
    """The BatchNorm sums over the whole grid, the copy-in's backward not
    summed, the gather's backward summed, the split gradients in the
    world's flattened mean: after one tp 2 step each at least 1000x
    farther from the tp 1 step than the tp 2 step is, and 1000x past the
    bound, in Adam's moments (the step's gradient) and in the kinds the
    control's error reaches in one step (a BatchNorm sum's: the running
    statistics and the losses too)."""
    synced = ranks.result(1, "resume.tp2")["distances"]
    missed = ranks.result(1, f"tp2.{control}")["distances"]
    kinds = ("exp_avg", "exp_avg_sq") + (
        ("buffers", "losses") if control == "tp_bn" else ())
    for kind in kinds:
        assert missed[kind][0] > 1000 * synced[kind][0], \
            (control, kind, missed[kind], synced[kind])
        assert missed[kind][0] >= 1000 * BOUND, (control, kind,
                                                 missed[kind])


def _rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.parametrize("op", BLOCK_OPS, ids=["tp2", *BLOCK_OPS[1:]])
def test_block_alone_equals_one_process_and_each_control_misses(ranks, op):
    """``dp_equivalence``'s ``tp_block`` case, which ``chip_smoke.py`` runs
    at full width: G's dconv5 (ngf 4) over a tp group of 2 against the
    one-process block on the same input and upstream gradient, float32,
    within 3x the block's own rounding (its distance from float64), both
    ranks alike, one gather and one copy-in sum; each control moves a
    reading by over 1e4 x that rounding."""
    got = ranks.result(1, f"block.{op or 'tp2'}")
    alone, exact = got["alone"], got["alone64"]
    kinds = ("out", "x_grad", "grads")
    # the temporal conv's weight and bias, the BatchNorm's scale and bias
    assert got["split"] == 4
    if op is None:
        for k in kinds:
            assert _rel(got[k], alone[k]) <= 3 * _rel(alone[k], exact[k]), k
            assert _rel(alone[k], exact[k]) < 1e-6, k
            assert torch.equal(got[k], ranks.result(1, "block.tp2", 1)[k])
        assert got["tp_counts"] == {"gather": 1, "copy": 1}
        return
    worst = max(_rel(got[k], alone[k]) / _rel(alone[k], exact[k])
                for k in kinds)
    assert worst > 1e4, (op, worst)


def _segments(module) -> int:
    """The column-parallel segments of a net at tp 2: each split spatial
    conv (its BatchNorm and ReLU), each split temporal conv (the block's
    BatchNorm and LeakyReLU)."""
    return sum(splits(m.spatial_conv.out_channels, 2)
               + splits(m.temporal_conv.out_channels, 2)
               for m in module.modules() if hasattr(m, "temporal_conv"))


@pytest.mark.parametrize("name", list(RUNS))
def test_each_rank_holds_its_slices_and_gathers_once_a_segment(ranks,
                                                               name):
    """Each rank's parameter elements and each Adam moment's are JAX's
    split set at 1/2 and the rest whole; a step gathers once a split
    segment a forward (G once, D twice: real, then fake) and sums the
    copy-ins' gradients where the input needs one (not G's first block's
    clip nor each D pass's first flow conv: 3 fewer)."""
    group = RUNS[name][0]
    g, d = Generator(W), DualDisc(W, T, S)
    want = held_elements(g, 2, buffers=False) + held_elements(d, 2,
                                                              buffers=False)
    state = held_elements(g, 2) + held_elements(d, 2)
    ref = ranks.reference(1, REFS[name])["tp_elements"]
    assert ref["params"] == sum(p.numel() for net in (g, d)
                                for p in net.parameters())
    gathers = _segments(g) + 2 * _segments(d)
    for r in range(WORLD[group]):
        got = ranks.result(group, name, r)
        assert got["tp_elements"] == {"state": state, "params": want,
                                      "exp_avg": want, "exp_avg_sq": want}
        counts = {k: n for k, (n, _) in got["tp_counts"].items()}
        assert counts == {"gather": gathers, "copy": gathers - 3}, counts
        # the sweep: G once, D twice a batch, no backward
        assert {k: n for k, (n, _) in got["sweep_tp_counts"].items()} == {
            "gather": gathers}


# -- checkpoints ---------------------------------------------------------

def _canonical(tree: dict, width: int = W) -> None:
    """A train state of the ngf = ndf = ``width`` nets holds every tensor
    whole (the tp 1 shapes), Adam's moments too."""
    for net, module in (("netG", Generator(width)),
                        ("netD", DualDisc(width, T, S))):
        saved = tree[net]["module"]
        assert {k: v.shape for k, v in saved.items()} == {
            k: v.shape for k, v in module.state_dict().items()}, net
        moments = tree[net]["optimizer"]["state"]
        assert [tuple(moments[i]["exp_avg"].shape) for i in sorted(moments)] \
            == [tuple(p.shape) for p in module.parameters()], net


def test_latest_pt_and_pth_of_tp2_are_canonical_and_load_strict(ranks):
    """A tp 2 run's ``latest.pt`` (the float64 one-step run's) holds the
    tp 1 shapes, Adam's moments too, and loads into ``infer`` with
    ``strict=True``; so do the best ``netG`` and ``netD`` ``.pth`` files
    of the tp 2 run's sweep (its latest.pt's continuation at tp 1:
    ``test_resume_across_tp1_and_tp2_continues_the_run``)."""
    ranks.join()
    path = ranks.root / "tp2.pt"
    _canonical(torch.load(path, weights_only=False))
    model, _ = infer._load(str(path), torch.device("cpu"))
    assert isinstance(model, Generator)
    pths = sorted((ranks.root / "group1" / "tp2").rglob("*.pth"))
    assert [p.name for p in pths] == ranks.result(1, "tp2")["saved"]
    g_pth, = (p for p in pths if p.name.endswith("_netG.pth"))
    model, _ = infer._load(str(g_pth), torch.device("cpu"))
    assert model.dconv5.conv.temporal_conv.weight.shape[0] == 16 * W
    d_pth, = (p for p in pths if p.name.endswith("_netD.pth"))
    DualDisc(W, T, S).load_state_dict(load_state_dict(str(d_pth)),
                                      strict=True)


def _state_distance(got: dict, want: dict, kind: str) -> float:
    diff = torch.cat([(got[kind][k].double() - v.double()).flatten()
                      for k, v in want[kind].items()])
    ref = torch.cat([v.double().flatten() for v in want[kind].values()])
    return float(diff.norm() / ref.norm())


def test_resume_across_tp1_and_tp2_continues_the_run(ranks):
    """float64: tp 1 (1 step) -> tp 2 (1 step), and tp 2 (1 step) -> tp 1
    (1 step), each within 1e-9 of the uninterrupted 2-step run (the
    reference), its second step's losses too."""
    whole = ranks.reference(1, "ref")
    for got in (ranks.result(1, "resume.tp1-tp2"),
                ranks.reference(1, "resume.tp2-tp1")):
        for kind in ("params", "buffers", "exp_avg", "exp_avg_sq"):
            assert set(got[kind]) == set(whole[kind]), kind
            assert _state_distance(got, whole, kind) <= BOUND, kind
        for mine, ref in zip(got["losses"], whole["losses"][1:],
                             strict=True):
            for k, v in ref.items():
                np.testing.assert_allclose(mine[k], v, rtol=1e-9, atol=0)
    assert eq._digest(ranks.result(1, "resume.tp1-tp2", 1)) == \
        eq._digest(ranks.result(1, "resume.tp1-tp2"))
