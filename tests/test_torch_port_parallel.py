"""``--dp`` with ``--moe_experts``, ``--int8_disc`` and ``--host_flow``, and
``--pp`` (GPipe over Xception's eight middle blocks), on the CPU in gloo
ranks, against the same steps in one process and against JAX's
``XceptionPipeline`` on 2 virtual devices.

Two groups of ranks are started once for the module, side by side
(``ranks``): one of 2 ranks (the three options at dp 2, ``--pp 2``, the
step against JAX, the host flow and the checkpoint moves) and one of 4
(``--pp 4`` and ``--dp 2 --pp 2``).  The ranks run
``vfd_gan_tpu_torch.tools.dp_equivalence`` (no rank imports JAX or this
file), each group meeting through a file under the test's tmp dir, with a
join timeout of 150 s: a hung rank fails the tests and is killed, and no
rank outlives the module.

* float64, 2 steps, dp 2 against dp 1 (one rank alone), the whole-set
  relative L2 distance of each kind (parameters, BatchNorm buffers,
  Adam's two moments, the losses) within 1e-9; each option's control, the
  same dp 2 run with the option's reduction left to each rank (local
  capacity and slots, local absmax, local stretch), lands 1000x farther
  (and 1000x past the bound).
  - ``--moe_experts 2`` at capacity factor 0.5, where half the tokens
    drop in the dp-1 run.  Its reference computes the BatchNorms in the
    dp path's two-pass form (``dp_equivalence.OneProcess``): against
    torch's BatchNorm the MoE net amplifies the two forms' round-off to
    3.2e-8 in Adam's moments within two steps, in one process as much as
    between the ranks (its expert gradients sit near Adam's eps, where a
    gradient's round-off moves the update lr/eps = 2000x as far).  The
    module's seed (3) lands at 3e-11; other draws of this size were
    measured at 4e-10 to 5e-9, the same conditioning.
  - ``--int8_disc`` on ``tests/test_torch_port_dp.py``'s MyGAN case (the
    flow stand-in).
  - ``--host_flow`` (cv2; skipped without it): cv2's flow of the rank's
    rows plus the stand-in's fixed field (``flow: "own+field"``), which keeps
    the temporal D's BatchNorms off near-constant inputs; the host flow
    of dp 2 is also held bit-equal to dp 1's.
* ``--pp 2`` and ``--pp 4`` with ``--pp_micro`` 1, 2 and 4, and ``--dp 2
  --pp 2 --pp_micro 2`` (b8: 2 clips a rank in each microbatch), each
  within 1e-9 of the chain run sequentially per microbatch in one process
  (in the two-pass BatchNorm arithmetic: per-microbatch statistics over
  a few values amplify the forms' round-off to 1.8e-8; measured distance
  0 for the stages, ~1e-12 with dp); ``--pp_micro 1`` within 1e-9 of the
  plain step; every rank of a grid holds one replica, bit for bit, once
  gathered, and between gathers only its own stage's blocks.
* one float32 ``--pp 2 --pp_micro 2`` step against JAX's
  ``XceptionPipeline`` step on 2 of the 8 virtual CPU devices, at
  ``tests/test_torch_port_supervised_step.py``'s tolerances.
* checkpoints: a ``--pp 2`` state restored from a plain run's
  ``latest.pt`` is that state bit for bit, and a plain run restores a
  ``--pp 2`` run's file bit for bit; that file loads ``strict=True`` into
  a plain Xception and through ``infer._load``.
* the ``--pp`` refusals of the port's config are JAX's, case for case.
"""

import threading
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_supervised_step import _identity_dropout
from vfd_gan_tpu import config as jconfig
from vfd_gan_tpu.models import build_mask_model as jax_build
from vfd_gan_tpu.ops import augment as jaug
from vfd_gan_tpu.parallel.mesh import make_mesh
from vfd_gan_tpu.parallel.pp_xception import (
    XceptionPipeline as JaxPipeline,
    stack_middles,
    unstack_state,
)
from vfd_gan_tpu.train.state import NetState as JaxNetState
from vfd_gan_tpu.train.state import make_adam
from vfd_gan_tpu.train.supervised_engine import (
    SupervisedEngine as JaxSupervisedEngine,
)
from vfd_gan_tpu_torch import config as pconfig
from vfd_gan_tpu_torch.cli import infer
from vfd_gan_tpu_torch.models.xception3d import Xception3D
from vfd_gan_tpu_torch.ops.augment import staging_size
from vfd_gan_tpu_torch.parallel.pipeline import stage_blocks
from vfd_gan_tpu_torch.tools import dp_equivalence as eq
from vfd_gan_tpu_torch.utils.weights import xception_state_dict
from test_torch_port_threads import one_torch_thread  # noqa: F401

try:
    import cv2  # noqa: F401
    HAVE_CV2 = True
except ImportError:
    HAVE_CV2 = False

BOUND = 1e-9
JOIN_S = 150.0
ATOL = 1e-5                       # the supervised step parity's
LR = pconfig.Config().lr
_COMMON = ["--compute_dtype", "float32", "--synthetic_data", "2",
           "--synthetic_test_batches", "1", "--synthetic_thick_masks",
           "--ep", "1", "--seed", "3"]
XCEPTION = ["--model", "xception", "--batchsize", "4", "--nfr", "8",
            "--isize", "32", "--xwidth", "0.0625"] + _COMMON
MYGAN = ["--model", "mygan", "--batchsize", "2", "--nfr", "16", "--isize",
         "64", "--ngf", "2", "--ndf", "2"] + _COMMON
# the options, each with its reduction's control and its case's settings
OPTIONS = {
    "moe": (XCEPTION + ["--moe_experts", "2"], "moe",
            {"moe_capacity": 0.5}, {"arith": "dp"}),
    "int8_disc": (MYGAN + ["--int8_disc"], "absmax", {"flow": "standin"},
                  {}),
    "host_flow": (MYGAN + ["--host_flow"], "stretch",
                  {"flow": "own+field"}, {}),
}
# the pipelines: (group world, pp, pp_micro, batch)
PIPES = {"pp2-m1": (2, 2, 1, 4), "pp2-m2": (2, 2, 2, 4),
         "pp2-m4": (2, 2, 4, 4), "pp4-m1": (4, 4, 1, 4),
         "pp4-m2": (4, 4, 2, 4), "pp4-m4": (4, 4, 4, 4),
         "dp2pp2-m2": (4, 2, 2, 8)}
# the step against JAX: b4 (two microbatches of 2), T8, 32^2
B, T, S = 4, 8, 32


def _pipe_argv(name: str) -> list:
    _, pp, m, b = PIPES[name]
    return [*XCEPTION, "--batchsize", str(b), "--pp", str(pp),
            "--pp_micro", str(m)]


def _option_cases() -> list:
    cases = []
    for name, (argv, ctl, kw, ref_kw) in OPTIONS.items():
        if name == "host_flow" and not HAVE_CV2:
            continue
        base = dict(kind="train", argv=argv, steps=2, float64=True, **kw)
        cases.append(dict(base, name=f"{name}.dp1", dp=1, **ref_kw))
        cases.append(dict(base, name=f"{name}.dp2", dp=2,
                          ref=f"{name}.dp1"))
        cases.append(dict(base, name=f"{name}.local", dp=2,
                          ref=f"{name}.dp1", local_ops=[ctl]))
    return cases


def _pipe_cases(world: int) -> list:
    base = dict(kind="train", steps=2, float64=True)
    cases = [dict(base, name=f"plain{world}", argv=XCEPTION, dp=1)]
    for name, (w, _, m, _) in PIPES.items():
        if w != world:
            continue
        cases.append(dict(base, name=f"{name}.ref", argv=_pipe_argv(name),
                          dp=1, arith="dp", sweep=True))
        cases.append(dict(base, name=name, argv=_pipe_argv(name), dp=2,
                          ref=f"{name}.ref", sweep=True))
        if m == 1:
            cases.append(dict(base, name=f"{name}.plain",
                              argv=_pipe_argv(name), dp=2,
                              ref=f"plain{world}"))
    return cases


def _resume_cases(root: Path) -> list:
    """plain (2 steps) -> its latest.pt -> --pp 2 restored (0 steps) and
    trained 2 steps -> that file -> plain restored (0 steps)."""
    plain, piped = str(root / "plain.pt"), str(root / "piped.pt")
    base = dict(kind="train", argv=XCEPTION)
    pp = [*XCEPTION, "--pp", "2", "--pp_micro", "2"]
    return [dict(base, name="resume.plain", dp=1, steps=2, save=plain),
            dict(base, name="resume.pp0", argv=[*pp, "--resume", plain],
                 dp=2, steps=0),
            dict(base, name="resume.pp2", argv=[*pp, "--resume", plain],
                 dp=2, steps=2, save=piped),
            dict(base, name="resume.back", dp=1, steps=0,
                 argv=[*XCEPTION, "--resume", piped])]


class _Ranks:
    """The module's groups of ranks, each running in the background."""

    def __init__(self, root):
        self.root = root
        self.errors = []
        self.threads = []

    def start(self, cases, world: int) -> None:
        out = self.root / f"group{len(self.threads)}"
        thread = threading.Thread(target=self._run, args=(cases, out, world),
                                  daemon=True)
        thread.start()
        self.threads.append(thread)

    def _run(self, cases, out, world):
        try:
            eq.run(cases, out, world=world, backend="gloo", timeout=JOIN_S)
        except Exception as e:          # reported by every result()
            self.errors.append(e)

    def join(self) -> None:
        for thread in self.threads:
            thread.join(JOIN_S + 20)
            assert not thread.is_alive(), "the ranks outlived their join"
        if self.errors:
            raise self.errors[0]

    def _file(self, name: str) -> Path:
        self.join()
        found, = self.root.glob(f"group*/{name}")
        return found

    def result(self, name: str, rank: int = 0) -> dict:
        return torch.load(self._file(f"{name}.rank{rank}.pt"),
                          weights_only=False)

    def reference(self, name: str) -> dict:
        return torch.load(self._file(f"{name}.ref.pt"), weights_only=False)


# -- the step against JAX's pipeline -----------------------------------------

def _jax_cfg():
    return jconfig.Config(model="xception", batchsize=B, nfr=T, isize=S,
                          xwidth=1 / 16, pp=2, pp_micro=2,
                          compute_dtype="float32", tensorboard=False).validate()


def _step_inputs():
    s = staging_size(S)
    rng = np.random.default_rng(4)
    data = rng.integers(0, 256, (B, T, s, s, 3), dtype=np.uint8)
    mask = np.zeros((B, T, s, s, 1), np.uint8)
    mask[:, :, 4:s - 4, 5:s - 6] = 255
    batch = {"data": data, "real": data, "mask": mask}
    draws = {"angle": np.linspace(-0.17, 0.15, B).astype(np.float32),
             "flip": np.arange(B, dtype=np.int32) % 2,
             "crop": np.ones(B, np.int32), "pick": np.arange(B) % 2 == 0}
    return batch, draws


@pytest.fixture(scope="module")
def jax_init():
    """JAX's Xception (width 1/16) and its initial variables."""
    model = jax_build("xception", _jax_cfg(), jnp.float32)
    x = jnp.zeros((B, T, S, S, 3), jnp.float32)
    variables = jax.jit(lambda k: model.init(
        {"params": k, "dropout": k}, x, False))(jax.random.key(0))
    return model, jax.tree_util.tree_map(np.asarray, variables)


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory, jax_init):
    """Started before the module's first test: the JAX step proceeds
    while the ranks compute."""
    group = _Ranks(tmp_path_factory.mktemp("parallel"))
    root = group.root
    batch, draws = _step_inputs()
    np.savez(root / "batch.npz", **batch)
    np.savez(root / "draws.npz", **draws)
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                xception_state_dict(jax_init[1]).items()}, root / "state.pt")
    core = dict(kind="pp_core", name="pp_core",
                argv=[*XCEPTION, "--pp", "2", "--pp_micro", "2"],
                state=str(root / "state.pt"), batch=str(root / "batch.npz"),
                draws=str(root / "draws.npz"))
    np.save(root / "video.npy", _flow_video())
    host = [dict(kind="flow", name="host_flow.flow", host=True,
                 video=str(root / "video.npy"), streams=2)] \
        if HAVE_CV2 else []
    def handoffs(world):
        return [dict(kind="handoff", name=f"handoff{world}.m{m}", n_micro=m)
                for m in (1, 2)]

    group.start([*handoffs(4), *_pipe_cases(4)], world=4)
    group.start([core, *handoffs(2), *_option_cases(), *host,
                 *_pipe_cases(2), *_resume_cases(root)], world=2)
    yield group
    for thread in group.threads:
        thread.join(JOIN_S + 20)


def _flow_video() -> np.ndarray:
    """A gt-like stream of moving squares and a soft prediction stream,
    RGB in [-1, 1], 2 clips a stream, gt stream first."""
    r = np.random.default_rng(21)
    gt = np.zeros((2, 4, 32, 32), np.float32)
    for i in range(2):
        y, x = r.integers(4, 14, 2)
        for f in range(4):
            gt[i, f, y + f:y + f + 10, x + f // 2:x + f // 2 + 11] = 1.0
    pred = gt * (0.55 + 0.3 * np.arange(2)[:, None, None, None]) + 0.1 \
        + r.uniform(0, 0.05, gt.shape).astype(np.float32)
    both = np.concatenate([gt, pred])[..., None].repeat(3, axis=-1)
    return (both * 2.0 - 1.0).astype(np.float32)


def _step_parity(got: dict, want: dict) -> None:
    """``tests/test_torch_port_supervised_step.py``'s rule: every updated
    parameter within the sign-flip envelope of Adam's first step, and at
    most 2% beyond 5e-6."""
    total = loose = 0
    for k, v in want.items():
        if "running" in k or k.endswith("num_batches_tracked"):
            continue
        d = np.abs(got[k].numpy() - v)
        assert d.max() <= 2.5 * LR, (k, float(d.max()))
        total += d.size
        loose += int((d > 5e-6).sum())
    assert total and loose / total < 0.02, (loose, total)


def test_pp2_step_tracks_jax_pipeline_on_2_devices(ranks, jax_init,
                                                   monkeypatch):
    model, variables = jax_init
    batch, draws = _step_inputs()
    monkeypatch.setattr(fnn.Dropout, "__call__", _identity_dropout)
    monkeypatch.setattr(jaug, "sample_clip_params", lambda *a, **k: tuple(
        jnp.asarray(draws[k]) for k in ("angle", "flip", "crop", "pick")))
    jcfg = _jax_cfg()
    jeng = object.__new__(JaxSupervisedEngine)
    jeng.cfg, jeng.model = jcfg, model
    mesh = make_mesh(dp=1, pp=2, devices=jax.devices()[:2])
    jeng.pipe = JaxPipeline(model, mesh, jcfg.n_pp_micro)
    jeng.tx = make_adam(jcfg.lr, jcfg.beta1)
    state = JaxNetState.create(
        {"params": stack_middles(variables["params"]),
         "batch_stats": stack_middles(variables["batch_stats"])}, jeng.tx)
    state, loss, _ = jax.jit(jeng._train_step_impl, static_argnums=(3,))(
        state, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.key(0), True)
    want = xception_state_dict(jax.tree_util.tree_map(
        np.asarray, unstack_state(state).variables()))

    got = ranks.result("pp_core")
    other = ranks.result("pp_core", 1)
    assert got["loss"] == other["loss"]
    assert all(torch.equal(v, other["state"][k])
               for k, v in got["state"].items())
    # each microbatch handed 0 -> 1 forward, and its gradient 1 -> 0
    assert got["hand_offs"] == other["hand_offs"] == 4
    np.testing.assert_allclose(got["loss"], float(loss), rtol=0, atol=ATOL)
    sd = got["state"]
    assert set(sd) - {k for k in sd if k.endswith("num_batches_tracked")} \
        == set(want) - {k for k in want if k.endswith("num_batches_tracked")}
    _step_parity(sd, want)
    for k, v in want.items():
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), v, rtol=0, atol=ATOL,
                                       err_msg=k)
    # a middle block's statistics moved once per microbatch
    assert int(sd["block4.rep.2.num_batches_tracked"]) == 2
    assert int(sd["bn1.num_batches_tracked"]) == 1


# -- float64: the three options at dp 2 == dp 1 --------------------------------

def _option(name: str) -> str:
    if name == "host_flow" and not HAVE_CV2:
        pytest.skip("--host_flow needs cv2")
    return name


@pytest.mark.parametrize("name", list(OPTIONS))
def test_option_dp2_equals_dp1_in_float64(ranks, name):
    got = ranks.result(f"{_option(name)}.dp2")
    assert got["digest"] == ranks.result(f"{name}.dp2", 1)["digest"]
    for kind, (whole, _) in got["distances"].items():
        assert whole <= BOUND, (name, kind, got["distances"])


@pytest.mark.parametrize("name", list(OPTIONS))
def test_option_local_control_misses(ranks, name):
    """The option's reduction left to each rank lands at least 1000x
    farther from dp 1 than the synced run, and 1000x past the bound, in
    every kind."""
    synced = ranks.result(f"{_option(name)}.dp2")["distances"]
    control = ranks.result(f"{name}.local")["distances"]
    for kind in synced:
        assert control[kind][0] >= 1000 * max(synced[kind][0], BOUND), \
            (name, kind, control[kind], synced[kind])


def test_moe_reference_drops_tokens(ranks):
    assert all(f > 0 for f in ranks.reference("moe.dp1")["moe_dropped"])


def test_host_flow_at_dp2_is_bit_equal_to_dp1(ranks):
    if not HAVE_CV2:
        pytest.skip("--host_flow needs cv2")
    parts = [ranks.result("host_flow.flow", r)["flow"].numpy() for r in
             (0, 1)]
    # each rank's rows of both streams, back in the global order
    both = np.concatenate([p.reshape(2, 1, *p.shape[1:]) for p in parts],
                          axis=1)
    alone = ranks.result("host_flow.flow")["flow_alone"].numpy()
    np.testing.assert_array_equal(both.reshape(alone.shape), alone)
    assert np.ptp(alone[:2]) > 0.5 and np.ptp(alone[2:]) > 0.5


# -- float64: the pipeline == the chain per microbatch ----------------------

@pytest.mark.parametrize("name", list(PIPES))
def test_pp_equals_the_sequential_chain_in_float64(ranks, name):
    world = PIPES[name][0]
    got = ranks.result(name)
    # every rank of the grid holds one replica, bit for bit
    for r in range(1, world):
        assert ranks.result(name, r)["digest"] == got["digest"], r
    for kind, (whole, _) in got["distances"].items():
        assert whole <= BOUND, (name, kind, got["distances"])
    want = ranks.reference(f"{name}.ref")
    assert got["scores"] == pytest.approx(want["scores"], rel=1e-9)
    assert got["saved"] == want["saved"] and want["saved"]


@pytest.mark.parametrize("name", ["pp2-m2", "pp4-m2", "dp2pp2-m2"])
def test_a_stage_holds_its_blocks_alone(ranks, name):
    """Between gathers a rank holds the parameters outside the chain and
    its stage's 8/pp middle blocks, no storage of the others'."""
    world, pp, _, _ = PIPES[name]
    model = Xception3D(width_mult=1 / 16)
    chain = sum(p.numel() for b in model.middle_blocks()
                for p in b.parameters())
    total = sum(p.numel() for p in model.parameters())
    for r in range(world):
        held = ranks.result(name, r)["held"]
        assert held == total - chain + chain // pp, (r, held)


@pytest.mark.parametrize("name", [n for n, v in PIPES.items() if v[2] == 1])
def test_pp_micro_1_equals_the_plain_step(ranks, name):
    got = ranks.result(f"{name}.plain")
    for kind, (whole, _) in got["distances"].items():
        assert whole <= BOUND, (name, kind, got["distances"])


# -- checkpoints -------------------------------------------------------------

def _same(a: dict, b: dict) -> None:
    for kind in ("params", "buffers", "exp_avg", "exp_avg_sq"):
        assert set(a[kind]) == set(b[kind]), kind
        for k, v in a[kind].items():
            assert torch.equal(v, b[kind][k]), (kind, k)


def test_resume_plain_pp_plain_is_exact(ranks):
    plain = ranks.reference("resume.plain")
    for r in (0, 1):
        _same(ranks.result("resume.pp0", r), plain)
    piped = ranks.result("resume.pp2")
    _same(ranks.result("resume.pp2", 1), piped)
    assert len(piped["losses"]) == 2
    _same(ranks.reference("resume.back"), piped)


def test_pp_checkpoint_is_canonical(ranks):
    ranks.join()
    path = ranks.root / "piped.pt"
    tree = torch.load(path, weights_only=False)
    assert tree["step"] == 4
    plain = Xception3D(width_mult=1 / 16)
    plain.load_state_dict(tree["state"]["module"], strict=True)
    assert len(tree["state"]["optimizer"]["state"]) == \
        len(list(plain.parameters()))
    net, _ = infer._load(str(path), torch.device("cpu"))
    assert type(net).__name__ == "Xception3D"


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("m", [1, 2])
def test_handoffs_carry_channels_last_activations(ranks, world, m):
    """A stage's channels-last output reaches the next stage in order (a
    conv's output on the card is channels-last: received into a buffer
    with its strides, the sender's contiguous bytes would land permuted),
    and the gradient comes back: every rank holds the chain's output, and
    stage 0 the input's gradient, of ``prod(s + 2)`` times the input."""
    gen = torch.Generator().manual_seed(11)
    h = torch.rand((4, 3, 2, 4, 4), generator=gen)
    w = torch.rand((4, 3, 2, 4, 4), generator=gen)
    k = float(np.prod([s + 2.0 for s in range(world)]))
    for r in range(world):
        got = ranks.result(f"handoff{world}.m{m}", r)
        torch.testing.assert_close(got["out"], h * k, rtol=1e-6, atol=0)
        if r == 0:
            torch.testing.assert_close(got["grad"], w * k, rtol=1e-6,
                                       atol=0)
        # forward and backward: one hand-off each way per microbatch, but
        # a middle stage hands two (in and out)
        edge = r in (0, world - 1)
        assert got["hand_offs"] == (2 if edge else 4) * m, got["hand_offs"]


def test_stage_blocks_are_contiguous():
    assert [list(stage_blocks(8, 2, s)) for s in (0, 1)] == [
        [0, 1, 2, 3], [4, 5, 6, 7]]
    assert [list(stage_blocks(8, 4, s)) for s in range(4)] == [
        [0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError):
        stage_blocks(8, 3, 0)


# -- the config refuses what JAX's refuses -----------------------------------

@pytest.mark.parametrize("bad", [
    ["--model", "xception", "--pp", "3"],
    ["--model", "xception", "--pp", "0"],
    ["--model", "clstm", "--pp", "2"],
    ["--model", "xception", "--pp", "2", "--sp", "2"],
    ["--model", "xception", "--pp", "2", "--tp", "2"],
    ["--model", "xception", "--pp", "2", "--accum", "2"],
    ["--model", "xception", "--pp", "2", "--pp_micro", "3"],
    ["--model", "xception", "--pp", "2", "--pp_micro", "-1"],
    ["--model", "xception", "--pp", "2", "--moe_experts", "2"],
], ids=lambda v: "_".join(v[2:]))
def test_pp_refusals_are_jaxs(bad):
    argv = bad + ["--isize", "32", "--nfr", "8", "--batchsize", "4"]
    with pytest.raises(ValueError) as mine:
        pconfig.parse_args(argv)
    with pytest.raises(ValueError) as theirs:
        jconfig.parse_args(argv)
    assert str(mine.value) == str(theirs.value)
    assert pconfig.parse_args(
        ["--model", "xception", "--pp", "4"]).n_pp_micro == \
        jconfig.parse_args(["--model", "xception", "--pp", "4"]).n_pp_micro
