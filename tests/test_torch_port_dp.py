"""``--dp`` on the CPU: data-parallel training of the six families over a
gloo group of 2 processes, against the same steps in one process and
against JAX's step on a 2-device mesh.

Two groups of 2 ranks are started once for the module, side by side
(``ranks``; the ranks run ``vfd_gan_tpu_torch.tools.dp_equivalence``, so
no rank imports JAX, this file or ``conftest.py``), each meeting through a
file under the test's tmp dir, with a join timeout of 300 s: a hung rank
fails the tests and is killed, and no rank outlives the module.

* float64 (the nets, Adam's state and the batch; ``EngineBase.
  to_float64``): 2 steps of each family at dp 2 against the same 2 steps
  at dp 1 (one rank alone), plus clstm under ``--accum 2`` and under
  ``--device_scoring``.  Bound: 1e-9, the relative L2 distance of each
  kind's whole set of tensors as one vector (parameters, BatchNorm
  buffers, Adam's first and second moments, the per-step losses).  The
  controls, the same dp 2 run with the BatchNorm statistics left local to
  each rank, or summed over the ranks in the forward alone (as a plain
  ``dist.all_reduce`` would: the backward then misses the other ranks'
  share), must land 1000x farther (and 1000x past the bound).  One
  tensor may hold only round-off: a conv bias right before a BatchNorm
  has a true gradient of 0, so its Adam moments are noise (measured:
  relative distance O(1) in such tensors while their set's is 4e-11), and
  the whole set is what is bounded.  MyGAN's case runs a flow stand-in
  (``tools/dp_equivalence._standin_flow``: its synced stretch, smooth, plus
  a fixed field) because the flow's bfloat16 operand rounding is not
  smooth; without the field the temporal D's BatchNorms see near-constant
  inputs and amplify round-off ~1e5-fold (measured: its torch and
  two-pass BatchNorms part by 1e-11 in one process).  The measured
  distances are ~1e-16 for clstm and GANomaly, 1e-15-1e-11 for c2plus1d,
  Xception and AnoGAN, and up to 2.8e-10 (MyGAN's parameters) at most.
* the sweep at dp 2 (every rank runs it whole) gives dp 1's scores and
  saves the same best ``.pth`` files, on the host and on the device
  (each family's but c2plus1d's, whose engine's sweep is clstm's).
* one MyGAN float32 ``_gan_core`` step at dp 2 (flows injected as
  ``tests/test_torch_port_train.py`` injects them, dropout off) passes
  the ``parallel/verify.py`` gate against JAX's step on a 2-device mesh,
  calibrated by JAX's own dp 1 step.
* the flow's synced min-max stretch at dp 2 equals JAX's stretch on a
  2-device mesh bit for bit, and the dp 2 flow equals the port's dp 1
  flow bit for bit (its plain path; against JAX's flow the quantile
  bounds of ``tests/test_torch_port_flow.py``: the luma after the stretch
  is one float32 ulp apart where XLA fuses a multiply-add, and the
  correlations' bfloat16 operands round on either side of a boundary).
* the trainer's ``--dp 2`` command (rank 0 alone writes; SIGTERM parks
  both ranks at one step), a failing rank and a hung rank, the refusal
  that names ROADMAP queue 1 item 13 (``--tp``; ``--moe_shards`` since
  ported: its engine built in one process holds the option)
  and the commands it held until they were ported (``--dp 2`` with
  ``--moe_experts``, ``--int8_disc`` and ``--host_flow``; ``--pp 2``),
  ``auto_dp`` and the rank rows.
"""

import os
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from vfd_gan_tpu.config import Config as JaxConfig
from vfd_gan_tpu.models.mygan import DualDisc as JaxDualDisc
from vfd_gan_tpu.models.mygan import Generator as JaxGenerator
from vfd_gan_tpu.ops import flow as jflow
from vfd_gan_tpu.ops import image as jimage
from vfd_gan_tpu.parallel import mesh as jmesh
from vfd_gan_tpu.parallel import verify as jverify
from vfd_gan_tpu.train.gan_engine import MyGanEngine as JaxGanEngine
from vfd_gan_tpu.train.state import NetState as JaxNetState
from vfd_gan_tpu.train.state import make_adam
from vfd_gan_tpu_torch.cli import trainer
from vfd_gan_tpu_torch.parallel import mesh, verify
from vfd_gan_tpu_torch.tools import dp_equivalence as eq
from vfd_gan_tpu_torch.utils.weights import (
    dualdisc_state_dict,
    generator_state_dict,
)
from rank_slots import Slots
from test_torch_port_threads import one_torch_thread  # noqa: F401

BOUND = 1e-9
# a hung rank's bound: the c2plus1d group ran past 110 s once the tier
# also ran tests/test_torch_port_sp.py's ranks and JAX compiles beside it
JOIN_S = 300.0
# the float32 MyGAN step against JAX: b2 (one clip per rank), T16, 64^2
B, T, S, NGF, NDF = 2, 16, 64, 4, 4
_COMMON = ["--compute_dtype", "float32", "--synthetic_data", "2",
           "--synthetic_test_batches", "1", "--synthetic_thick_masks",
           "--ep", "1", "--seed", "3"]
FAMILIES = {
    "mygan": ["--model", "mygan", "--batchsize", "2", "--nfr", "16",
              "--isize", "64", "--ngf", "2", "--ndf", "2"],
    "clstm": ["--model", "clstm", "--batchsize", "4", "--nfr", "8",
              "--isize", "16"],
    # 2 clips per rank: its bottleneck BatchNorm normalises one value per
    # channel and clip, so the local control needs two
    "c2plus1d": ["--model", "c2plus1d", "--batchsize", "4", "--nfr", "16",
                 "--isize", "16"],
    "xception": ["--model", "xception", "--batchsize", "4", "--nfr", "8",
                 "--isize", "32", "--xwidth", "0.0625"],
    # BatchNorm1d over the batch: 2 clips per rank for the local control
    "anogan": ["--model", "anogan", "--batchsize", "4", "--nfr", "8",
               "--isize", "16"],
    "ganomaly": ["--model", "ganomaly", "--batchsize", "4", "--nfr", "8",
                 "--isize", "16"],
    "clstm-accum2": ["--model", "clstm", "--batchsize", "4", "--nfr", "8",
                     "--isize", "16", "--accum", "2"],
    "clstm-device_scoring": ["--model", "clstm", "--batchsize", "4",
                             "--nfr", "8", "--isize", "16",
                             "--device_scoring"],
}
# the controls that must miss, by family: BatchNorm statistics local to
# each rank, and summed over the ranks in the forward only (the backward
# then misses the other ranks' share; c2plus1d's and AnoGAN's, the
# longest, are left to the local control)
CONTROLS = {"mygan": ("local", "forward"), "clstm": ("local", "forward"),
            "c2plus1d": ("local",), "xception": ("local", "forward"),
            "anogan": ("local",), "ganomaly": ("local", "forward")}
# the cases whose sweep is held (c2plus1d's, 36M parameters in float64,
# would be the longest; its engine's sweep is clstm's)
SWEPT = [f for f in FAMILIES if f != "c2plus1d"]
# two groups of two ranks run side by side: c2plus1d's cases alone (its
# 36M float64 parameters take as long as all the others), then the rest,
# their references in an order that shares them out to the two ranks
# (index parity) about evenly
GROUPS = (("c2plus1d",), ("mygan", "anogan", "xception", "clstm",
                          "clstm-accum2", "ganomaly",
                          "clstm-device_scoring"))


def _cases(families) -> list[dict]:
    def base(f):
        return dict(kind="train", argv=FAMILIES[f] + _COMMON, steps=2,
                    float64=True, sweep=f in SWEPT,
                    flow="standin" if f == "mygan" else "real")

    cases = [dict(base(f), name=f"{f}.dp1", dp=1) for f in families]
    for f in families:
        cases.append(dict(base(f), name=f"{f}.dp2", dp=2, ref=f"{f}.dp1"))
        for stats in CONTROLS.get(f, ()):
            cases.append(dict(base(f), name=f"{f}.{stats}", dp=2,
                              ref=f"{f}.dp1", bn_stats=stats, sweep=False))
    return cases


def _jax_cases(root) -> list[dict]:
    """The cases that hold the port against JAX."""
    return [dict(kind="gan_core", name="gan_core",
                 argv=["--model", "mygan", "--batchsize", str(B), "--nfr",
                       str(T), "--isize", str(S), "--ngf", str(NGF),
                       "--ndf", str(NDF), *_COMMON],
                 **{k: str(root / f"{k}.npy") for k in ("data", "gt",
                                                         "flows")},
                 state=str(root / "state.pt")),
            dict(kind="flow", name="flow", video=str(root / "video.npy"),
                 streams=2)]


def _jax_init(module, *inputs):
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: module.init(k, *inputs, False))(jax.random.key(0)))


def _flow_video() -> np.ndarray:
    """gt-like binary squares and a soft prediction stream as RGB in [-1,
    1], 2 clips per stream, gt stream first."""
    r = np.random.default_rng(21)
    gt = np.zeros((2, 4, 32, 32), np.float32)
    for i in range(2):
        y, x = r.integers(4, 14, 2)
        for f in range(4):
            gt[i, f, y + f:y + f + 10, x + f // 2:x + f // 2 + 11] = 1.0
    pred = gt * 0.55 + 0.2 + r.uniform(0, 0.05, gt.shape).astype(np.float32)
    both = np.concatenate([gt, pred])[..., None].repeat(3, axis=-1)
    return (both * 2.0 - 1.0).astype(np.float32)


class _Ranks:
    """The module's groups of 2 ranks, each running in the background.

    ``start`` returns once the group's ranks are spawned, and the ranks
    write to a log file of their own: a test that counts this process's
    children or captures its output never sees a group spawned while it
    runs (on a loaded host a thread's spawn could come after the first
    test's count began, and its ranks' ``SAVE PATH`` lines then landed in
    that test's captured output)."""

    def __init__(self, root, ranks: int):
        self.root = root
        self.errors = []
        self.threads = []
        # the module's ranks, claimed before its first group starts and
        # given back when its last one has ended
        # (tests/test_torch_port_sp._Ranks)
        self.slots = Slots(root, ranks)

    def start(self, cases) -> None:
        self.slots.acquire()
        spawned = threading.Event()
        thread = threading.Thread(
            target=self._run, args=(cases, len(self.threads), spawned),
            daemon=True)
        thread.start()
        self.threads.append(thread)
        spawned.wait(JOIN_S)

    def _run(self, cases, index: int, spawned: threading.Event):
        try:
            eq.run(cases, self.root / f"group{index}", world=2,
                   backend="gloo", timeout=JOIN_S,
                   log=self.root / f"group{index}.log",
                   on_spawn=lambda pids: spawned.set())
        except Exception as e:          # reported by every result()
            self.errors.append(e)
        finally:
            spawned.set()
            self.slots.ended(2)

    def join(self) -> None:
        for thread in self.threads:
            thread.join(JOIN_S + 20)
            assert not thread.is_alive(), "the ranks outlived their join"
        if self.errors:
            raise self.errors[0]

    def close(self) -> None:
        """The module's end: its groups waited for, its claim given
        back."""
        for thread in self.threads:
            thread.join(JOIN_S + 20)
        self.slots.release()

    def _file(self, name: str) -> Path:
        self.join()
        found, = self.root.glob(f"group*/{name}")
        return found

    def result(self, name: str, rank: int = 0) -> dict:
        return torch.load(self._file(f"{name}.rank{rank}.pt"))

    def reference(self, name: str) -> dict:
        return torch.load(self._file(f"{name}.ref.pt"))


@pytest.fixture(scope="module")
def jax_gan():
    """MyGAN's G and D (JAX init) and one step's inputs."""
    x = jnp.zeros((B, T, S, S, 3), jnp.float32)
    netg = JaxGenerator(ngf=NGF, dtype=jnp.float32, drop_rate=0.0)
    netd = JaxDualDisc(ndf=NDF, dtype=jnp.float32)
    rng = np.random.default_rng(5)
    return dict(
        netg=netg, netd=netd, g_vars=_jax_init(netg, x),
        d_vars=_jax_init(netd, x, x),
        data=rng.uniform(-1, 1, (B, T, S, S, 3)).astype(np.float32),
        gt=(rng.uniform(size=(B, T, S, S, 1)) > 0.85).astype(np.float32),
        flows=rng.uniform(-1, 1, (2 * B, T, S, S, 3)).astype(np.float32))


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory, request):
    """Started before the module's first test: the JAX steps and the
    command's runs below proceed while the ranks compute."""
    group = _Ranks(tmp_path_factory.mktemp("dp"), 2 * len(GROUPS))
    # the claim on the rank slots given back however the module ends
    request.addfinalizer(group.close)
    group.start(_cases(GROUPS[0]))
    yield group


@pytest.fixture(scope="module", autouse=True)
def _second_group(ranks, jax_gan):
    """The other families and the cases against JAX, whose inputs come
    from JAX's initialisers."""
    root = ranks.root
    for k in ("data", "gt", "flows"):
        np.save(root / f"{k}.npy", jax_gan[k])
    np.save(root / "video.npy", _flow_video())
    torch.save({"netG": {k: torch.from_numpy(np.array(v)) for k, v in
                         generator_state_dict(jax_gan["g_vars"]).items()},
                "netD": {k: torch.from_numpy(np.array(v)) for k, v in
                         dualdisc_state_dict(jax_gan["d_vars"]).items()}},
               root / "state.pt")
    ranks.start(_cases(GROUPS[1]) + _jax_cases(root))


# -- the command, its ranks and its refusals ----------------------------------

_CLI = ["--model", "clstm", "--batchsize", "4", "--nfr", "8", "--isize",
        "16", "--compute_dtype", "float32", "--synthetic_data", "2",
        "--synthetic_test_batches", "1", "--synthetic_thick_masks", "--ep",
        "1", "--freq", "2", "--device", "cpu", "--no-tensorboard"]


def _children() -> list[int]:
    """Live child processes of this process, but for the module's own
    ranks (``tools/dp_equivalence`` processes), which come and go as
    their groups run."""
    me, kids = os.getpid(), []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            if int(fields[1]) != me or fields[0] == "Z":
                continue
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                if eq.ENTRY.encode() in f.read():
                    continue
        except OSError:
            continue
        kids.append(int(pid))
    return kids


def test_trainer_dp2_runs_and_rank0_alone_writes(tmp_path, capfd):
    before = set(_children())
    assert trainer.main(_CLI + ["--dp", "2", "--result_root",
                                str(tmp_path)]) is None
    out = capfd.readouterr().out
    assert out.count("[Done]") == 2 and out.count("SAVE PATH") == 1
    runs = list((tmp_path / "clstm").rglob("args.txt"))
    assert len(runs) == 1                       # one run dir: rank 0's
    assert '"dp": 2' in runs[0].read_text()
    assert len(list((tmp_path / "clstm").rglob("*.pth"))) == 1
    assert len((runs[0].parent / "metrics.jsonl").read_text()
               .splitlines()) == 1
    assert set(_children()) <= before


def test_a_failing_rank_fails_the_command(tmp_path):
    before = set(_children())
    with pytest.raises(SystemExit, match=r"--dp 2: rank\(s\) \["):
        trainer.main(_CLI + ["--dp", "2", "--result_root", str(tmp_path),
                             "--resume", str(tmp_path / "no_such.pt")])
    assert set(_children()) <= before


def test_a_hung_rank_meets_the_join_timeout(tmp_path):
    """Ranks that outlive the join timeout (here 1 s: they are still
    starting) are killed and the launch raises, leaving no child."""
    before = set(_children())
    with pytest.raises(RuntimeError, match="join timeout"):
        trainer.launch_ranks(_CLI + ["--result_root", str(tmp_path)], 2,
                             "gloo", timeout=1.0)
    assert set(_children()) <= before


def test_sigterm_parks_every_rank_at_one_step(tmp_path):
    """SIGTERM to the command reaches both ranks, which agree on a stop
    step (an all-reduced MAX of the flag), park rank 0's ``latest.pt``
    there and exit 0: a rank that stopped alone would leave the other
    waiting in its next all-reduce."""
    import signal
    import subprocess
    import sys

    proc = subprocess.Popen(
        [sys.executable, "-m", "vfd_gan_tpu_torch.cli.trainer", *_CLI,
         "--dp", "2", "--synthetic_data", "400", "--freq", "1000",
         "--result_root", str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        started = 0
        for line in proc.stdout:
            started += "Training model clstm." in line
            if started == 2:
                break
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=JOIN_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out
    assert out.count("Interrupted by signal") == 2, out
    latest, = tmp_path.rglob("latest.pt")
    step = torch.load(latest, weights_only=False)["step"]
    assert 0 < step < 400


@pytest.mark.parametrize("extra", [
    ["--tp", "2"],
    # ported since: the engine is built and holds the option (the id is
    # the refusal case's); built in one process, it holds every expert
    # (the command starts an ep group, tests/test_torch_port_ep.py)
    ["--model", "xception", "--moe_experts", "2", "--moe_shards", "2"],
], ids=lambda v: "_".join(v))
def test_trainer_refuses_with_queue_1_item_13(tmp_path, extra):
    argv = _CLI + extra + ["--result_root", str(tmp_path)]
    if "--moe_shards" in extra:
        engine = trainer.build_engine(argv)
        try:
            assert engine.cfg.moe_shards == 2 and engine.shards is None
            assert engine.model.moe.experts_w1.shape[0] == 2
        finally:
            engine.close()
        return
    with pytest.raises(SystemExit, match="queue 1 item 13"):
        trainer.main(argv)


_SMALL = {"xception": ["--xwidth", "0.0625", "--isize", "32"],
          "mygan": ["--isize", "64", "--nfr", "16", "--ngf", "2", "--ndf",
                    "2"]}


@pytest.mark.parametrize("extra", [
    ["--model", "xception", "--moe_experts", "2", "--dp", "2"],
    ["--model", "mygan", "--isize", "64", "--nfr", "16", "--int8_disc",
     "--dp", "2"],
    ["--model", "mygan", "--isize", "64", "--nfr", "16", "--host_flow",
     "--dp", "2"],
    ["--model", "xception", "--pp", "2"],
], ids=lambda v: "_".join(v))
def test_trainer_runs_what_queue_1_item_13_held(tmp_path, capfd, extra):
    """The options that ``--dp`` refused until it had their global
    reductions, and ``--pp``, at a small width: the command starts its
    ranks (``--pp 2``: two stages), each trains to the end, rank 0 alone
    writes the run, and a ``--pp`` run's ``latest.pt`` is a plain
    Xception's train state (``infer._load``, ``strict=True``)."""
    if "--host_flow" in extra:
        pytest.importorskip("cv2")
    before = set(_children())
    model = extra[1]
    argv = _CLI + extra + _SMALL[model] + ["--result_root", str(tmp_path),
                                           "--autosave_every", "2"]
    assert trainer.main(argv) is None
    out = capfd.readouterr().out
    assert out.count("[Done]") == 2 and out.count("SAVE PATH") == 1, out
    runs = list((tmp_path / model).rglob("args.txt"))
    assert len(runs) == 1
    latest, = (tmp_path / model).rglob("latest.pt")
    assert torch.load(latest, weights_only=False)["step"] == 2
    if "--pp" in extra:
        from vfd_gan_tpu_torch.cli import infer

        net, name = infer._load(str(latest), torch.device("cpu"))
        assert type(net).__name__ == "Xception3D"
    assert set(_children()) <= before


@pytest.mark.parametrize("batch, requested, n", [
    (8, 0, 1), (8, 0, 4), (8, 3, 4), (6, 4, 8), (4, 2, 8), (5, 0, 8),
    (1, 4, 4)])
def test_auto_dp_is_jaxs(batch, requested, n):
    assert mesh.auto_dp(batch, requested, n) == jmesh.auto_dp(
        batch, requested, n_devices=n)


def test_dp0_on_the_cpu_is_one_process(capsys):
    cfg, _, _ = trainer.parse(_CLI + ["--dp", "0"])
    assert mesh.resolve_dp(cfg, "cpu") == 1
    cfg, _, _ = trainer.parse(_CLI + ["--dp", "3", "--accum", "2"])
    assert mesh.resolve_dp(cfg, "cpu") == 2        # divides the microbatch
    assert "--dp 3 -> dp 2" in capsys.readouterr().out


def test_rank_rows_take_each_microbatch_slice():
    """Rank r holds rows [r B/dp, (r+1) B/dp) of the batch, and under
    --accum k its slice of each microbatch (JAX ``accum_regroup``)."""
    rows = [mesh.DataParallel(r, 2, grouped=True).rows(8).tolist()
            for r in (0, 1)]
    assert rows == [[0, 1, 2, 3], [4, 5, 6, 7]]
    rows = [mesh.DataParallel(r, 2, grouped=True).rows(8, 2).tolist()
            for r in (0, 1)]
    assert rows == [[0, 1, 4, 5], [2, 3, 6, 7]]
    alone = mesh.DataParallel()
    x = torch.arange(8)
    assert alone.rows(8) is None and alone.take((x,))[0] is x
    with pytest.raises(ValueError, match="not 2 microbatches"):
        mesh.DataParallel(0, 2, grouped=True).rows(6, 2)


def test_verify_gate_is_jaxs():
    for name in ("K", "REL_FLOOR", "REL_CAP", "ABS_FLOOR", "ABS_CAP"):
        assert getattr(verify, name) == getattr(jverify, name), name
    for ym, yl in ((0.0, 0.0), (3e-5, 7e-5), (1.0, 1.0)):
        assert verify.calibrated_tols(ym, yl) == jverify.calibrated_tols(
            ym, yl)
    rep = ({"a": 1.0}, [np.zeros(3)])
    yard = ({"a": 1.0 + 1e-6}, [np.full(3, 1e-6)])
    verify.assert_replica_equivalence(rep, yard, ({"a": 1.0001},
                                                  [np.full(3, 5e-5)]))
    with pytest.raises(AssertionError):      # a semantic-scale miss
        verify.assert_replica_equivalence(rep, yard, ({"a": 1.05},
                                                      [np.zeros(3)]))
    with pytest.raises(AssertionError, match="leaf counts"):
        verify.assert_replica_equivalence(rep, yard, ({"a": 1.0}, []))


# -- float32: the MyGAN step against JAX's on a 2-device mesh ----------------

def _jax_step(jax_gan, devices: int):
    """JAX's ``_gan_core`` on a mesh of ``devices`` CPU devices: the batch
    sharded over ``dp``, the states replicated, the flows injected."""
    cfg = JaxConfig(model="mygan", isize=S, nfr=T, batchsize=B, ngf=NGF,
                    ndf=NDF, compute_dtype="float32").validate()
    jeng = object.__new__(JaxGanEngine)
    jeng.cfg = cfg
    jeng.netg, jeng.netd = jax_gan["netg"], jax_gan["netd"]
    jeng.tx_g = make_adam(cfg.lr, cfg.beta1)
    jeng.tx_d = make_adam(cfg.lr, cfg.beta1)
    flows = jnp.asarray(jax_gan["flows"])
    jeng._flow = lambda v, streams=1: flows
    m = Mesh(np.asarray(jax.devices()[:devices]), ("dp",))
    rows, rep = NamedSharding(m, PartitionSpec("dp")), NamedSharding(
        m, PartitionSpec())
    g = jax.device_put(JaxNetState.create(jax_gan["g_vars"], jeng.tx_g), rep)
    d = jax.device_put(JaxNetState.create(jax_gan["d_vars"], jeng.tx_d), rep)
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
    """Parameters and running statistics, by name (``num_batches_tracked``
    is an integer count, held on its own)."""
    return [np.asarray(sd[k], np.float32) for k in sorted(sd)
            if not k.endswith("num_batches_tracked")]


def test_mygan_dp2_step_passes_the_gate_against_jax_2_device(ranks,
                                                             jax_gan):
    replica = _jax_step(jax_gan, 2)
    yardstick = _jax_step(jax_gan, 1)
    got = ranks.result("gan_core")
    other = ranks.result("gan_core", 1)
    assert got["metrics"] == other["metrics"]
    assert all(torch.equal(v, other["params"][k])
               for k, v in got["params"].items())
    port = {**got["params"], **got["buffers"]}
    assert set(port) == set(replica[1])
    # G's statistics moved once, D's twice (real, then fake); the bridge
    # writes JAX's counts as 0
    assert int(port["netG.dconv1.bn.num_batches_tracked"]) == 1
    assert int(port["netD.spatdisc.dconv1.bn.num_batches_tracked"]) == 2
    rtol, atol = verify.assert_replica_equivalence(
        (replica[0], _leaves(replica[1])),
        (yardstick[0], _leaves(yardstick[1])),
        (got["metrics"], _leaves({k: v.numpy() for k, v in port.items()})),
        label="mygan dp2 port vs JAX")
    assert rtol <= verify.REL_CAP and atol <= verify.ABS_CAP


# -- the flow's synced stretch ------------------------------------------------

def _jax_stretch(video, streams: int):
    """JAX's per-(stream, time slab) min-max, as written in
    ``vfd_gan_tpu/ops/flow.py:414-420`` (the luma after it is XLA's fused
    multiply-add, one float32 ulp from the port's on 15% of the pixels)."""
    b, t, h, w, _ = video.shape
    grouped = video.reshape(streams, b // streams, t, h, w, 3)
    slabs = jnp.moveaxis(grouped, 2, 1)
    norm = jax.vmap(jax.vmap(jimage.minmax_normalize))(slabs)
    return jnp.moveaxis(norm, 1, 2).reshape(b, t, h, w, 3)


def _assembled(ranks, key: str) -> np.ndarray:
    """The two ranks' rows of both streams, back in the global order."""
    parts = [ranks.result("flow", r)[key].numpy().reshape(
        2, 1, *ranks.result("flow", r)[key].shape[1:]) for r in (0, 1)]
    both = np.concatenate(parts, axis=1)
    return both.reshape(4, *both.shape[2:])


def test_flow_stretch_at_dp2_equals_jax_bit_for_bit(ranks):
    video = _flow_video()
    m = Mesh(np.asarray(jax.devices()[:2]), ("dp",))
    # JAX's stream batch sharded over dp: each stream's clips split
    sharded = jax.device_put(video.reshape(2, 2, *video.shape[1:]),
                             NamedSharding(m, PartitionSpec(None, "dp")))
    want = np.asarray(jax.jit(lambda v: _jax_stretch(
        v.reshape(video.shape), 2))(sharded))
    got = _assembled(ranks, "norm")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, ranks.result("flow")["norm_alone"].numpy())


def test_flow_at_dp2_equals_dp1_and_tracks_jax(ranks):
    got = _assembled(ranks, "flow")
    np.testing.assert_array_equal(
        got, ranks.result("flow")["flow_alone"].numpy())
    want = np.asarray(jflow.video_to_flow_rgb(jnp.asarray(_flow_video()),
                                              streams=2))
    err = np.abs(got - want).ravel()
    # tests/test_torch_port_flow.py's bounds for the encoded video
    q50, q90, q99 = np.quantile(err, [0.5, 0.9, 0.99])
    assert q50 < 1e-3 and q90 < 0.02 and q99 < 0.1, (q50, q90, q99)


# -- float64: dp 2 == dp 1 ---------------------------------------------------

@pytest.mark.parametrize("family", list(FAMILIES))
def test_dp2_equals_dp1_in_float64(ranks, family):
    got = ranks.result(f"{family}.dp2")
    # the ranks hold one replica, bit for bit
    assert got["digest"] == ranks.result(f"{family}.dp2", 1)["digest"]
    for kind, (whole, _) in got["distances"].items():
        assert whole <= BOUND, (family, kind, got["distances"])


@pytest.mark.parametrize("family, stats", [
    (f, stats) for f, controls in CONTROLS.items() for stats in controls])
def test_local_batchnorm_statistics_miss(ranks, family, stats):
    """The controls: BatchNorm statistics left local to each rank, or
    summed in the forward alone, land at least 1000x farther from dp 1
    than the synced run (and 1000x past the bound): local ones in every
    kind, forward-only ones in the parameters and Adam's moments (their
    forward and so the losses and statistics are the synced run's)."""
    synced = ranks.result(f"{family}.dp2")["distances"]
    control = ranks.result(f"{family}.{stats}")["distances"]
    kinds = synced if stats == "local" else ("params", "exp_avg",
                                             "exp_avg_sq")
    for kind in kinds:
        assert control[kind][0] >= 1000 * max(synced[kind][0], BOUND), \
            (family, stats, kind, control[kind], synced[kind])


@pytest.mark.parametrize("family", SWEPT)
def test_dp2_sweep_scores_and_checkpoint_equal_dp1(ranks, family):
    got = ranks.result(f"{family}.dp2")
    want = ranks.reference(f"{family}.dp1")
    assert set(got["scores"]) == set(want["scores"])
    for k, v in want["scores"].items():
        np.testing.assert_allclose(got["scores"][k], v, rtol=1e-9, atol=0,
                                   err_msg=k)
    assert got["saved"] == want["saved"] and want["saved"]
    # rank 1 wrote nothing
    assert ranks.result(f"{family}.dp2", 1)["saved"] is None
    if family == "clstm-device_scoring":
        assert "score/eer" in want["scores"]
