"""``--sp`` on the CPU: sequence (frame-axis) parallel MyGAN training over
gloo ranks, against the same steps in one process and against JAX's
``parallel/temporal.py``, ``parallel/sp_generator.py`` and its step on a
``{"dp": 1, "sp": 2}`` mesh.

Two groups of ranks are started once for the module, side by side
(``ranks``): one of 2 ranks (an sp 2 row) and one of 4 (an sp 4 row, then
a ``dp 2 x sp 2`` grid).  The ranks run
``vfd_gan_tpu_torch.tools.dp_equivalence`` (no rank imports JAX or this
file), each group meeting through a file under the test's tmp dir and
writing to a log file of its own, with a join timeout of 400 s (the
groups take ~35 s alone and several times that in the tier).

* ``parallel/temporal.py`` at sp 2 and sp 4 (each rank its frames of one
  float32 clip): ``halo_exchange``, ``upsample2x_t_sp``,
  ``avg_pool2x_t_sp`` and ``temporal_conv_sp`` against JAX's on an sp
  mesh of as many virtual devices and against the unsharded op (in
  float64), each to 1e-6; in float64, each op's input gradient (through the halo's
  backward) against autograd of the unsharded op, to 1e-12.
* ``generator_forward_sp`` at sp 2, nfr 32, 32^2, ngf 2 (JAX's weights
  through ``generator_state_dict``) against JAX's on an sp 2 mesh, to
  1e-5, and against the port's own unsharded eval Generator.
* float64, 2 MyGAN steps and the sweep at b2, 64^2, ngf 2, ndf 2 (the
  flow stand-in of ``tests/test_torch_port_dp.py``): sp 2 at nfr 32
  (every level local), sp 2 at nfr 16 (``dconv4``'s 1-frame shards
  gathered, the bottleneck replicated), dp 2 x sp 2 at nfr 16 (b4) and
  ``--device_scoring`` at sp 2, each against the same steps at sp 1 in
  one process, within 1e-9 (the relative L2 distance of each kind's whole
  set: parameters, BatchNorm buffers, Adam's two moments, the losses).
  The references compute the BatchNorms in the grid's two-pass form
  (``dp_equivalence.OneProcess``): against torch's own BatchNorm the
  conv biases right before a BatchNorm, whose true gradient is 0, take
  Adam steps of round-off (lr times a noise gradient over Adam's eps),
  and that alone puts nfr 32's parameters at 1.4e-9 (nfr 16's at 3.4e-10)
  while every other tensor agrees to 1e-12; against the two-pass form
  the whole set is 4.5e-13.  The ranks of a grid hold one replica, bit
  for bit, and the sweep's scores and saved ``.pth`` names are sp 1's.
* the controls, at nfr 32, land 1000x farther (and 1000x past the bound)
  in every kind: zero halos (each shard padded as if alone), BatchNorm
  statistics over the rank's frames alone, and the flow stretch's MAX
  over the whole grid (which mixes frames).
* the real flow of a b4 x 2-stream video at sp 2 equals sp 1's bit for
  bit (its plain path: the right halo of one gray frame, the last
  shard's duplicate).
* one float32 MyGAN ``_gan_core`` step at sp 2 (nfr 16, flows injected,
  dropout off) passes ``parallel/verify.py``'s gate against JAX's step on
  a ``{"dp": 1, "sp": 2}`` mesh, calibrated by JAX's own sp 1 step;
  ``g/err_g_adv_s``, where JAX's float32 is the one off, is held to the
  port's float64 sp 2 step within the gate's rtol.
* the trainer's ``--dp 2 --sp 2`` command (rank 0 alone writes); ``--sp``
  with ``--tp`` and with ``--moe_shards``, refused once and since
  ported (an engine built in one process holds both options); the
  refusal on ``cuda`` past the visible cards.  Xception, GANomaly
  and MyGAN's ``--accum``, ``--int8_disc``, ``--cache_gt_flow`` and
  ``--ref_mode_quirks`` under ``--sp``:
  ``tests/test_torch_port_sp_families.py``; c2plus1d and MyGAN's
  ``--ae``, ``--remat`` and ``--host_flow``:
  ``tests/test_torch_port_sp_ae.py``; AnoGAN and clstm:
  ``tests/test_torch_port_sp_anogan_clstm.py``.
"""

import os
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vfd_gan_tpu.config import Config as JaxConfig
from vfd_gan_tpu.models.mygan import DualDisc as JaxDualDisc
from vfd_gan_tpu.models.mygan import Generator as JaxGenerator
from vfd_gan_tpu.parallel import sp_generator as jsp_generator
from vfd_gan_tpu.parallel import temporal as jtemporal
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
JOIN_S = 400.0
_COMMON = ["--compute_dtype", "float32", "--synthetic_data", "2",
           "--synthetic_test_batches", "1", "--synthetic_thick_masks",
           "--ep", "1", "--seed", "3"]


def _mygan(nfr: int, sp: int, batch: int = 2, *extra) -> list:
    return ["--model", "mygan", "--batchsize", str(batch), "--nfr",
            str(nfr), "--isize", "64", "--ngf", "2", "--ndf", "2", "--sp",
            str(sp), *extra, *_COMMON]


# name: (nfr, batch, extra flags, ranks)
RUNS = {"n32": (32, 2, (), 2), "n16": (16, 2, (), 2),
        "dp2xsp2": (16, 4, (), 4),
        "device_scoring": (16, 2, ("--device_scoring",), 2)}
CONTROLS = ("halo", "bn_sp", "stretch_grid")
# the temporal ops' clip (B, T, H, W, C) and kernel (kt, Cin, Cout)
X_SHAPE, K_SHAPE = (2, 16, 3, 3, 2), (3, 2, 3)
# the MyGAN step against JAX: b2 (both clips on each rank), T16, 64^2
B, T, S, NGF, NDF = 2, 16, 64, 4, 4


def _train_cases(world: int) -> list:
    cases, tail = [], []
    for name, (nfr, batch, extra, w) in RUNS.items():
        if w != world:
            continue
        base = dict(kind="train", steps=2, float64=True, sweep=True,
                    flow="standin")
        cases.append(dict(base, name=f"{name}.sp1", dp=1, arith="dp",
                          argv=_mygan(nfr, 1, batch, *extra)))
        tail.append(dict(base, name=f"{name}.sp2", dp=2, ref=f"{name}.sp1",
                         argv=_mygan(nfr, 2, batch, *extra)))
        if name == "n32":
            tail += [dict(base, name=f"n32.{c}", dp=2, ref="n32.sp1",
                          argv=_mygan(32, 2), local_ops=[c], sweep=False)
                     for c in CONTROLS]
    return cases + tail


class _Ranks:
    """The module's groups of ranks, each running in the background;
    ``start`` returns once a group's ranks are spawned, and they write to
    a log file of their own.  The module's ``ranks`` (every group's, in
    all) are claimed from the session's ``rank_slots.Slots`` before its
    first group starts, so that the groups compute beside a bounded number
    of other ranks, and are given back when its last group has ended
    (or at ``close``)."""

    def __init__(self, root, ranks: int):
        self.root = root
        self.errors = []
        self.threads = []
        self.slots = Slots(root, ranks)

    def start(self, cases, world: int) -> None:
        self.slots.acquire()
        spawned = threading.Event()
        index = len(self.threads)
        thread = threading.Thread(target=self._run,
                                  args=(cases, index, world, spawned),
                                  daemon=True)
        thread.start()
        self.threads.append(thread)
        spawned.wait(JOIN_S)

    def _run(self, cases, index, world, spawned):
        try:
            eq.run(cases, self.root / f"group{index}", world=world,
                   backend="gloo", timeout=JOIN_S,
                   log=self.root / f"group{index}.log",
                   on_spawn=lambda pids: spawned.set())
        except Exception as e:          # reported by every result()
            self.errors.append(e)
        finally:
            spawned.set()
            self.slots.ended(world)

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

    def result(self, group: int, name: str, rank: int = 0) -> dict:
        self.join()
        return torch.load(self.root / f"group{group}" / f"{name}.rank{rank}.pt",
                          weights_only=False)

    def reference(self, group: int, name: str) -> dict:
        self.join()
        return torch.load(self.root / f"group{group}" / f"{name}.ref.pt",
                          weights_only=False)


def _jax_init(module, *inputs):
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: module.init(k, *inputs, False))(jax.random.key(0)))


def _temporal_inputs() -> dict:
    rng = np.random.default_rng(6)
    x = rng.normal(size=X_SHAPE).astype(np.float32)
    b, t = X_SHAPE[:2]
    out = {"x": x, "k": (rng.normal(size=K_SHAPE) * 0.3).astype(np.float32)}
    for sp in (2, 4):
        # the float64 weights of each op's global output
        shapes = {"halo": (b, t + 2 * sp, *X_SHAPE[2:]),
                  "upsample": (b, 2 * t, *X_SHAPE[2:]),
                  "pool": (b, t // 2, *X_SHAPE[2:]),
                  "conv": (b, t, *X_SHAPE[2:4], K_SHAPE[2])}
        for name, shape in shapes.items():
            out[f"sp{sp}_w_{name}"] = rng.normal(size=shape)
    return out


def _flow_video() -> np.ndarray:
    """gt-like moving squares and a soft prediction stream as RGB in [-1,
    1], 2 clips per stream, gt stream first, 16 frames of 32^2."""
    r = np.random.default_rng(22)
    gt = np.zeros((2, 16, 32, 32), np.float32)
    for i in range(2):
        y, x = r.integers(2, 8, 2)
        for f in range(16):
            gt[i, f, y + f // 2:y + f // 2 + 10, x + f // 3:x + f // 3 + 11] \
                = 1.0
    pred = gt * 0.55 + 0.2 + r.uniform(0, 0.05, gt.shape).astype(np.float32)
    both = np.concatenate([gt, pred])[..., None].repeat(3, axis=-1)
    return (both * 2.0 - 1.0).astype(np.float32)


@pytest.fixture(scope="module")
def jax_gan():
    """MyGAN's G and D (JAX init) and one step's inputs; the sp
    Generator's (ngf 2) variables and clip."""
    x = jnp.zeros((B, T, S, S, 3), jnp.float32)
    netg = JaxGenerator(ngf=NGF, dtype=jnp.float32, drop_rate=0.0)
    netd = JaxDualDisc(ndf=NDF, dtype=jnp.float32)
    small = JaxGenerator(ngf=2, dtype=jnp.float32)
    clip = np.random.default_rng(9).uniform(
        -1, 1, (1, 32, 32, 32, 3)).astype(np.float32)
    rng = np.random.default_rng(5)
    return dict(
        netg=netg, netd=netd, g_vars=_jax_init(netg, x),
        d_vars=_jax_init(netd, x, x), small=small,
        small_vars=_jax_init(small, jnp.asarray(clip)), clip=clip,
        data=rng.uniform(-1, 1, (B, T, S, S, 3)).astype(np.float32),
        gt=(rng.uniform(size=(B, T, S, S, 1)) > 0.85).astype(np.float32),
        flows=rng.uniform(-1, 1, (2 * B, T, S, S, 3)).astype(np.float32))


def _state_file(path: Path, bridge, variables) -> str:
    torch.save({k: torch.from_numpy(np.array(v))
                for k, v in bridge(variables).items()}, path)
    return str(path)


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory, jax_gan, request):
    """Started before the module's first test: the JAX functions and the
    commands below run while the ranks compute."""
    group = _Ranks(tmp_path_factory.mktemp("sp"), 6)
    # the claim on the rank slots given back however the module ends
    request.addfinalizer(group.close)
    root = group.root
    inputs = _temporal_inputs()
    for sp in (2, 4):
        np.savez(root / f"temporal{sp}.npz", x=inputs["x"], k=inputs["k"],
                 **{k[4:]: v for k, v in inputs.items()
                    if k.startswith(f"sp{sp}_")})
    for k in ("data", "gt", "flows", "clip"):
        np.save(root / f"{k}.npy", jax_gan[k])
    np.save(root / "video.npy", _flow_video())
    torch.save({"netG": torch.load(_state_file(
                    root / "g.pt", generator_state_dict, jax_gan["g_vars"])),
                "netD": torch.load(_state_file(
                    root / "d.pt", dualdisc_state_dict, jax_gan["d_vars"]))},
               root / "state.pt")
    _state_file(root / "small.pt", generator_state_dict,
                jax_gan["small_vars"])
    group.start([dict(kind="temporal", name="temporal",
                      inputs=str(root / "temporal4.npz")),
                 *_train_cases(4)], world=4)
    group.start([
        dict(kind="temporal", name="temporal",
             inputs=str(root / "temporal2.npz")),
        dict(kind="sp_generator", name="sp_generator", ngf=2,
             state=str(root / "small.pt"), x=str(root / "clip.npy")),
        *(dict(kind="gan_core", name=name, float64=wide,
               argv=["--model", "mygan", "--batchsize", str(B), "--nfr",
                     str(T), "--isize", str(S), "--ngf", str(NGF), "--ndf",
                     str(NDF), "--sp", "2", *_COMMON],
               **{k: str(root / f"{k}.npy")
                  for k in ("data", "gt", "flows")},
               state=str(root / "state.pt"))
          for name, wide in (("gan_core", False), ("gan_core64", True))),
        dict(kind="flow", name="flow", video=str(root / "video.npy"),
             streams=2, sp=2),
        *_train_cases(2)], world=2)
    yield group


# The tests that run JAX come first: the ranks compute meanwhile.

# -- float32: the MyGAN step against JAX's on a {"dp": 1, "sp": 2} mesh -----

def _jax_step(jax_gan, sp: int, dp: int = 1):
    """JAX's ``_gan_core`` on a ``(dp, sp)`` mesh of CPU devices: the
    batch sharded ``P("dp", "sp")``, the states replicated, the flows
    injected."""
    cfg = JaxConfig(model="mygan", isize=S, nfr=T, batchsize=B, ngf=NGF,
                    ndf=NDF, compute_dtype="float32").validate()
    jeng = object.__new__(JaxGanEngine)
    jeng.cfg = cfg
    jeng.netg, jeng.netd = jax_gan["netg"], jax_gan["netd"]
    jeng.tx_g = make_adam(cfg.lr, cfg.beta1)
    jeng.tx_d = make_adam(cfg.lr, cfg.beta1)
    flows = jnp.asarray(jax_gan["flows"])
    jeng._flow = lambda v, streams=1: flows
    m = Mesh(np.asarray(jax.devices()[:dp * sp]).reshape(dp, sp),
             ("dp", "sp"))
    frames, rep = NamedSharding(m, P("dp", "sp")), NamedSharding(m, P())
    g = jax.device_put(JaxNetState.create(jax_gan["g_vars"], jeng.tx_g), rep)
    d = jax.device_put(JaxNetState.create(jax_gan["d_vars"], jeng.tx_d), rep)
    g_state, d_state, metrics, _ = jax.jit(jeng._gan_core)(
        g, d, jax.device_put(jax_gan["data"], frames),
        jax.device_put(jax_gan["gt"], frames), jax.random.key(0))

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


# the spatial features' feature matching: telemetry, in no gradient
FEATURE_MATCH = "g/err_g_adv_s/train"


def test_mygan_sp2_step_passes_the_gate_against_jax_sp2_mesh(ranks,
                                                             jax_gan):
    """The yardstick is JAX's own sp 1 step.  One telemetry metric is held
    apart, to the port's float64 sp 2 step within the gate's rtol, since
    JAX's float32 is the one off there: ``g/err_g_adv_s`` (in no
    gradient) is 0.1712388 at JAX sp 1 and sp 2, 0.1712972 at JAX dp 2,
    0.1712967 in the port's float32 step at sp 1 and sp 2 and 0.1712957
    in its float64 step (measured on these inputs)."""
    replica = _jax_step(jax_gan, 2)
    yardstick = _jax_step(jax_gan, 1)
    got = ranks.result(1, "gan_core")
    other = ranks.result(1, "gan_core", 1)
    assert got["metrics"] == other["metrics"]
    assert all(torch.equal(v, other["params"][k])
               for k, v in got["params"].items())
    port = {**got["params"], **got["buffers"]}
    assert set(port) == set(replica[1])
    assert int(port["netG.dconv1.bn.num_batches_tracked"]) == 1
    assert int(port["netD.tempdisc.dconv1.bn.num_batches_tracked"]) == 2

    def gated(metrics):
        assert FEATURE_MATCH in metrics
        return {k: v for k, v in metrics.items() if k != FEATURE_MATCH}

    rtol, atol = verify.assert_replica_equivalence(
        (gated(replica[0]), _leaves(replica[1])),
        (gated(yardstick[0]), _leaves(yardstick[1])),
        (gated(got["metrics"]),
         _leaves({k: v.numpy() for k, v in port.items()})),
        label="mygan sp2 port vs JAX")
    assert rtol <= verify.REL_CAP and atol <= verify.ABS_CAP
    wide = ranks.result(1, "gan_core64")["metrics"][FEATURE_MATCH]
    np.testing.assert_allclose(got["metrics"][FEATURE_MATCH], wide,
                               rtol=rtol, atol=0)


# -- generator_forward_sp ------------------------------------------------

def test_generator_forward_sp_matches_jax_and_the_unsharded_generator(
        ranks, jax_gan):
    got = np.concatenate([ranks.result(1, "sp_generator", r)["mask"].numpy()
                          for r in (0, 1)], axis=2)      # (B, 1, T, H, W)
    got = np.moveaxis(got, 1, -1)
    mesh2 = jtemporal.make_sp_mesh(2)
    want = np.asarray(jax.jit(
        lambda v, x: jsp_generator.generator_forward_sp(v, x, mesh2))(
            jax_gan["small_vars"], jnp.asarray(jax_gan["clip"])))
    assert got.shape == want.shape == (1, 32, 32, 32, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    alone = np.moveaxis(ranks.result(1, "sp_generator")["alone"].numpy(),
                        1, -1)
    np.testing.assert_allclose(got, alone, rtol=0, atol=1e-5)
    # in float64 the sharded forward is the unsharded one to round-off
    got64 = torch.cat([ranks.result(1, "sp_generator", r)["mask64"]
                       for r in (0, 1)], 2)
    want64 = ranks.result(1, "sp_generator")["alone64"]
    assert float((got64 - want64).abs().max()) <= 1e-12


# -- parallel/temporal.py against JAX's and the unsharded ops --------------

def _ncdhw(x):
    return x.permute(0, 4, 1, 2, 3)


def _unsharded(name: str, x: torch.Tensor, k: np.ndarray, sp: int):
    """The op ``name`` on the whole channel-last clip ``x`` (torch; for a
    halo exchange the shards' padded blocks, each with its neighbours'
    frames, side by side)."""
    t = x.shape[1]
    if name == "halo":
        padded = F.pad(x, (0, 0, 0, 0, 0, 0, 1, 1))
        n = t // sp
        return torch.cat([padded[:, i * n:i * n + n + 2]
                          for i in range(sp)], 1)
    if name == "upsample":
        y = F.interpolate(_ncdhw(x), size=(2 * t, *x.shape[2:4]),
                          mode="trilinear", align_corners=True)
        return y.permute(0, 2, 3, 4, 1)
    if name == "pool":
        return x.reshape(x.shape[0], t // 2, 2, *x.shape[2:]).mean(2)
    weight = torch.from_numpy(k).to(x.dtype).permute(2, 1, 0)[..., None,
                                                               None]
    return F.conv3d(_ncdhw(x), weight, padding=(1, 0, 0)).permute(
        0, 2, 3, 4, 1)


def _jax_op(name: str, x, k, sp: int):
    m = jtemporal.make_sp_mesh(sp)
    if name == "halo":
        return shard_map(lambda b: jtemporal.halo_exchange(b, 1), mesh=m,
                         in_specs=P(None, "sp"), out_specs=P(None, "sp"))(x)
    if name == "upsample":
        return jtemporal.upsample2x_t_sp(x, m)
    if name == "pool":
        return jtemporal.avg_pool2x_t_sp(x, m)
    return jtemporal.temporal_conv_sp(x, jnp.asarray(k), m)


OPS = ("halo", "upsample", "pool", "conv")


def _group_of(sp: int) -> int:
    return 0 if sp == 4 else 1


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("name", OPS)
def test_temporal_op_matches_jax_and_the_unsharded_op(ranks, name, sp):
    inputs = np.load(ranks.root / f"temporal{sp}.npz")
    x, k = inputs["x"], inputs["k"]
    got = np.concatenate([ranks.result(_group_of(sp), "temporal", r)[name]
                          .numpy() for r in range(sp)], axis=1)
    want = np.asarray(_jax_op(name, jnp.asarray(x), k, sp))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the unsharded op in float64; the upsample at JAX's tolerance for its
    # own sharded upsample against the unsharded one
    # (tests/test_temporal_parallel.py): JAX's float32 grid rounds
    # i (T-1) / (2T-1) before it takes the fraction, 1.6e-6 from the exact
    # interpolation here, and the port computes JAX's grid
    whole = _unsharded(name, torch.from_numpy(x).double(), k, sp).numpy()
    np.testing.assert_allclose(got, whole, rtol=0,
                               atol=1e-5 if name == "upsample" else 1e-6)


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("name", OPS)
def test_temporal_op_gradient_is_autograds_in_float64(ranks, name, sp):
    """The shards' input gradients of ``sum(op(x) * w)`` (the halo's
    backward hands each halo's gradient back to its neighbour) against
    autograd of the unsharded op, in float64."""
    inputs = np.load(ranks.root / f"temporal{sp}.npz")
    x = torch.from_numpy(inputs["x"]).double().requires_grad_(True)
    (_unsharded(name, x, inputs["k"], sp)
     * torch.from_numpy(inputs[f"w_{name}"])).sum().backward()
    got = torch.cat([ranks.result(_group_of(sp), "temporal", r)
                     [f"{name}_grad"] for r in range(sp)], 1)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), x.grad.numpy(), rtol=0,
                               atol=1e-12)


def test_temporal_ops_exchange_halos_by_neighbours(ranks):
    """Four ops, three of them with a halo of one (the pool takes none):
    as many exchanges forward and backward on every rank."""
    for r in range(2):
        counts = ranks.result(1, "temporal", r)["counts"]
        assert counts == {"halo": 6, "halo_grad": 3}, counts


# -- float64: sp 2 == sp 1 ---------------------------------------------------

def _group_of_run(name: str) -> int:
    return _group_of(RUNS[name][3])


@pytest.mark.parametrize("name", list(RUNS))
def test_sp2_equals_sp1_in_float64(ranks, name):
    group, world = _group_of_run(name), RUNS[name][3]
    got = ranks.result(group, f"{name}.sp2")
    # the grid's ranks hold one replica, bit for bit
    for r in range(1, world):
        assert got["digest"] == ranks.result(group, f"{name}.sp2",
                                             r)["digest"]
    for kind, (whole, _) in got["distances"].items():
        assert whole <= BOUND, (name, kind, got["distances"])


@pytest.mark.parametrize("control", CONTROLS)
def test_sp_control_misses(ranks, control):
    """Zero halos, BatchNorm statistics over the rank's frames alone, the
    stretch's MAX over the whole grid: each lands at least 1000x farther
    from sp 1 than the sp 2 run, and 1000x past the bound, in every
    kind."""
    synced = ranks.result(1, "n32.sp2")["distances"]
    missed = ranks.result(1, f"n32.{control}")["distances"]
    for kind in synced:
        assert missed[kind][0] >= 1000 * max(synced[kind][0], BOUND), \
            (control, kind, missed[kind], synced[kind])


@pytest.mark.parametrize("name", list(RUNS))
def test_sp2_sweep_scores_and_checkpoint_equal_sp1(ranks, name):
    group, world = _group_of_run(name), RUNS[name][3]
    got = ranks.result(group, f"{name}.sp2")
    want = ranks.reference(group, f"{name}.sp1")
    assert set(got["scores"]) == set(want["scores"])
    for k, v in want["scores"].items():
        np.testing.assert_allclose(got["scores"][k], v, rtol=1e-9, atol=0,
                                   err_msg=k)
    assert got["saved"] == want["saved"] and want["saved"]
    # rank 0 of the grid alone wrote
    for r in range(1, world):
        assert ranks.result(group, f"{name}.sp2", r)["saved"] is None
    if name == "device_scoring":
        assert "score/eer" in want["scores"]


def test_real_flow_at_sp2_is_bit_equal_to_sp1(ranks):
    parts = [ranks.result(1, "flow", r)["flow"].numpy() for r in (0, 1)]
    both = np.concatenate(parts, axis=1)              # the frames, in order
    alone = ranks.result(1, "flow")["flow_alone"].numpy()
    np.testing.assert_array_equal(both, alone)
    assert np.ptp(alone[:2]) > 0.5 and np.ptp(alone[2:]) > 0.5


# -- the command and its refusals --------------------------------------------

def _children() -> list[int]:
    """Live child processes of this process, but for the module's own
    ranks (``tools/dp_equivalence`` processes)."""
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


_CLI = ["--synthetic_test_batches", "1", "--synthetic_thick_masks",
        "--compute_dtype", "float32", "--synthetic_data", "2", "--ep", "1",
        "--freq", "2", "--device", "cpu", "--no-tensorboard"]


def test_trainer_dp2_sp2_runs_and_rank0_alone_writes(tmp_path, capfd):
    """The command starts the 4 ranks of a dp 2 x sp 2 grid; each trains
    to the end, rank 0 alone writes the run (an sp 2 row alone is the
    float64 cases' grid)."""
    before = set(_children())
    argv = ["--model", "mygan", "--nfr", "16", "--isize", "64", "--ngf",
            "2", "--ndf", "2", *_CLI, "--dp", "2", "--sp", "2",
            "--batchsize", "4", "--result_root", str(tmp_path)]
    assert trainer.main(argv) is None
    out = capfd.readouterr().out
    assert out.count("[Done]") == 4 and out.count("SAVE PATH") == 1, out
    runs = list((tmp_path / "mygan").rglob("args.txt"))
    assert len(runs) == 1
    assert '"sp": 2' in runs[0].read_text()
    assert len((runs[0].parent / "metrics.jsonl").read_text()
               .splitlines()) == 1
    assert list((tmp_path / "mygan").rglob("*_netG.pth"))
    assert set(_children()) <= before


@pytest.mark.parametrize("extra", [
    ["--tp", "2"], ["--model", "xception", "--moe_experts", "2",
                    "--moe_shards", "2", "--xwidth", "0.0625"]],
    ids=["tp", "moe_shards"])
def test_sp_with_tp_or_moe_shards_is_refused_with_item_13(tmp_path, extra):
    argv = ["--model", "mygan", "--nfr", "16", "--isize", "64", "--sp", "2",
            *_CLI, *extra, "--result_root", str(tmp_path)]
    # both ported since: the engine is built and holds the options (the
    # ids are the refusal cases'); built in one process, it holds every
    # expert and every channel (the command starts sp x ep or sp x tp
    # ranks, tests/test_torch_port_ep.py, tests/test_torch_port_tp.py)
    engine = trainer.build_engine(argv)
    try:
        if "--moe_shards" in extra:
            assert (engine.cfg.sp, engine.cfg.moe_shards) == (2, 2)
            assert engine.model.moe.experts_w1.shape[0] == 2
        else:
            assert (engine.cfg.sp, engine.cfg.tp) == (2, 2)
            assert engine.shards is None
            assert engine.netg.dconv1.conv.temporal_conv.weight.shape[0] \
                == 32
    finally:
        engine.close()


def test_sp_on_cuda_must_fit_the_visible_cards():
    cfg, _, _ = trainer.parse(["--model", "mygan", "--nfr", "16", "--sp",
                               str(max(1, torch.cuda.device_count()) + 1),
                               "--synthetic_data", "2"])
    with pytest.raises(SystemExit, match="frame shards need"):
        mesh.resolve_dp(cfg, "cuda")


def test_sp_grid_places_rows_and_frames():
    """Rank d sp + k of a (dp, sp) grid holds rows d and frames k (JAX's
    ``P("dp", "sp")``), and a draw for its slice is that slice of the
    global tensor's."""
    grid = [(d, k) for d in range(2) for k in range(2)]
    gen = torch.Generator().manual_seed(0)
    full = torch.rand((4, 3, 8, 2, 2), generator=gen)
    for d, k in grid:
        dp = mesh.DataParallel(d, 2, grouped=True)
        dp.sp = mesh.SeqParallel(k, 2, None, [d * 2, d * 2 + 1])
        assert dp.rows(4).tolist() == [2 * d, 2 * d + 1]
        assert dp.sp.frame_slice(8) == slice(4 * k, 4 * k + 4)
        assert dp.size == 4
        mine = dp.rand((2, 3, 4, 2, 2), torch.Generator().manual_seed(0),
                       "cpu", frame_dim=2)
        assert torch.equal(mine, full[2 * d:2 * d + 2, :, 4 * k:4 * k + 4])


def test_a_broadcast_that_writes_its_root_back_leaves_saved_tensors_alone(
        monkeypatch):
    """gloo's broadcast of a CUDA tensor writes the root's tensor back (a
    version bump); a 1-frame shard's halo is its whole block, a ReLU
    output autograd saved, so what a rank sends must be a copy (caught on
    the card).  Here a stand-in broadcast bumps every tensor it gets."""
    from vfd_gan_tpu_torch.parallel import temporal

    monkeypatch.setattr(temporal.dist, "broadcast",
                        lambda t, src, group=None: t.add_(0))
    monkeypatch.setattr(temporal.dist, "all_reduce",
                        lambda t, group=None: t.add_(0))
    for index in (0, 1):
        sp = mesh.SeqParallel(index, 2, None, [0, 1])
        x = torch.randn(2, 3, 1, 4, 4, requires_grad=True)
        y = torch.relu(x)
        out = temporal.halo_exchange(y, 1, sp, 2)
        (out * out).sum().backward()            # ReLU's saved output intact
        z = torch.relu(x)
        temporal.gather_frames(z, sp, 2).square().sum().backward()
        assert x.grad is not None
