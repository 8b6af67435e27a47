"""``--sp`` for c2plus1d and for MyGAN's ``--ae``, ``--remat`` and
``--host_flow``, on the CPU over gloo ranks: against the same steps in
one process, and against JAX's AutoEncoder and its c2plus1d step on a
``{"dp": 1, "sp": 2}`` mesh.

Three groups of ranks are started once for the module, side by side
(``ranks``), before the JAX compiles: an sp 2 row for c2plus1d (its 36M
float64 parameters take as long as all the MyGAN cases), an sp 2 row for
MyGAN and an sp 4 row for the AutoEncoder's eval forward alone.  The
ranks run ``vfd_gan_tpu_torch.tools.dp_equivalence`` (no rank imports
JAX or this file), each group meeting through a file under the test's
tmp dir and writing to a log file of its own.

* float64, sp 2 against sp 1 in one process (references in the grid's
  two-pass BatchNorm arithmetic, ``dp_equivalence.OneProcess``), within
  1e-9 (the relative L2 distance of each kind's whole set: parameters,
  BatchNorm buffers, Adam's two moments, the losses), the ranks of a row
  one replica bit for bit, the sweep's scores and saved ``.pth`` names
  sp 1's: c2plus1d at b2, nfr 16, 16^2 (2 steps; the residual dropout
  on) and with ``--accum 2`` at b4; MyGAN ``--ae`` at b1, nfr 16, 64^2
  (1 step; the flow stand-in of ``tests/test_torch_port_dp.py``);
  MyGAN with ``--remat`` (every block, and ``--remat_blocks
  dconv1,uconv1``) at b2, 64^2, ngf = ndf = 2, also within 1e-12 of the
  plain sp 2 run with every BatchNorm buffer (``num_batches_tracked``
  too) equal to its; MyGAN ``--host_flow`` at that size with the real
  cv2 flow (plus the stand-in's fixed field).
* the remat exchange count: under ``--sp 2 --remat`` each rematerialized
  block that runs on sharded frames exchanges its halo twice (the
  forward and the recompute in the backward, in the segment it ran in),
  the blocks on gathered frames none, on both ranks alike.
* the controls land at least 1000x farther than the sp 2 run and 1000x
  past the bound in every kind: c2plus1d's BatchNorm statistics over the
  rank's frames alone, the AutoEncoder's zero halos, its dropout drawing
  each shard's mask alone (``"dropout_sp"``: no ``frame_dim``), and the
  host flow's extrema over the whole grid.
* the AutoEncoder's eval forward (b1, nfr 16, 16^2, JAX's weights) at sp
  2 (``down_sep4`` gathers) and sp 4 (``down_sep3`` gathers) against the
  unsharded port AutoEncoder in float64 (1e-12) and JAX's in float32
  (1e-5, ``tests/test_torch_port_supervised.py``'s).
* the host flow of a b2 x 2-stream video at sp 2 equals sp 1's bit for
  bit (each shard's gray frames by its own slabs' extrema, the right
  halo of one gray frame, the last shard's repeat).
* float32: the port's c2plus1d sp 2 step passes ``parallel/verify.py``'s
  gate against JAX's step on a ``{"dp": 1, "sp": 2}`` mesh, with JAX's
  sp 1 step as the yardstick (augment draws given, dropout off).
* the trainer's ``--model c2plus1d --sp 2`` command (rank 0 alone
  writes).
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
from vfd_gan_tpu.ops import augment as jaug
from vfd_gan_tpu.train.state import NetState as JaxNetState
from vfd_gan_tpu.train.state import make_adam
from vfd_gan_tpu.train.supervised_engine import (
    SupervisedEngine as JaxSupervisedEngine,
)
from vfd_gan_tpu_torch.cli import trainer
from vfd_gan_tpu_torch.ops.augment import staging_size
from vfd_gan_tpu_torch.parallel import verify
from vfd_gan_tpu_torch.utils.weights import autoencoder_state_dict
from test_torch_port_sp import _children, _flow_video, _Ranks
from test_torch_port_threads import one_torch_thread  # noqa: F401

try:
    import cv2  # noqa: F401
    HAS_CV2 = True
except ImportError:
    HAS_CV2 = False

BOUND = 1e-9
# the --remat runs against the plain sp 2 run
REMAT_BOUND = 1e-12
_COMMON = ["--compute_dtype", "float32", "--synthetic_test_batches", "1",
           "--synthetic_thick_masks", "--ep", "1"]


def _c2plus1d(sp: int, *extra, batch: int = 2) -> list:
    return ["--model", "c2plus1d", "--batchsize", str(batch), "--nfr",
            "16", "--isize", "16", "--sp", str(sp), "--synthetic_data", "2",
            "--seed", "3", *extra, *_COMMON]


def _mygan(sp: int, *extra, batch: int = 2) -> list:
    return ["--model", "mygan", "--batchsize", str(batch), "--nfr", "16",
            "--isize", "64", "--ngf", "2", "--ndf", "2", "--sp", str(sp),
            "--synthetic_data", "2", "--seed", "3", *extra, *_COMMON]


# name: (command line at sp, case settings); each run at sp 2 against sp 1
C2_RUNS = {
    "c2plus1d": (_c2plus1d, {}),
    "c2plus1d-accum": (lambda sp: _c2plus1d(sp, "--accum", "2", batch=4),
                       {"sweep": False}),
}
MYGAN_RUNS = {
    # seed 2: its one test clip holds forged pixels (3: none, NaN scores)
    "mygan-ae": (lambda sp: _mygan(sp, "--ae", "--seed", "2", batch=1),
                 {"steps": 1, "flow": "standin"}),
    # the plain sp 2 run: the --remat runs' second reference
    "mygan": (_mygan, {"flow": "standin"}),
    **({"mygan-host_flow": (lambda sp: _mygan(sp, "--host_flow"),
                            {"flow": "own+field"})} if HAS_CV2 else {}),
}
REMAT = {"mygan-remat": ("--remat",),
         "mygan-remat_blocks": ("--remat", "--remat_blocks",
                                "dconv1,uconv1")}
# the blocks that run on sharded frames at nfr 16, sp 2 (dconv5 and
# uconv5 run on the gathered frames): each exchanges one halo a forward
SHARDED_BLOCKS = {"mygan-remat": 8, "mygan-remat_blocks": 2}
# control: (the run it is the sp 2 step of, the reduction left local)
CONTROLS = {"c2plus1d.bn_sp": ("c2plus1d", "bn_sp"),
            "c2plus1d.halo": ("c2plus1d", "halo"),
            "c2plus1d.dropout_sp": ("c2plus1d", "dropout_sp"),
            **({"mygan-host_flow.stretch_grid": ("mygan-host_flow",
                                                 "stretch_grid")}
               if HAS_CV2 else {})}
ALL_RUNS = {**C2_RUNS, **MYGAN_RUNS}
# the float32 step against JAX and the eval forwards: b2 (b1), T16, 16^2
B, T, S = 2, 16, 16


def _case(run: str, sp: int, **kw) -> dict:
    argv, settings = ALL_RUNS[run]
    return {**dict(kind="train", steps=2, float64=True, sweep=True,
                   name=f"{run}.sp{sp}", dp=1 if sp == 1 else 2,
                   argv=argv(sp)), **settings, **kw}


def _row_cases(runs: dict) -> list:
    refs = [_case(name, 1, arith="dp") for name in runs]
    sp2 = [_case(name, 2, ref=f"{name}.sp1", as_ref=name == "mygan")
           for name in runs]
    controls = [_case(run, 2, name=name, ref=f"{run}.sp1", sweep=False)
                | {"local_ops": [op]}
                for name, (run, op) in CONTROLS.items() if run in runs]
    return refs + sp2 + controls


def _remat_cases() -> list:
    return [dict(kind="train", steps=2, float64=True, sweep=True,
                 flow="standin", name=name, dp=2,
                 ref=["mygan.sp1", "mygan.sp2"], argv=_mygan(2, *extra))
            for name, extra in REMAT.items()]


# -- JAX's AutoEncoder and the float32 step's inputs ------------------------

def _jax_cfg():
    return JaxConfig(model="c2plus1d", batchsize=B, nfr=T, isize=S,
                     compute_dtype="float32", tensorboard=False).validate()


@pytest.fixture(scope="module")
def jax_ae():
    model = jax_build("c2plus1d", _jax_cfg(), jnp.float32)
    x = jnp.zeros((B, T, S, S, 3), jnp.float32)
    variables = jax.jit(lambda k: model.init(
        {"params": k, "dropout": k}, x, False))(jax.random.key(0))
    clip = np.random.default_rng(12).uniform(-1, 1, (1, T, S, S, 3)).astype(
        np.float32)
    return model, jax.tree_util.tree_map(np.asarray, variables), clip


def _step_batch() -> tuple[dict, dict]:
    s = staging_size(S)
    rng = np.random.default_rng(4)
    data = rng.integers(0, 256, (B, T, s, s, 3), dtype=np.uint8)
    mask = np.zeros((B, T, s, s, 1), np.uint8)
    mask[:, :, 3:s - 3, 4:s - 5] = 255
    batch = {"data": data, "real": data, "mask": mask}
    draws = {"angle": np.linspace(-0.17, 0.15, B).astype(np.float32),
             "flip": np.arange(B, dtype=np.int32) % 2,
             "crop": np.ones(B, np.int32), "pick": np.arange(B) % 2 == 0}
    return batch, draws


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory, jax_ae, request):
    """Started before the module's first test: the JAX functions run
    while the ranks compute."""
    group = _Ranks(tmp_path_factory.mktemp("sp_ae"), 8)
    # the claim on the rank slots given back however the module ends
    request.addfinalizer(group.close)
    root = group.root
    _, variables, clip = jax_ae
    torch.save({k: torch.from_numpy(np.array(v))
                for k, v in autoencoder_state_dict(variables).items()},
               root / "ae.pt")
    np.save(root / "clip.npy", clip)
    np.save(root / "video.npy", _flow_video())
    batch, draws = _step_batch()
    np.savez(root / "batch.npz", **batch)
    np.savez(root / "draws.npz", **draws)
    forward = dict(kind="sp_generator", name="ae_forward", model="ae",
                   state=str(root / "ae.pt"), x=str(root / "clip.npy"))
    group.start([forward], world=4)
    group.start([
        forward,
        dict(kind="step_core", name="c2plus1d.core",
             argv=["--model", "c2plus1d", "--batchsize", str(B), "--nfr",
                   str(T), "--isize", str(S), "--sp", "2",
                   "--synthetic_data", "1", *_COMMON],
             state=str(root / "ae.pt"), batch=str(root / "batch.npz"),
             draws=str(root / "draws.npz")),
        *_row_cases(C2_RUNS)], world=2)
    group.start([
        *([dict(kind="flow", name="host_flow", video=str(root / "video.npy"),
                streams=2, sp=2, host=True)] if HAS_CV2 else []),
        *_row_cases(MYGAN_RUNS), *_remat_cases()], world=2)
    yield group


# The tests that run JAX come first: the ranks compute meanwhile.

# -- float32: the c2plus1d sp 2 step against JAX's on a {"dp": 1, "sp": 2} --

def _mesh(sp: int) -> Mesh:
    return Mesh(np.asarray(jax.devices()[:sp]).reshape(1, sp), ("dp", "sp"))


def _jax_step(jax_ae, sp: int, monkeypatch):
    model, variables, _ = jax_ae
    cfg = _jax_cfg()
    batch, draws = _step_batch()
    monkeypatch.setattr(fnn.Dropout, "__call__", _identity_dropout)
    monkeypatch.setattr(jaug, "sample_clip_params", lambda *a, **k: tuple(
        jnp.asarray(draws[k]) for k in ("angle", "flip", "crop", "pick")))
    jeng = object.__new__(JaxSupervisedEngine)
    jeng.cfg, jeng.model, jeng.pipe = cfg, model, None
    jeng.tx = make_adam(cfg.lr, cfg.beta1)
    rep = NamedSharding(_mesh(sp), P())
    frames = NamedSharding(_mesh(sp), P("dp", "sp"))
    state = jax.device_put(JaxNetState.create(variables, jeng.tx), rep)
    state, loss, _ = jax.jit(jeng._train_step_impl, static_argnums=(3,))(
        state, {k: jax.device_put(jnp.asarray(v), frames)
                for k, v in batch.items()}, jax.random.key(0), True)
    sd = autoencoder_state_dict(jax.tree_util.tree_map(
        np.asarray, state.variables()))
    return {"loss/err/train": float(loss)}, sd


def _leaves(sd: dict) -> list:
    return [np.asarray(sd[k], np.float32) for k in sorted(sd)
            if not k.endswith("num_batches_tracked")]


def test_c2plus1d_sp2_step_passes_the_gate_against_jax_sp2_mesh(
        ranks, jax_ae, monkeypatch):
    """The port's float32 sp 2 step against JAX's on a ``{"dp": 1, "sp":
    2}`` mesh, the gate calibrated by JAX's own sp 1 step."""
    replica = _jax_step(jax_ae, 2, monkeypatch)
    yardstick = _jax_step(jax_ae, 1, monkeypatch)
    got, other = (ranks.result(1, "c2plus1d.core", r) for r in (0, 1))
    assert got["metrics"] == other["metrics"]
    assert all(torch.equal(v, other["state"][k])
               for k, v in got["state"].items())
    port = {k: v.numpy() for k, v in got["state"].items()}
    assert set(port) == set(replica[1])
    rtol, atol = verify.assert_replica_equivalence(
        (replica[0], _leaves(replica[1])),
        (yardstick[0], _leaves(yardstick[1])),
        (got["metrics"], _leaves(port)), label="c2plus1d sp2 port vs JAX")
    assert rtol <= verify.REL_CAP and atol <= verify.ABS_CAP


@pytest.mark.parametrize("sp", [2, 4])
def test_autoencoder_eval_forward_at_sp_matches_jax_and_unsharded(
        ranks, jax_ae, sp):
    """The rank's frames of the sharded eval forward, gathered in order,
    against the unsharded port AutoEncoder (float64, 1e-12) and JAX's
    (float32, 1e-5); sp 2 gathers at ``down_sep4``, sp 4 at
    ``down_sep3``."""
    model, variables, clip = jax_ae
    group = 1 if sp == 2 else 0
    parts = [ranks.result(group, "ae_forward", r) for r in range(sp)]
    for tag in ("", "64"):
        got = torch.cat([p[f"mask{tag}"] for p in parts], 2)
        alone = parts[0][f"alone{tag}"]
        assert got.shape == alone.shape == (1, 1, T, S, S)
        tol = 1e-12 if tag else 1e-5
        np.testing.assert_allclose(got.numpy(), alone.numpy(), rtol=0,
                                   atol=tol)
    want = jax.jit(lambda v, x: model.apply(v, x, False))(
        variables, jnp.asarray(clip))
    got = torch.cat([p["mask"] for p in parts], 2).permute(0, 2, 3, 4, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


# -- float64: sp 2 == sp 1 -------------------------------------------------

def _group(name: str) -> int:
    return 1 if name.split(".")[0] in C2_RUNS else 2


@pytest.mark.parametrize("name", [*ALL_RUNS, *REMAT])
def test_sp2_equals_sp1_in_float64(ranks, name):
    case = name if name in REMAT else f"{name}.sp2"
    got = ranks.result(_group(name), case)
    # the row's ranks hold one replica, bit for bit
    assert got["digest"] == ranks.result(_group(name), case, 1)["digest"]
    for kind, (whole, _) in got["distances"].items():
        assert whole <= BOUND, (name, kind, got["distances"])


@pytest.mark.parametrize("name", list(REMAT))
def test_sp2_remat_equals_plain_sp2(ranks, name):
    """The recompute re-enters the segment each block ran in: the
    rematerialized run is the plain sp 2 run's to 1e-12, its BatchNorm
    buffers (``num_batches_tracked`` too) equal."""
    got = ranks.result(2, name)["distances_to"]["mygan.sp2"]
    for kind, (whole, worst) in got.items():
        assert whole <= REMAT_BOUND and worst <= REMAT_BOUND, (kind, got)
    assert got["buffers"] == (0.0, 0.0), got


@pytest.mark.parametrize("name", list(REMAT))
def test_sp2_remat_exchanges_each_sharded_block_halo_twice(ranks, name):
    """A rematerialized block on sharded frames exchanges its halo in the
    forward and again in the recompute (the blocks on gathered frames
    none), the halos' gradients once, on both ranks alike."""
    plain = ranks.result(2, "mygan.sp2")["sp_counts"]
    mine = [ranks.result(2, name, r)["sp_counts"] for r in (0, 1)]
    assert mine[0] == mine[1]
    got = {k: v[0] for k, v in mine[0].items()}
    want = {k: v[0] for k, v in plain.items()}
    assert got["halo"] - want["halo"] == SHARDED_BLOCKS[name], (got, want)
    assert {k: v for k, v in got.items() if k != "halo"} == \
        {k: v for k, v in want.items() if k != "halo"}


@pytest.mark.parametrize("control", list(CONTROLS))
def test_sp_control_misses(ranks, control):
    """c2plus1d's BatchNorm statistics over the rank's frames alone, the
    AutoEncoder's zero halos, its dropout drawing each shard's mask
    alone, the host flow's extrema over the whole grid: each at least
    1000x farther from sp 1 than the sp 2 run, and 1000x past the bound,
    in every kind."""
    run = CONTROLS[control][0]
    synced = ranks.result(_group(run), f"{run}.sp2")["distances"]
    missed = ranks.result(_group(run), control)["distances"]
    for kind in synced:
        assert missed[kind][0] >= 1000 * max(synced[kind][0], BOUND), \
            (control, kind, missed[kind], synced[kind])


@pytest.mark.parametrize("name", [n for n in ALL_RUNS
                                  if ALL_RUNS[n][1].get("sweep", True)])
def test_sp2_sweep_scores_and_checkpoint_equal_sp1(ranks, name):
    got = ranks.result(_group(name), f"{name}.sp2")
    want = ranks.reference(_group(name), f"{name}.sp1")
    assert set(got["scores"]) == set(want["scores"])
    for k, v in want["scores"].items():
        assert np.isfinite(v), (k, want["scores"])
        np.testing.assert_allclose(got["scores"][k], v, rtol=1e-9, atol=0,
                                   err_msg=k)
    assert got["saved"] == want["saved"] and want["saved"]
    # rank 0 of the row alone wrote
    assert ranks.result(_group(name), f"{name}.sp2", 1)["saved"] is None


@pytest.mark.skipif(not HAS_CV2, reason="--host_flow needs cv2")
def test_host_flow_at_sp2_is_bit_equal_to_sp1(ranks):
    parts = [ranks.result(2, "host_flow", r)["flow"].numpy() for r in (0, 1)]
    both = np.concatenate(parts, axis=1)              # the frames, in order
    alone = ranks.result(2, "host_flow")["flow_alone"].numpy()
    np.testing.assert_array_equal(both, alone)
    assert np.ptp(alone[:2]) > 0.5 and np.ptp(alone[2:]) > 0.5


# -- the command -------------------------------------------------------------

def test_trainer_c2plus1d_sp2_runs_and_rank0_alone_writes(tmp_path, capfd):
    """The command starts the 2 ranks of an sp 2 row; each trains to the
    end, rank 0 alone writes the run (the sweep's masks gathered over
    the row before the opening)."""
    before = set(_children())
    argv = ["--model", "c2plus1d", "--nfr", "16", "--isize", "16",
            "--batchsize", "2", "--sp", "2", "--synthetic_data", "2",
            "--freq", "2", "--device", "cpu", "--no-tensorboard",
            "--result_root", str(tmp_path), *_COMMON]
    assert trainer.main(argv) is None
    out = capfd.readouterr().out
    assert out.count("[Done]") == 2 and out.count("SAVE PATH") == 1, out
    runs = list((tmp_path / "c2plus1d").rglob("args.txt"))
    assert len(runs) == 1 and '"sp": 2' in runs[0].read_text()
    assert len((runs[0].parent / "metrics.jsonl").read_text()
               .splitlines()) == 1
    assert list((tmp_path / "c2plus1d").rglob("*.pth"))
    assert set(_children()) <= before
