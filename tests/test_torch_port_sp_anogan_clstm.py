"""``--sp`` for AnoGAN and clstm, on the CPU over gloo ranks: against the
same steps in one process, against the unsharded nets, and against JAX's
nets and steps on a ``{"dp": 1, "sp": 2}`` mesh.

Three groups of ranks are started once for the module, side by side
(``ranks``), before the JAX compiles: an sp 2 row for AnoGAN, an sp 2 row
for clstm and a group of 4 (an sp 4 row for the forwards and a clstm
and an AnoGAN step, then a ``dp 2 x sp 2`` grid).  The ranks run
``vfd_gan_tpu_torch.tools.dp_equivalence`` (no rank imports JAX or this
file), each group meeting through a file under the test's tmp dir and
writing to a log file of its own; a collective that waits 90 s raises
in its rank, so a hang fails the group rather than the tier.

* float64, sp 2 against sp 1 in one process (references in the grid's
  two-pass BatchNorm arithmetic, ``dp_equivalence.OneProcess``), within
  1e-9 (the relative L2 distance of each kind's whole set: parameters,
  BatchNorm buffers with ``BatchNorm1d``'s, Adam's two moments, the
  losses), the ranks of a row one replica bit for bit, the sweep's
  scores and saved ``.pth`` names sp 1's: AnoGAN at b2, nfr 16, 16^2
  (2 steps and a one-batch sweep, dropout on), AnoGAN
  ``--ref_mode_quirks --freq 1`` (the latch holds at step 2), clstm at
  b2, nfr 16, 16^2 and clstm ``--accum 2`` at b4; one ``dp 2 x sp 2``
  step of each at b4; one step at sp 4 of clstm and of AnoGAN
  (dropout on: G's first stage runs replicated, then splits, and the
  middle shards both send and take the right halo's gradient).
* the hand-offs: each clstm step hands the recurrence's state on once a
  layer and link, forward and backward (3 and 3 a link: sp 2 and sp 4).
* the controls land at least 1000x farther than the sp 2 run and 1000x
  past the bound in every kind: AnoGAN's zero halos (both sides, and
  the transposed convs' right halo), its BatchNorm statistics over the
  shard, G's dropout drawing the rank's own mask; clstm starting every
  shard's recurrence from zeros (``"carry"``) and its BatchNorm over the
  shard.
* the eval forwards at sp 4 (JAX's weights): AnoGAN's G and D at nfr 16
  (G splits after ``layer2``'s first stage, D gathers at its third
  pool) and nfr 8, the ConvLSTM at nfr 16 and nfr 4 (one frame a
  shard), against the unsharded port nets in float64 (1e-12) and JAX's
  in float32 (``tests/test_torch_port_anogan.py``'s and
  ``tests/test_torch_port_supervised.py``'s 1e-5).
* float32: the port's AnoGAN and clstm sp 2 steps pass
  ``parallel/verify.py``'s gate against JAX's step on a ``{"dp": 1,
  "sp": 2}`` mesh, with JAX's sp 1 step as the yardstick (augment draws
  and z given, dropout off).
* the bf16 ConvLSTM head's weight gradient: the unrounded float32 sum.
* the trainer's ``--model anogan --sp 2`` and ``--model clstm --sp 2``
  commands (rank 0 alone writes).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tests.test_torch_port_supervised import _np_tree
from tests.test_torch_port_supervised_step import _identity_dropout
from vfd_gan_tpu.config import Config as JaxConfig
from vfd_gan_tpu.models import build_mask_model as jax_build
from vfd_gan_tpu.models.anogan import AnoDiscriminator as JaxD
from vfd_gan_tpu.models.anogan import AnoGenerator as JaxG
from vfd_gan_tpu.ops import augment as jaug
from vfd_gan_tpu.train import anogan_engine as janogan
from vfd_gan_tpu.train.state import NetState as JaxNetState
from vfd_gan_tpu.train.state import make_adam
from vfd_gan_tpu.train.supervised_engine import (
    SupervisedEngine as JaxSupervisedEngine,
)
from vfd_gan_tpu_torch.cli import trainer
from vfd_gan_tpu_torch.models.convlstm import _Float32WeightGrad
from vfd_gan_tpu_torch.models.layers import make_conv3d
from vfd_gan_tpu_torch.ops.augment import staging_size
from vfd_gan_tpu_torch.parallel import verify
from vfd_gan_tpu_torch.utils.weights import (
    anogan_discriminator_state_dict,
    anogan_generator_state_dict,
    convlstm_state_dict,
)
from test_torch_port_sp import _children, _Ranks
from test_torch_port_threads import one_torch_thread  # noqa: F401

BOUND = 1e-9
FORWARD_BOUND = 1e-12
# the float32 forwards against JAX's
ATOL = 1e-5
_COMMON = ["--compute_dtype", "float32", "--synthetic_test_batches", "1",
           "--synthetic_thick_masks", "--ep", "1", "--synthetic_data", "2",
           "--seed", "3"]
# the float32 steps against JAX and the forwards: b2, T16, 16^2
B, T, S = 2, 16, 16
# the groups: the 4 ranks, the AnoGAN row, the clstm row
QUAD, ANO, CLSTM = 0, 1, 2


def _argv(model: str, sp: int, *extra, batch: int = 2) -> list:
    return ["--model", model, "--batchsize", str(batch), "--nfr", str(T),
            "--isize", str(S), "--sp", str(sp), *extra, *_COMMON]


# name: (model, extra flags, batch, case settings); each run at sp 2
# against sp 1
RUNS = {
    "anogan": ("anogan", (), 2, {}),
    "anogan-quirks": ("anogan", ("--ref_mode_quirks", "--freq", "1"), 2,
                      {}),
    "clstm": ("clstm", (), 2, {}),
    "clstm-accum": ("clstm", ("--accum", "2"), 4, {"sweep": False}),
}
# control: (the run it is the sp 2 step of, the exchange left local)
CONTROLS = {"anogan.halo": ("anogan", "halo"),
            "anogan.bn_sp": ("anogan", "bn_sp"),
            "anogan.dropout_sp": ("anogan", "dropout_sp"),
            "clstm.carry": ("clstm", "carry"),
            "clstm.bn_sp": ("clstm", "bn_sp")}
# the runs of the group of 4: name -> (model, sp, batch, steps)
QUAD_RUNS = {"anogan-dp2xsp2": ("anogan", 2, 4, 1),
             "clstm-dp2xsp2": ("clstm", 2, 4, 1),
             "clstm-sp4": ("clstm", 4, 2, 1),
             # G's first stage replicated (its dropout too), then split;
             # the middle shards send and take the right halo's gradient
             "anogan-sp4": ("anogan", 4, 2, 1)}


def _group(name: str) -> int:
    return ANO if name.startswith("anogan") else CLSTM


def _case(run: str, sp: int, **kw) -> dict:
    model, extra, batch, settings = RUNS[run]
    return {**dict(kind="train", steps=2, float64=True, sweep=True,
                   name=f"{run}.sp{sp}", dp=1 if sp == 1 else 2,
                   argv=_argv(model, sp, *extra, batch=batch)),
            **settings, **kw}


def _row_cases(model: str) -> list:
    runs = [r for r in RUNS if RUNS[r][0] == model]
    refs = [_case(name, 1, arith="dp") for name in runs]
    sp2 = [_case(name, 2, ref=f"{name}.sp1") for name in runs]
    controls = [_case(run, 2, name=name, ref=f"{run}.sp1", sweep=False)
                | {"local_ops": [op]}
                for name, (run, op) in CONTROLS.items()
                if RUNS[run][0] == model]
    return refs + sp2 + controls


def _quad_cases() -> list:
    out = []
    for name, (model, sp, batch, steps) in QUAD_RUNS.items():
        base = dict(kind="train", steps=steps, float64=True, sweep=False)
        out.append(dict(base, name=f"{name}.ref", dp=1, arith="dp",
                        argv=_argv(model, 1, batch=batch)))
        out.append(dict(base, name=name, dp=2, ref=f"{name}.ref",
                        argv=_argv(model, sp, batch=batch)))
    # the references (one a rank) before the grid's runs
    return out[::2] + out[1::2]


# -- JAX's nets and the float32 steps' inputs -------------------------------

def _init(module, *inputs, dropout: bool = False):
    keys = (lambda k: {"params": k, "dropout": k}) if dropout \
        else (lambda k: k)
    return _np_tree(jax.jit(lambda k: module.init(keys(k), *inputs, False))(
        jax.random.key(0)))


@pytest.fixture(scope="module")
def jax_nets():
    """JAX's AnoGAN G (dropout 0) and D at nfr 16 and 8, and the ConvLSTM,
    with their variables (numpy); the forwards' clips and z."""
    rng = np.random.default_rng(12)
    out = {"z": rng.standard_normal((B, 100)).astype(np.float32)}
    for t in (16, 8):
        g, d = JaxG(nfr=t, isize=S, drop_rate=0.0), JaxD()
        out[f"anogan{t}"] = (
            g, _init(g, jnp.zeros((B, 100)), dropout=True), d,
            _init(d, jnp.zeros((B, t, S, S, 3))))
    for t in (16, 8, 4):
        out[f"clip{t}"] = rng.uniform(-1, 1, (B, t, S, S, 3)).astype(
            np.float32)
    cfg = JaxConfig(model="clstm", batchsize=B, nfr=T, isize=S,
                    compute_dtype="float32", tensorboard=False).validate()
    model = jax_build("clstm", cfg, jnp.float32)
    out["clstm"] = (cfg, model, _init(model, jnp.zeros((B, T, S, S, 3))))
    return out


def _anogan_state(jax_nets, t: int) -> dict:
    _, g_vars, _, d_vars = jax_nets[f"anogan{t}"]
    return {"netG": anogan_generator_state_dict(g_vars, t, S),
            "netD": anogan_discriminator_state_dict(d_vars, t)}


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


def _save_state(path, state: dict) -> None:
    def tensors(sd):
        return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    torch.save({k: tensors(v) for k, v in state.items()}
               if "netG" in state else tensors(state), path)


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory, jax_nets, request):
    """Started before the module's first test: the JAX functions run
    while the ranks compute."""
    group = _Ranks(tmp_path_factory.mktemp("sp_anogan_clstm"), 8)
    # the claim on the rank slots given back however the module ends
    request.addfinalizer(group.close)
    root = group.root
    for t in (16, 8):
        _save_state(root / f"anogan{t}.pt", _anogan_state(jax_nets, t))
    _save_state(root / "clstm.pt", convlstm_state_dict(jax_nets["clstm"][2]))
    for t in (16, 8, 4):
        np.save(root / f"clip{t}.npy", jax_nets[f"clip{t}"])
    np.save(root / "z.npy", jax_nets["z"])
    batch, draws = _step_batch()
    np.savez(root / "batch.npz", **batch)
    np.savez(root / "draws.npz", **draws)
    forwards = [dict(kind="sp_nets", name=f"anogan{t}.forward",
                     model="anogan", state=str(root / f"anogan{t}.pt"),
                     x=str(root / f"clip{t}.npy"), z=str(root / "z.npy"))
                for t in (16, 8)]
    forwards += [dict(kind="sp_nets", name=f"clstm{t}.forward",
                      model="clstm", state=str(root / "clstm.pt"),
                      x=str(root / f"clip{t}.npy")) for t in (16, 4)]
    group.start([*forwards, *_quad_cases()], world=4)
    cores = {model: dict(kind="step_core", name=f"{model}.core",
                         argv=_argv(model, 2),
                         state=str(root / f"{state}.pt"),
                         batch=str(root / "batch.npz"),
                         draws=str(root / "draws.npz"))
             for model, state in (("anogan", "anogan16"),
                                  ("clstm", "clstm"))}
    cores["anogan"]["z"] = str(root / "z.npy")
    group.start([cores["anogan"], *_row_cases("anogan")], world=2)
    group.start([cores["clstm"], *_row_cases("clstm")], world=2)
    yield group


# The tests that run JAX come first: the ranks compute meanwhile.

# -- float32: the sp 2 steps against JAX's on a {"dp": 1, "sp": 2} mesh -----

def _mesh(sp: int) -> Mesh:
    return Mesh(np.asarray(jax.devices()[:sp]).reshape(1, sp), ("dp", "sp"))


class _GivenZ:
    """``jax`` as the JAX AnoGAN engine sees it, but for ``random.normal``,
    which gives ``z``."""

    def __init__(self, z):
        given = jnp.asarray(z)
        self.random = type("random", (), {
            "__getattr__": lambda _, k: getattr(jax.random, k),
            "normal": staticmethod(lambda *a, **k: given)})()

    def __getattr__(self, name):
        return getattr(jax, name)


def _jax_step(jax_nets, model: str, sp: int, monkeypatch):
    """One JAX train step of ``model`` on a ``{"dp": 1, "sp": sp}`` mesh
    from the module's weights, the augment draws (and AnoGAN's z) given,
    dropout off: its metrics and the torch state dict(s) after it."""
    batch, draws = _step_batch()
    monkeypatch.setattr(jaug, "sample_clip_params", lambda *a, **k: tuple(
        jnp.asarray(draws[k]) for k in ("angle", "flip", "crop", "pick")))
    rep = NamedSharding(_mesh(sp), P())
    frames = NamedSharding(_mesh(sp), P("dp", "sp"))
    batch = {k: jax.device_put(jnp.asarray(v), frames)
             for k, v in batch.items()}
    if model == "clstm":
        cfg, net, variables = jax_nets["clstm"]
        monkeypatch.setattr(fnn.Dropout, "__call__", _identity_dropout)
        jeng = object.__new__(JaxSupervisedEngine)
        jeng.cfg, jeng.model, jeng.pipe = cfg, net, None
        jeng.tx = make_adam(cfg.lr, cfg.beta1)
        state = jax.device_put(JaxNetState.create(variables, jeng.tx), rep)
        state, loss, _ = jax.jit(jeng._train_step_impl,
                                 static_argnums=(3,))(
            state, batch, jax.random.key(0), True)
        return {"loss/err/train": float(loss)}, convlstm_state_dict(
            _np_tree(state.variables()))
    g, g_vars, d, d_vars = jax_nets["anogan16"]
    monkeypatch.setattr(janogan, "jax", _GivenZ(jax_nets["z"]))
    cfg = JaxConfig(model="anogan", batchsize=B, nfr=T, isize=S,
                    compute_dtype="float32", tensorboard=False).validate()
    jeng = object.__new__(janogan.AnoGanEngine)
    jeng.cfg, jeng.netg, jeng.netd = cfg, g, d
    jeng.tx_g = make_adam(5 * cfg.lr, 0.5)
    jeng.tx_d = make_adam(cfg.lr, 0.5)
    g_state, d_state, metrics, _ = jax.jit(
        jeng._train_step_impl, static_argnums=(4,))(
        jax.device_put(JaxNetState.create(g_vars, jeng.tx_g), rep),
        jax.device_put(JaxNetState.create(d_vars, jeng.tx_d), rep),
        batch, jax.random.key(0), True)
    sd = {**{f"netG.{k}": v for k, v in anogan_generator_state_dict(
              _np_tree(g_state.variables()), T, S).items()},
          **{f"netD.{k}": v for k, v in anogan_discriminator_state_dict(
              _np_tree(d_state.variables()), T).items()}}
    return {k: float(v) for k, v in metrics.items()}, sd


def _leaves(sd: dict) -> list:
    return [np.asarray(sd[k], np.float32) for k in sorted(sd)
            if not k.endswith("num_batches_tracked")]


@pytest.mark.parametrize("model", ["anogan", "clstm"])
def test_sp2_step_passes_the_gate_against_jax_sp2_mesh(ranks, jax_nets,
                                                       model, monkeypatch):
    """The port's float32 sp 2 step against JAX's on a ``{"dp": 1, "sp":
    2}`` mesh, the gate calibrated by JAX's own sp 1 step."""
    replica = _jax_step(jax_nets, model, 2, monkeypatch)
    yardstick = _jax_step(jax_nets, model, 1, monkeypatch)
    group = _group(model)
    got, other = (ranks.result(group, f"{model}.core", r) for r in (0, 1))
    assert got["metrics"] == other["metrics"]
    assert all(torch.equal(v, other["state"][k])
               for k, v in got["state"].items())
    port = {k: v.numpy() for k, v in got["state"].items()}
    assert set(port) == set(replica[1])
    rtol, atol = verify.assert_replica_equivalence(
        (replica[0], _leaves(replica[1])),
        (yardstick[0], _leaves(yardstick[1])),
        (got["metrics"], _leaves(port)), label=f"{model} sp2 port vs JAX")
    assert rtol <= verify.REL_CAP and atol <= verify.ABS_CAP


# -- the eval forwards at sp 4 ------------------------------------------------

# the sp 4 forwards: name -> (model, nfr)
FORWARDS = {"anogan16": ("anogan", 16), "anogan8": ("anogan", 8),
            "clstm16": ("clstm", 16), "clstm4": ("clstm", 4)}


@pytest.mark.parametrize("name", list(FORWARDS))
def test_sp4_eval_forward_matches_the_unsharded_nets_and_jax(
        ranks, jax_nets, name):
    """Each rank's frames of G's video and of the ConvLSTM's mask, gathered
    in order, and D's scores and features on every rank, against the
    unsharded port nets (float64, 1e-12) and JAX's (float32, 1e-5)."""
    model, t = FORWARDS[name]
    parts = [ranks.result(QUAD, f"{name}.forward", r) for r in range(4)]
    framed = ("fake",) if model == "anogan" else ("mask",)
    for tag, tol in (("", ATOL), ("64", FORWARD_BOUND)):
        for k in framed:
            got = torch.cat([p[f"{k}{tag}"] for p in parts], 2)
            alone = parts[0][f"alone_{k}{tag}"]
            assert got.shape == alone.shape and got.shape[2] == t
            np.testing.assert_allclose(got.numpy(), alone.numpy(), rtol=0,
                                       atol=tol, err_msg=k + tag)
        if model == "anogan":
            for k in ("score", "features"):
                for p in parts:
                    np.testing.assert_allclose(
                        p[f"{k}{tag}"].numpy(),
                        parts[0][f"alone_{k}{tag}"].numpy(), rtol=0,
                        atol=tol, err_msg=k + tag)
    clip = jnp.asarray(jax_nets[f"clip{t}"])
    if model == "clstm":
        _, net, variables = jax_nets["clstm"]
        want = jax.jit(lambda v, x: net.apply(v, x, False))(variables, clip)
        got = torch.cat([p["mask"] for p in parts], 2).permute(0, 2, 3, 4, 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)
        return
    g, g_vars, d, d_vars = jax_nets[f"anogan{t}"]
    want_g = jax.jit(lambda v, z: g.apply(v, z, False))(
        g_vars, jnp.asarray(jax_nets["z"]))
    want_s, want_f = jax.jit(lambda v, x: d.apply(v, x, False))(d_vars, clip)
    got = torch.cat([p["fake"] for p in parts], 2).permute(0, 2, 3, 4, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_g), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(parts[1]["score"].numpy(), np.asarray(want_s),
                               rtol=0, atol=ATOL)
    # D's features: JAX flattens channel-last, the port NCDHW
    want_f = np.asarray(want_f).reshape(B, t // 8, S // 8, S // 8, 256)
    np.testing.assert_allclose(
        parts[2]["features"].numpy(),
        want_f.transpose(0, 4, 1, 2, 3).reshape(B, -1), rtol=0, atol=ATOL)


def test_sp4_forwards_exchange_as_designed(ranks):
    """Per forward (float32 and float64: two each): AnoGAN at nfr 16 runs
    G replicated through its first stage (4 frames) and then sharded (6
    halos: 3 stages of a transposed conv and a conv) and D's 6 convs
    sharded, gathering once (its third pool); at nfr 8 G shards after its
    second stage (4 halos) and D gathers at its second pool (the 5 convs
    before it take halos); the ConvLSTM hands its state on 3 times a link
    and takes one halo for its head."""
    want = {"anogan16": {"halo": 24, "gather": 2},
            "anogan8": {"halo": 18, "gather": 2}}
    for name, counts in want.items():
        for r in range(4):
            assert ranks.result(QUAD, f"{name}.forward", r)["counts"] == \
                counts, name
    for name in ("clstm16", "clstm4"):
        for r in range(4):
            links = 1 if r in (0, 3) else 2
            assert ranks.result(QUAD, f"{name}.forward", r)["counts"] == \
                {"carry": 2 * 3 * links, "halo": 2}, (name, r)


# -- float64: sp 2 == sp 1 -------------------------------------------------

@pytest.mark.parametrize("name", list(RUNS))
def test_sp2_equals_sp1_in_float64(ranks, name):
    got = ranks.result(_group(name), f"{name}.sp2")
    # the row's ranks hold one replica, bit for bit
    assert got["digest"] == ranks.result(_group(name), f"{name}.sp2",
                                         1)["digest"]
    for kind, (whole, _) in got["distances"].items():
        assert whole <= BOUND, (name, kind, got["distances"])


@pytest.mark.parametrize("name", list(QUAD_RUNS))
def test_grid_step_equals_sp1_in_float64(ranks, name):
    """One step of a ``dp 2 x sp 2`` grid (b4) and of an sp 4 row: the
    hand-off groups and the BatchNorm1d statistics (the dp peers of a
    shard) pinned to their row and shard."""
    digests = {ranks.result(QUAD, name, r)["digest"] for r in range(4)}
    assert len(digests) == 1
    for kind, (whole, _) in ranks.result(QUAD, name)["distances"].items():
        assert whole <= BOUND, (name, kind)


@pytest.mark.parametrize("name", ["clstm", "clstm-accum", "clstm-sp4"])
def test_clstm_hands_its_state_on_once_a_layer_and_link(ranks, name):
    """Per step and link: 3 forward hand-offs and 3 backward ones (one a
    layer; ``--accum 2``: one a layer and microbatch), on every rank:
    a hand-off missing from the graph would hang, not miss."""
    sp = 4 if name.endswith("sp4") else 2
    micro = 2 if name.endswith("accum") else 1
    for r in range(sp):
        if sp == 4:
            counts = ranks.result(QUAD, name, r)["sp_counts"]
        else:
            counts = ranks.result(CLSTM, f"{name}.sp2", r)["sp_counts"]
        links = 1 if r in (0, sp - 1) else 2
        assert counts["carry"][0] == counts["carry_grad"][0] \
            == 3 * micro * links, (name, r, counts)


@pytest.mark.parametrize("control", list(CONTROLS))
def test_sp_control_misses(ranks, control):
    """Each control at least 1000x farther from sp 1 than the sp 2 run,
    and 1000x past the bound, in every kind."""
    run = CONTROLS[control][0]
    synced = ranks.result(_group(run), f"{run}.sp2")["distances"]
    missed = ranks.result(_group(run), control)["distances"]
    for kind in synced:
        assert missed[kind][0] >= 1000 * max(synced[kind][0], BOUND), \
            (control, kind, missed[kind], synced[kind])


@pytest.mark.parametrize("name", [n for n in RUNS
                                  if RUNS[n][3].get("sweep", True)])
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


# -- the commands -------------------------------------------------------------

@pytest.mark.parametrize("pad", [(1, 1, 1), (0, 1, 1)])
def test_bf16_head_weight_gradient_is_an_unrounded_float32_sum(pad):
    """The bf16 ConvLSTM head (SAME, and valid over T as on a halo'd
    shard) on a channel-last view, as the net hands it: output and input
    gradient ``Conv3d``'s own bit for bit, the weight's gradient the
    float32 sum of the widened operands (``head_weight_grad``), where
    ``Conv3d``'s is rounded to bfloat16."""
    gen = torch.Generator().manual_seed(5)
    conv = make_conv3d(12, 1, (3, 3, 3), (1, 1, 1), bias=False,
                       generator=gen)
    x = torch.randn((2, 6, 8, 8, 12), generator=gen).to(
        torch.bfloat16).permute(0, 4, 1, 2, 3)
    plain = conv if pad[0] else conv.valid_t
    xa = x.detach().requires_grad_()
    want = plain(xa)
    dy = torch.randn(want.shape, generator=gen).to(torch.bfloat16)
    want.backward(dy)
    xb = x.detach().requires_grad_()
    w = conv.weight.detach().clone().requires_grad_()
    got = _Float32WeightGrad.apply(xb, w, pad)
    got.backward(dy)
    assert torch.equal(got, want) and torch.equal(xb.grad, xa.grad)
    exact = torch.nn.grad.conv3d_weight(x.double(), w.shape, dy.double(),
                                        padding=pad)
    assert w.grad.dtype == torch.float32
    assert (w.grad.double() - exact).abs().max() <= 1e-6 * exact.abs().max()
    assert torch.equal(conv.weight.grad,
                       conv.weight.grad.to(torch.bfloat16).float())
    assert not torch.equal(w.grad, w.grad.to(torch.bfloat16).float())


@pytest.mark.parametrize("model,size", [("anogan", ["--nfr", "8", "--isize",
                                                    "8"]),
                                        ("clstm", ["--nfr", "8", "--isize",
                                                   "8"])])
def test_trainer_sp2_runs_and_rank0_alone_writes(tmp_path, capfd, model,
                                                 size):
    """The command starts the 2 ranks of an sp 2 row; each trains to the
    end, rank 0 alone writes the run."""
    before = set(_children())
    argv = ["--model", model, *size, "--batchsize", "2", "--sp", "2",
            "--freq", "2", "--device", "cpu", "--no-tensorboard",
            "--result_root", str(tmp_path), *_COMMON]
    assert trainer.main(argv) is None
    out = capfd.readouterr().out
    assert out.count("[Done]") == 2 and out.count("SAVE PATH") == 1, out
    runs = list((tmp_path / model).rglob("args.txt"))
    assert len(runs) == 1 and '"sp": 2' in runs[0].read_text()
    assert len((runs[0].parent / "metrics.jsonl").read_text()
               .splitlines()) == 1
    assert list((tmp_path / model).rglob("*.pth"))
    assert set(_children()) <= before
