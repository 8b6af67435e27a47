"""The port's supervised models and entry point against the JAX package
on the CPU.

The weight bridges of the three mask predictors (ConvLSTM, the "c2plus1d"
AutoEncoder, Xception-3D) against ``torch_export``, each model's eval
forward from bridged weights, the channel-last max pool, the run-dir
comment and the trainer entry point for each family.  The train step of
each family is ``tests/test_torch_port_supervised_step.py``'s.

Sizes: ConvLSTM at 16x16 (T 4 for the forward, T 8 in the engine, which
needs multiples of 8), the AutoEncoder at 16x16, T 16 (b1 for the
forward; b2 for a step, since a train-mode BatchNorm of its 1x1x1
bottleneck needs more than one value per channel), Xception at ``xwidth``
1/16 and 32x32.

Tolerance of the eval forwards: 1e-5 absolute (float32 convolutions
summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfd_gan_tpu.config import Config as JaxConfig
from vfd_gan_tpu.models import build_mask_model as jax_build
from vfd_gan_tpu.obs.summary import run_comment as jax_run_comment
from vfd_gan_tpu.ops import convs as jconvs
from vfd_gan_tpu.utils import torch_export
from vfd_gan_tpu_torch.cli import trainer
from vfd_gan_tpu_torch.config import Config
from vfd_gan_tpu_torch.models import build_mask_model
from vfd_gan_tpu_torch.ops import convs
from vfd_gan_tpu_torch.ops.image import to_channel_first, to_channel_last
from vfd_gan_tpu_torch.train.engine_base import run_comment
from vfd_gan_tpu_torch.train.supervised_engine import SupervisedEngine
from vfd_gan_tpu_torch.utils.checkpoint import load_state_dict
from vfd_gan_tpu_torch.utils.weights import (
    autoencoder_state_dict,
    convlstm_state_dict,
    xception_state_dict,
)
from test_torch_port_threads import one_torch_thread  # noqa: F401

ATOL = 1e-5
LR = Config().lr

BRIDGES = {"clstm": (convlstm_state_dict, torch_export.convlstm_to_torch),
           "c2plus1d": (autoencoder_state_dict,
                        torch_export.stcnn_autoencoder_to_torch),
           "xception": (xception_state_dict, torch_export.xception_to_torch)}
# family -> (batch, nfr, isize, extra Config fields): the engine sizes
SIZES = {"clstm": (2, 8, 16, {}), "c2plus1d": (2, 16, 16, {}),
         "xception": (2, 8, 32, {"xwidth": 1 / 16})}
# the eval-forward sizes: (batch, nfr)
FORWARD = {"clstm": (2, 4), "c2plus1d": (1, 16), "xception": (2, 4)}


def _cfgs(family, tmp_path=None):
    b, t, s, extra = SIZES[family]
    kw = dict(model=family, batchsize=b, nfr=t, isize=s, ep=1,
              compute_dtype="float32", tensorboard=False,
              result_root=str(tmp_path or "results"), **extra)
    return JaxConfig(**kw).validate(), Config(**kw).validate()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_model_and_vars(family, b=None, t=None):
    jcfg, _ = _cfgs(family)
    bb, nfr, s, _ = SIZES[family]
    model = jax_build(family, jcfg, jnp.float32)
    x = jnp.zeros((b or bb, t or nfr, s, s, 3), jnp.float32)
    variables = jax.jit(lambda k: model.init(
        {"params": k, "dropout": k}, x, False))(jax.random.key(0))
    return model, _np_tree(variables)


def _port_model(family, sd):
    _, cfg = _cfgs(family)
    model = build_mask_model(family, cfg)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in sd.items()}, strict=True)
    return model


@pytest.fixture(scope="module", params=list(BRIDGES))
def family_vars(request):
    family = request.param
    model, variables = _jax_model_and_vars(family, *FORWARD[family])
    return family, model, variables


def test_bridge_equals_torch_export_and_loads_strict(family_vars):
    family, _, variables = family_vars
    mine, theirs = BRIDGES[family]
    got, want = mine(variables), theirs(variables)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=k)
    _port_model(family, got)


def test_eval_forward_matches_jax(family_vars):
    family, model, variables = family_vars
    b, t = FORWARD[family]
    s = SIZES[family][2]
    x = np.random.default_rng(1).uniform(-1, 1, (b, t, s, s, 3)).astype(
        np.float32)
    want = jax.jit(lambda v, x: model.apply(v, x, False))(
        variables, jnp.asarray(x))
    port = _port_model(family, BRIDGES[family][0](variables)).eval()
    with torch.no_grad():
        got = to_channel_last(port(to_channel_first(torch.from_numpy(x))))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_max_pool3d_matches_jax_with_gradients():
    x = np.random.default_rng(2).normal(size=(2, 3, 9, 10, 4)).astype(
        np.float32)
    dy = np.random.default_rng(3).normal(size=(2, 3, 5, 5, 4)).astype(
        np.float32)
    args = ((1, 3, 3), (1, 2, 2), (0, 1, 1))
    want, vjp = jax.vjp(lambda a: jconvs.max_pool3d(a, *args),
                        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = convs.max_pool3d(xt, *args)
    got.backward(torch.from_numpy(dy))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    # normal draws: no ties in a window, so the gradients agree too
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(vjp(
        jnp.asarray(dy))[0]))


def test_run_comment_matches_jax_for_both_engines():
    cfg = Config(batchsize=8, nfr=16, isize=128, lr=2e-4, w_adv=1.0,
                 w_con=10.0)
    for gan in (True, False):
        assert run_comment(cfg, gan) == jax_run_comment(cfg, gan=gan)
    assert run_comment(cfg, False) == "b8xd16xwh128_lr0.0002"
    assert run_comment(cfg, True) == "b8xd16xwh128_lr-0.0002_w-a1.0c10.0"


# -- the entry point ------------------------------------------------------------

_ARGS = ["--batchsize", "2", "--isize", "16", "--compute_dtype", "float32",
         "--synthetic_data", "2", "--synthetic_test_batches", "1", "--ep",
         "1", "--freq", "2", "--synthetic_thick_masks", "--device", "cpu"]


@pytest.mark.parametrize("family, extra", [
    ("clstm", ["--nfr", "8"]),
    ("c2plus1d", ["--nfr", "16"]),
    ("xception", ["--nfr", "8", "--xwidth", "0.0625"]),
])
def test_trainer_runs_each_family_and_writes_loadable_pth(tmp_path, capsys,
                                                          family, extra):
    engine = trainer.main(["--model", family, *_ARGS, *extra,
                           "--result_root", str(tmp_path)])
    out = capsys.readouterr().out
    assert "test sweep at step 2" in out and "[Done]" in out
    assert isinstance(engine, SupervisedEngine)
    assert engine.global_step == 2
    assert np.isfinite(engine.errors["loss/err/train"])
    assert np.isfinite(engine.errors["loss/err/test"])
    roc = engine.scores["score/roc"]
    pth, = (tmp_path / family).rglob("*.pth")
    assert pth.name == f"roc-{roc:.4f}_step0002.pth"
    assert pth.parent.parent.parent.name == run_comment(engine.cfg, False)
    model = build_mask_model(family, engine.cfg)
    model.load_state_dict(load_state_dict(str(pth)), strict=True)


@pytest.mark.parametrize("extra, match", [
    # ported since: the engine is built and holds the option (the id is
    # the refusal case's)
    pytest.param(["--model", "xception", "--moe_experts", "2"], None,
                 id="--model_xception_--moe_experts_2---moe_experts"),
    # ported since: the engine is built and holds the option (the id is
    # the refusal case's); built in one process, it runs the chain per
    # microbatch (the command starts a rank a stage)
    pytest.param(["--model", "xception", "--pp", "2"], None,
                 id="--model_xception_--pp_2-parallelism"),
    # ported since: the engine is built and holds the option (the id is
    # the refusal case's); built in one process, it holds every expert
    # (the command starts an ep group)
    pytest.param(["--model", "xception", "--moe_experts", "2",
                  "--moe_shards", "2"], None,
                 id="--model_xception_--moe_experts_2_--moe_shards_2-"
                    "parallelism"),
    # ported since: the engine is built and holds the option (the id is
    # the refusal case's)
    pytest.param(["--model", "clstm", "--accum", "2"], None,
                 id="--model_clstm_--accum_2---accum"),
    # ported since: the engine is built and holds the option
    pytest.param(["--model", "clstm", "--ref_mode_quirks"], None,
                 id="--model_clstm_--ref_mode_quirks-train-mode test sweep"),
    # --resume is ported; a path that is no file is refused by name
    pytest.param(["--model", "clstm", "--resume", "x"],
                 "--resume x: no such file",
                 id="--model_clstm_--resume_x-exact resume"),
    # ported since: the engine is built and holds the option
    pytest.param(["--model", "ganomaly"], None,
                 id="--model_ganomaly-GANomaly"),
], ids=lambda v: v if isinstance(v, str) else "_".join(v))
def test_trainer_refuses_what_the_supervised_port_does_not_run(
        tmp_path, extra, match):
    argv = _ARGS + ["--nfr", "8"] + extra + ["--result_root", str(tmp_path)]
    if match is None:
        engine = trainer.build_engine(argv)
        if extra[-1] == "--ref_mode_quirks":
            assert engine.cfg.ref_mode_quirks and not engine.stuck_in_eval
        elif "--accum" in extra:
            assert engine.cfg.accum == 2
            assert type(engine).__name__ == "SupervisedEngine"
        elif "--pp" in extra:
            assert engine.pipe.grid is None
            assert engine.pipe.gpipe.n_micro == 2
            assert len(engine.pipe.owned) == 8
        elif "--moe_shards" in extra:
            assert engine.cfg.moe_shards == 2 and engine.shards is None
            assert engine.model.moe.experts_w1.shape[0] == 2
        elif "--moe_experts" in extra:
            assert engine.model.moe.router.shape == (
                engine.model.block11.rep[1].conv1.weight.shape[0], 2)
        else:
            assert engine.cfg.model == "ganomaly"
            assert type(engine).__name__ == "GanomalyEngine"
        engine.close()
        return
    with pytest.raises(SystemExit, match=match):
        trainer.main(argv)
