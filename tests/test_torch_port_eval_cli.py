"""The port's evaluation CLIs against the JAX package's on the CPU:
``evaluate_models`` (the reference's ``test.py``), ``export_torch`` and
``frames``.

* ``evaluate_models.main`` of both packages on one tiny mp4 tree (the
  synthetic writer: one fake clip, 16 frames at 32^2, read in one batch of
  2; at the file's size, so that the gt masks stay 0 or 255 and their
  int32 truncation, the reference's, keeps both classes) and reference
  ``.pth`` files written from JAX initialisers by JAX's
  ``utils/torch_export.save_pth`` (MyGAN's Generator and the ConvLSTM,
  default widths): AUC, EER and F1 within 1e-5 (the two
  frameworks' float32 forwards differ by ~1e-6, which moves a curve point
  or the F1 threshold's count by far less).
* The dispatch table is ``test.py``'s, not ``infer``'s: an ``--ae`` run's
  ``..._c2plus1d_..._netG.pth`` loads as the AutoEncoder in both packages;
  a path that names no family exits with JAX's "Weight path not found.".
  A port run's ``latest.pt`` dispatches on its structure at its width; an
  Orbax directory exits with the conversion command.
* ``export_torch`` of a port run's ``latest.pt`` writes, tensor for tensor,
  what JAX's ``save_pth`` writes for the same weights; GANomaly is refused
  with JAX's words.
* ``frames`` of both packages write byte-equal PNG trees.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfd_gan_tpu.cli import evaluate_models as jeval
from vfd_gan_tpu.cli import export_torch as jexport
from vfd_gan_tpu.cli import frames as jframes
from vfd_gan_tpu.models.convlstm import ConvLSTMModel as JaxConvLSTM
from vfd_gan_tpu.models.mygan import DualDisc as JaxDualDisc
from vfd_gan_tpu.models.mygan import Generator as JaxGenerator
from vfd_gan_tpu.models.stcnn import AutoEncoder as JaxAutoEncoder
from vfd_gan_tpu.models.xception3d import Xception3D as JaxXception3D
from vfd_gan_tpu.utils import torch_export
from vfd_gan_tpu_torch.cli import evaluate_models, export_torch, frames
from vfd_gan_tpu_torch.cli.infer import DISPATCH
from vfd_gan_tpu_torch.config import Config
from vfd_gan_tpu_torch.data.synthetic import make_dataset
from vfd_gan_tpu_torch.models.stcnn import AutoEncoder
from vfd_gan_tpu_torch.train.checkpoints import save_checkpoint
from vfd_gan_tpu_torch.train.gan_engine import MyGanEngine
from vfd_gan_tpu_torch.train.ganomaly_engine import GanomalyEngine
from vfd_gan_tpu_torch.train.supervised_engine import SupervisedEngine
from vfd_gan_tpu_torch.utils import weights
from test_torch_port_threads import one_torch_thread  # noqa: F401

pytest.importorskip("cv2")
CPU = torch.device("cpu")


def _init(module, shape, *extra):
    x = jnp.zeros(shape, jnp.float32)
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: module.init({"params": k, "dropout": k}, x,
                              *[x] * len(extra), False))(jax.random.key(0)))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_cli")
    _, test_list = make_dataset(str(root / "data"), n_train=0, n_test=1,
                                frames=16, size=32)
    pth = {"mygan": root / "mygan_roc_ep0000_netG.pth",
           "clstm": root / "clstm_roc-0.5000_step0001.pth"}
    torch_export.save_pth(str(pth["mygan"]),
                          _init(JaxGenerator(), (1, 16, 32, 32, 3)),
                          "mygan_generator")
    torch_export.save_pth(str(pth["clstm"]),
                          _init(JaxConvLSTM(), (1, 16, 32, 32, 3)), "clstm")
    models = root / "models.txt"
    models.write_text(f"{pth['mygan']}\n{pth['clstm']}\n")
    return root, test_list, models


@pytest.mark.parametrize("metric", ["roc", "pr"])
def test_evaluate_models_matches_jax(tree, metric, capsys):
    root, test_list, models = tree
    argv = ["--test_data_path", test_list, "--test_model_list_path",
            str(models), "--isize", "32", "--nfr", "16", "--batchsize", "2",
            "--metric", metric]
    want = jeval.main(argv + ["--result_path", str(root / f"jax_{metric}")])
    jax_out = capsys.readouterr().out
    out_dir = root / f"port_{metric}"
    got = evaluate_models.main(argv + ["--result_path", str(out_dir),
                                       "--device", "cpu"])
    port_out = capsys.readouterr().out
    assert list(got) == list(want) == ["Propose model[GAN]", "ConvLSTM"]
    for name in want:
        for key in ("auc", "f1", "eer"):
            w, g = want[name][key], got[name][key]
            if w is None:
                assert g is None and metric == "pr"
            else:
                assert abs(g - w) <= 1e-5, (name, key, g, w)
    # the same lines printed, their numbers within 1e-5
    lines = [[ln.split(" == ") for ln in out.splitlines() if " == " in ln]
             for out in (jax_out, port_out)]
    assert [k for k, _ in lines[0]] == [k for k, _ in lines[1]]
    assert len(lines[0]) == 4
    for (_, w), (_, g) in zip(*lines):
        assert abs(float(g) - float(w)) <= 1e-5
    assert (out_dir / f"{metric}_curve.png").is_file()
    csvs = sorted(p.name for p in out_dir.glob("*.csv"))
    assert csvs == [f"{metric}_curve_0_mygan_roc_ep0000_netG.csv",
                    f"{metric}_curve_1_clstm_roc-0.5000_step0001.csv"]


def test_evaluate_without_matplotlib_writes_the_csvs(tree, tmp_path,
                                                     monkeypatch, capsys):
    root, _, _ = tree
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    batches = [_memory_batch(0)]
    got = evaluate_models.evaluate_checkpoints(
        [str(root / "clstm_roc-0.5000_step0001.pth")], batches, "roc",
        str(tmp_path), CPU)
    out = capsys.readouterr().out
    assert out.count("matplotlib is not installed") == 1
    assert not (tmp_path / "roc_curve.png").exists()
    assert (tmp_path / "roc_curve_0_clstm_roc-0.5000_step0001.csv").is_file()
    assert np.isfinite(got["ConvLSTM"]["auc"])


def _memory_batch(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (2, 16, 32, 32, 3), dtype=np.uint8)
    mask = np.zeros((2, 16, 32, 32, 1), np.uint8)
    mask[:, :, 8:20, 10:24] = 255
    return {"data": data, "real": data, "mask": mask}


def test_dispatch_order_is_test_py_s(tmp_path):
    """``..._c2plus1d_..._netG.pth``: the AutoEncoder here and in JAX (the
    ``infer`` table, which tries "netG" first, would pick the Generator)."""
    path = tmp_path / "ae_c2plus1d_roc_ep0003_netG.pth"
    torch.save({"epoch": 3, "state_dict": AutoEncoder().state_dict()}, path)
    model, name = evaluate_models.load_model(str(path), CPU)
    assert isinstance(model, AutoEncoder) and name == "(2+1)DCNN"
    assert jeval.load_model(str(path), None)[2] == name
    assert next(f for subs, f, _ in DISPATCH
                if any(s in path.name for s in subs)) == "mygan"

    missing = tmp_path / "weights.pth"
    torch.save({"epoch": 0, "state_dict": {}}, missing)
    with pytest.raises(SystemExit) as want:
        jeval.load_model(str(missing), None)
    with pytest.raises(SystemExit) as got:
        evaluate_models.load_model(str(missing), CPU)
    assert str(got.value) == str(want.value) == "Weight path not found."
    with pytest.raises(SystemExit, match="Orbax checkpoints need jax"):
        evaluate_models.load_model(str(tmp_path), CPU)


def test_latest_pt_dispatches_on_structure_at_its_width(tmp_path):
    cfg = Config(model="mygan", isize=64, nfr=16, batchsize=2, ngf=4, ndf=4,
                 compute_dtype="float32", tensorboard=False,
                 result_root=str(tmp_path)).validate()
    engine = MyGanEngine(cfg, None, None, device=CPU)
    latest = tmp_path / "latest.pt"
    save_checkpoint(str(latest), engine._ckpt_tree())
    model, name = evaluate_models.load_model(str(latest), CPU)
    assert name == "Propose model[GAN]"
    assert model.conv_last.weight.shape[1] == 4
    for k, v in engine.netg.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


# -- export_torch -------------------------------------------------------------

def _export_case(name: str, tmp_path):
    """A port engine holding JAX-initialised weights, and per written file
    (the JAX variables, the JAX exporter's kind)."""
    if name in ("mygan", "ae"):
        # 128^2: JAX's DualDisc exporter assumes the reference's geometry
        cfg = Config(model="mygan", isize=128, nfr=16, batchsize=2, ngf=4,
                     ndf=4, ae=name == "ae", compute_dtype="float32",
                     tensorboard=False, result_root=str(tmp_path)).validate()
        engine = MyGanEngine(cfg, None, None, device=CPU)
        if name == "ae":
            g_vars, kind = _init(JaxAutoEncoder(), (1, 16, 16, 16, 3)), \
                "c2plus1d"
            g_sd = weights.autoencoder_state_dict(g_vars)
        else:
            g_vars, kind = _init(JaxGenerator(ngf=4), (1, 16, 16, 16, 3)), \
                "mygan_generator"
            g_sd = weights.generator_state_dict(g_vars)
        d_vars = _dualdisc_vars()
        _load(engine.netg, g_sd)
        _load(engine.netd, weights.dualdisc_state_dict(d_vars))
        return engine, {"latest_netG.pth": (g_vars, kind),
                        "latest_netD.pth": (d_vars, "mygan_dualdisc")}
    model, bridge, kw, shape = {
        "clstm": (JaxConvLSTM(), weights.convlstm_state_dict, {},
                  (1, 8, 16, 16, 3)),
        "xception": (JaxXception3D(width_mult=1 / 16),
                     weights.xception_state_dict, {"xwidth": 1 / 16},
                     (1, 8, 32, 32, 3))}[name]
    cfg = Config(model=name, isize=shape[2], nfr=shape[1], batchsize=2,
                 compute_dtype="float32", tensorboard=False,
                 result_root=str(tmp_path), **kw).validate()
    engine = SupervisedEngine(cfg, None, None, device=CPU)
    variables = _init(model, shape)
    _load(engine.model, bridge(variables))
    return engine, {"latest.pth": (variables, name)}


@functools.lru_cache(maxsize=1)
def _dualdisc_vars():
    return _init(JaxDualDisc(ndf=4), (1, 16, 128, 128, 3), "y")


def _load(module, sd):
    module.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in sd.items()}, strict=True)


@pytest.mark.parametrize("name", ["mygan", "ae", "clstm", "xception"])
def test_export_equals_jax_save_pth(name, tmp_path):
    engine, files = _export_case(name, tmp_path)
    engine.epoch = 3
    latest = tmp_path / "latest.pt"
    save_checkpoint(str(latest), engine._ckpt_tree())
    written = export_torch.main(["--ckpt", str(latest), "--out",
                                 str(tmp_path / "out")])
    assert sorted(os.path.basename(p) for p, _ in written) == sorted(files)
    for fname, (variables, kind) in files.items():
        assert (str(tmp_path / "out" / fname), kind) in written
        want_path = tmp_path / f"jax_{fname}"
        torch_export.save_pth(str(want_path), variables, kind, epoch=3)
        want = torch.load(want_path, weights_only=True)
        got = torch.load(tmp_path / "out" / fname, weights_only=True)
        assert got["epoch"] == want["epoch"] == 3
        assert set(got["state_dict"]) == set(want["state_dict"])
        for k, v in want["state_dict"].items():
            g = got["state_dict"][k]
            assert g.dtype == v.dtype and torch.equal(g, v), (fname, k)


def test_export_refuses_ganomaly_in_jax_s_words(tmp_path):
    cfg = Config(model="ganomaly", isize=32, nfr=8, batchsize=2,
                 compute_dtype="float32", tensorboard=False,
                 result_root=str(tmp_path)).validate()
    engine = GanomalyEngine(cfg, None, None, device=CPU)
    latest = tmp_path / "latest.pt"
    save_checkpoint(str(latest), engine._ckpt_tree())
    with pytest.raises(SystemExit) as want:
        jexport._g_kind({"enc1": {}})
    with pytest.raises(SystemExit) as got:
        export_torch.main(["--ckpt", str(latest), "--out", str(tmp_path)])
    assert str(got.value) == str(want.value)
    assert not list(tmp_path.glob("*.pth"))


# -- frames -------------------------------------------------------------------

def test_frames_trees_are_byte_equal(tree, tmp_path):
    root, _, _ = tree
    src = str(root / "data")
    jframes.main(["--src", src, "--dst", str(tmp_path / "jax")])
    frames.main(["--src", src, "--dst", str(tmp_path / "port")])

    def files(top):
        return {os.path.relpath(os.path.join(d, f), top):
                open(os.path.join(d, f), "rb").read()
                for d, _, names in os.walk(top) for f in names}

    want, got = files(tmp_path / "jax"), files(tmp_path / "port")
    assert sorted(got) == sorted(want)
    assert len(want) == 3 * 16 and any("/mask/" in k for k in want)
    for k, v in want.items():
        assert got[k] == v, k
