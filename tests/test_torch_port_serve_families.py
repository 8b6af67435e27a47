"""The port's infer and serve entry points for the three supervised
families (the "c2plus1d" AutoEncoder, Xception-3D, the ConvLSTM) against
the JAX package on the CPU.

Each family's JAX variables come from the JAX initialiser, get random
positive BN statistics and a wider zero-mean head (so that the mask crosses
0.5), pass through the port's weight bridge into a reference-format
``.pth`` and are loaded by ``cli.infer._load`` from the file's name.  The
same uint8 clips, made from a seed with numpy, then go through the JAX
model in eval mode and through ``predict_clips`` and ``serve``.

Sizes: b2; the ConvLSTM at T4, 16x16; the AutoEncoder at T16, 16x16 (its
four poolings halve T); Xception at ``width_mult`` 1/16, T4, 32x32.

Tolerances: predictions and frame scores 2e-5 (float32 convolutions summed
in another order, as for the Generator); the opened mask is exact wherever
no prediction within the opening's reach is that close to 0.5; a served
request against the port's direct forward 1e-5.
"""

import functools
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vfd_gan_tpu.cli.evaluate_models import _SUBSTRING_DISPATCH
from vfd_gan_tpu.config import Config as JaxConfig
from vfd_gan_tpu.models import build_mask_model as jax_build
from vfd_gan_tpu.ops.image import threshold as jthreshold
from vfd_gan_tpu.ops.morphology import video_open as jvideo_open
from vfd_gan_tpu_torch.cli import infer
from vfd_gan_tpu_torch.cli.serve import build_parser, serve
from vfd_gan_tpu_torch.models.convlstm import ConvLSTMModel
from vfd_gan_tpu_torch.models.mygan import Generator
from vfd_gan_tpu_torch.models.stcnn import AutoEncoder
from vfd_gan_tpu_torch.models.xception3d import Xception3D
from vfd_gan_tpu_torch.ops.image import to_channel_first, to_channel_last
from vfd_gan_tpu_torch.utils.weights import (
    autoencoder_state_dict,
    convlstm_state_dict,
    xception_state_dict,
)
from test_torch_port_threads import one_torch_thread  # noqa: F401

ATOL = 2e-5
TIMEOUT = 60
XWIDTH = 1 / 16
# family -> (bridge, port class, display name, nfr, isize)
FAMILIES = {
    "c2plus1d": (autoencoder_state_dict, AutoEncoder, "(2+1)DCNN", 16, 16),
    "xception": (xception_state_dict, Xception3D, "XceptionNet", 4, 32),
    "clstm": (convlstm_state_dict, ConvLSTMModel, "ConvLSTM", 4, 16),
}
BATCH = 2


def _frames(family, seed):
    _, _, _, t, s = FAMILIES[family]
    return np.random.default_rng(seed).integers(
        0, 256, (BATCH, t, s, s, 3), dtype=np.uint8)


def _apply(model, variables, frames):
    """The JAX eval forward on uint8 frames, scaled as ``cli/infer.py``
    scales them."""
    x = jnp.asarray(frames).astype(jnp.float32) / 255.0 * 2.0 - 1.0
    return np.asarray(jax.jit(lambda v, x: model.apply(v, x, False))(
        variables, x))


@functools.lru_cache(maxsize=None)
def _jax_model_and_variables(family):
    _, _, _, t, s = FAMILIES[family]
    cfg = JaxConfig(model=family, batchsize=BATCH, nfr=t, isize=s, ep=1,
                    compute_dtype="float32", tensorboard=False,
                    xwidth=XWIDTH)
    model = jax_build(family, cfg, jnp.float32)
    x = jnp.zeros((BATCH, t, s, s, 3), jnp.float32)
    v = jax.jit(lambda k: model.init({"params": k, "dropout": k}, x, False))(
        jax.random.key(0))
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(-0.3, 0.3, a.shape) if p[-1].key == "mean"
                      else rng.uniform(0.3, 2.0, a.shape)).astype(np.float32),
        v["batch_stats"])
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    head = rng.normal(0, 0.5, params["head_kernel"].shape).astype(np.float32)
    params["head_kernel"] = head - head.mean()
    variables = {"params": params, "batch_stats": stats}
    if "head_bias" in params:
        # Xception's narrow decoder leaves logits of ~0.1 +- 0.01: centre and
        # widen them through its head's own scale and bias
        p = _apply(model, variables, _frames(family, 1))
        logit = np.log(p / (1 - p))
        params["head_kernel"] = params["head_kernel"] / logit.std()
        params["head_bias"] = ((params["head_bias"] - logit.mean())
                               / logit.std()).astype(np.float32)
    return model, variables


@functools.lru_cache(maxsize=None)
def _pth(family):
    """The family's bridged weights as a reference-format .pth whose name
    holds the family's substring (removed when the process exits)."""
    import atexit
    import shutil
    import tempfile

    bridge = FAMILIES[family][0]
    _, variables = _jax_model_and_variables(family)
    sd = {k: torch.from_numpy(np.array(a))
          for k, a in bridge(variables).items()}
    where = tempfile.mkdtemp()
    atexit.register(shutil.rmtree, where, True)
    path = f"{where}/roc-0.9000_{family}_step0002.pth"
    torch.save({"epoch": 0, "state_dict": sd}, path)
    return path


def _jax_pred(family, frames):
    return _apply(*_jax_model_and_variables(family), frames)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_load_builds_the_family_from_the_file_name(family):
    _, cls, name, _, _ = FAMILIES[family]
    model, got_name = infer._load(_pth(family), torch.device("cpu"))
    assert isinstance(model, cls) and not model.training
    assert got_name == name
    if family == "xception":         # the width is the checkpoint's
        assert model.conv1.out_channels == round(32 * XWIDTH)


@pytest.mark.parametrize("plane", ["th", "hw"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_predict_clips_matches_jax(family, plane):
    frames = _frames(family, 1)
    want = _jax_pred(family, frames)
    assert 0.002 < (want > 0.5).mean() < 0.998    # the mask crosses 0.5
    model, _ = infer._load(_pth(family), torch.device("cpu"))
    pred, opened, scores = infer.predict_clips(model, frames, plane)
    assert pred.shape == opened.shape == want.shape
    np.testing.assert_allclose(pred.numpy(), want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        scores.numpy(), want[..., 0].reshape(*want.shape[:2], -1).mean(axis=2),
        rtol=0, atol=ATOL)
    # the opening is exact; a pixel of the opened mask reads the thresholds
    # of the pixels within 2r = 4 of it in the plane's two axes
    want_open = np.asarray(jvideo_open(jthreshold(jnp.asarray(want)), plane))
    close = torch.from_numpy((np.abs(want - 0.5) <= ATOL).astype(np.float32))
    axes = {"th": (1, 2), "hw": (2, 3)}[plane]
    moved = close.movedim(axes, (-2, -1))
    reach = F.max_pool2d(moved.flatten(0, -3)[None], 9, 1, 4)[0].reshape(
        moved.shape).movedim((-2, -1), axes).numpy() > 0
    assert reach.mean() < 0.5
    assert opened.is_contiguous()
    np.testing.assert_array_equal(opened.numpy()[~reach], want_open[~reach])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_served_request_matches_the_direct_forward_and_jax(family):
    _, _, name, t, s = FAMILIES[family]
    args = build_parser().parse_args(
        ["--ckpt", _pth(family), "--port", "0", "--isize", str(s), "--nfr",
         str(t), "--max_batch", str(BATCH), "--device", "cpu"])
    httpd = serve(args)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        srv = httpd.inference
        assert srv.name == name and not srv.model.training
        frames = _frames(family, 2)
        clips = frames.astype(np.float32) / 255.0 * 2.0 - 1.0
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/predict",
            data=clips.tobytes(), method="POST",
            headers={"X-Clip-Count": str(BATCH)})
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            out = json.loads(r.read())
        got = np.asarray(out["frame_scores"])
        with torch.inference_mode():
            direct = to_channel_last(srv.model(to_channel_first(
                torch.from_numpy(clips))))
        np.testing.assert_allclose(
            got, direct[..., 0].flatten(2).mean(dim=2).numpy(), rtol=0,
            atol=1e-5)
        want = _jax_pred(family, frames)
        np.testing.assert_allclose(
            got, want[..., 0].reshape(BATCH, t, -1).mean(axis=2), rtol=0,
            atol=ATOL)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{httpd.server_address[1]}/healthz",
                timeout=TIMEOUT) as r:
            assert json.loads(r.read())["model"] == name
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.inference.close()
    thread.join(timeout=10)


# File names both packages accept: the port's display name is the JAX
# table's for the first substring the name holds ("netG" is the JAX infer
# CLI's synonym of "ganbase").
_JAX_NAMES = {sub: name for sub, _, name in _SUBSTRING_DISPATCH}
_JAX_NAMES["netG"] = _JAX_NAMES["ganbase"]


@pytest.mark.parametrize("file_name, substring, cls", [
    ("run_netG.pth", "netG", Generator),
    ("x_ganbase.pth", "ganbase", Generator),
    ("mygan_best.pth", "mygan", Generator),
    ("roc-0.91_c2plus1d.pth", "c2plus1d", AutoEncoder),
    ("xception_step0100.pth", "xception", Xception3D),
    ("best_clstm.pth", "clstm", ConvLSTMModel),
    # the reference's if/elif order: the generator's names win
    ("mygan_vs_clstm.pth", "mygan", Generator),
    ("c2plus1d_xception.pth", "c2plus1d", AutoEncoder),
])
def test_filename_dispatch_follows_the_jax_table(tmp_path, file_name,
                                                 substring, cls):
    seed = torch.Generator().manual_seed(0)
    if cls is Generator:
        model = Generator(ngf=4, generator=seed)
    elif cls is Xception3D:
        model = Xception3D(3, XWIDTH, generator=seed)
    else:
        model = cls(generator=seed)
    path = str(tmp_path / file_name)
    torch.save({"epoch": 3, "state_dict": model.state_dict()}, path)
    loaded, name = infer._load(path, torch.device("cpu"))
    assert type(loaded) is cls and not loaded.training
    assert name == _JAX_NAMES[substring]
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


@pytest.mark.parametrize("make, match", [
    (lambda d: str(d), "export_torch"),                  # an Orbax run dir
    (lambda d: str(d / "weights.pth"), "cannot infer model type"),
], ids=["directory", "unknown_name"])
def test_load_still_exits_for(tmp_path, make, match):
    with pytest.raises(SystemExit, match=match):
        infer._load(make(tmp_path), torch.device("cpu"))


# a port run of each kind: (trainer flags, the model class infer builds)
_RUNS = {
    "clstm": (["--model", "clstm", "--isize", "16", "--nfr", "8"],
              ConvLSTMModel),
    "mygan": (["--model", "mygan", "--isize", "64", "--nfr", "16", "--ngf",
               "4", "--ndf", "4"], Generator),
}


@pytest.mark.parametrize("run", list(_RUNS))
def test_load_takes_a_port_runs_latest_pt(tmp_path, run):
    """A port run's ``weights/latest.pt`` (whose path holds the model's
    name) loads by its structure, G of a GAN run, ``strict=True``, with
    ``--dtype``; ``serve`` takes it too."""
    from vfd_gan_tpu_torch.cli import trainer

    flags, cls = _RUNS[run]
    engine = trainer.main([
        *flags, "--batchsize", "2", "--compute_dtype", "float32",
        "--synthetic_data", "2", "--synthetic_test_batches", "1", "--ep",
        "1", "--freq", "100", "--max_steps", "1", "--autosave_every", "1",
        "--no-tensorboard", "--device", "cpu", "--result_root",
        str(tmp_path)])
    latest, = tmp_path.rglob("latest.pt")
    assert run in str(latest)
    want = (engine.netg if run == "mygan" else engine.model).state_dict()
    model, name = infer._load(str(latest), torch.device("cpu"),
                              torch.bfloat16)
    assert type(model) is cls and not model.training
    assert name == dict((f, n) for _, f, n in infer.DISPATCH)[run] + " [bf16]"
    for k, v in want.items():
        assert torch.equal(model.state_dict()[k], v), k
    args = build_parser().parse_args(
        ["--ckpt", str(latest), "--port", "0", "--isize", flags[3],
         "--nfr", flags[5], "--max_batch", "1", "--device", "cpu"])
    httpd = serve(args)
    try:
        assert httpd.inference.name == name[:-len(" [bf16]")]
    finally:
        httpd.inference.close()
        httpd.server_close()
