"""The port's TensorBoard logger and run directories against the JAX
package's (``vfd_gan_tpu.obs.summary``): the video grid, what reaches the
event files (read back with tensorboard's ``EventAccumulator``), the
disabled logger and the engines' panel fetches, and ``profile_trace``.

Tolerance: ``_to_grid`` is the same numpy arithmetic in both packages and
is held ``assert_array_equal``; scalars read back from an event file are
float32, held to 1e-6 relative.
"""

import builtins
import dataclasses
import glob
import json
import os

import numpy as np
import pytest

from vfd_gan_tpu.config import Config as JaxConfig
from vfd_gan_tpu.obs import summary as jsummary
from vfd_gan_tpu_torch.cli import trainer
from vfd_gan_tpu_torch.config import Config
from vfd_gan_tpu_torch.obs import summary
from vfd_gan_tpu_torch.obs.profiling import profile_trace
from vfd_gan_tpu_torch.obs.summary import SummaryLogger, _to_grid
from test_torch_port_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The tier runs several workers on one machine: eight torch threads
    in each would only contend."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("normalize", [True, False], ids=["color", "gray"])
def test_to_grid_equals_jax(channels, normalize):
    video = np.random.default_rng(channels).uniform(
        -1.5, 1.5, (3, 4, 6, 5, channels)).astype(np.float32)
    got = _to_grid(video, normalize)
    np.testing.assert_array_equal(got, jsummary._to_grid(video, normalize))
    assert got.shape == (4, 3, 6, 3 * 5) and got.dtype == np.float32
    assert 0.0 <= got.min() and got.max() <= 1.0
    # clip b of the batch sits in columns [b * W, (b + 1) * W) of each frame
    b = 2
    one = _to_grid(video, False)[:, 0, :, b * 5:(b + 1) * 5]
    np.testing.assert_array_equal(one, np.clip(video[b, ..., 0], 0, 1))


def test_run_dirs_comment_and_config_dump_equal_jax(tmp_path):
    kw = dict(model="clstm", batchsize=8, nfr=16, isize=128, lr=2e-4)
    cfg, jcfg = Config(**kw), JaxConfig(**kw)
    for gan in (True, False):
        assert summary.run_comment(cfg, gan) == jsummary.run_comment(
            jcfg, gan=gan)
    dirs = summary.make_run_dirs(str(tmp_path), "clstm", "c")
    jdirs = jsummary.make_run_dirs(str(tmp_path / "j"), "clstm", "c")
    for d in (dirs, jdirs):
        assert os.path.isdir(d.weights) and os.path.isdir(d.runs)
        assert os.path.dirname(d.weights) == d.root
    assert dataclasses.asdict(dirs).keys() == dataclasses.asdict(jdirs).keys()
    summary.dump_config(dirs.root, cfg)
    jsummary.SummaryLogger(jdirs.runs, enabled=False).dump_config(
        jdirs.root, jcfg)
    with open(os.path.join(dirs.root, "args.txt")) as f, \
            open(os.path.join(jdirs.root, "args.txt")) as g:
        assert f.read() == g.read()


def _accumulators(logdir):
    """tag -> [(step, value)] over the run dir and the sub-directories that
    ``add_scalars`` writes its series into; and the histogram tags."""
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    scalars, hists = {}, {}
    for root, _, files in os.walk(logdir):
        if not any("tfevents" in f for f in files):
            continue
        acc = EventAccumulator(root, size_guidance={"histograms": 0,
                                                    "scalars": 0})
        acc.Reload()
        sub = os.path.relpath(root, logdir)
        for tag in acc.Tags()["scalars"]:
            key = tag if sub == "." else f"{tag}|{sub}"
            scalars[key] = [(e.step, e.value) for e in acc.Scalars(tag)]
        for tag in acc.Tags()["histograms"]:
            hists[tag] = acc.Histograms(tag)
    return scalars, hists


def test_scalars_nested_scalars_and_histograms_reach_the_event_file(
        tmp_path):
    logger = SummaryLogger(str(tmp_path), enabled=True)
    assert logger.enabled
    values = np.random.default_rng(0).normal(size=500).astype(np.float32)
    video = np.random.default_rng(1).uniform(size=(2, 3, 8, 8, 3))
    for step in (5, 10):
        # without moviepy the video panels are left out, and nothing raises
        logger.update(step, color_videos={"train/input": video},
                      gray_videos={"train/gt": video[..., :1]},
                      errors={"d/err_d/train": 0.25 * step,
                              "g/err_g/test": 1.5},
                      scores={"score/roc": 0.01 * step},
                      hists={"train/pred": values})
    logger.close()
    assert not logger.enabled
    scalars, hists = _accumulators(str(tmp_path))
    assert scalars["score/roc"] == [(5, pytest.approx(0.05, rel=1e-6)),
                                    (10, pytest.approx(0.10, rel=1e-6))]
    # add_scalars(head, {tail: v}): the series of head "d/err_d" is "train"
    nested = {k: v for k, v in scalars.items() if k.startswith("d/err_d|")}
    (key, series), = nested.items()
    assert key.endswith("d_err_d_train")
    assert series == [(5, pytest.approx(1.25)), (10, pytest.approx(2.5))]
    assert any(k.startswith("g/err_g|") and k.endswith("g_err_g_test")
               for k in scalars)
    (h5, h10) = hists["train/pred"]
    assert (h5.step, h10.step) == (5, 10)
    assert h5.histogram_value.num == 500
    assert h5.histogram_value.min == pytest.approx(values.min(), rel=1e-6)


def test_disabled_logger_writes_nothing(tmp_path):
    logger = SummaryLogger(str(tmp_path), enabled=False)
    assert not logger.enabled and not logger.videos
    logger.update(1, errors={"a/b": 1.0}, scores={"s": 1.0},
                  hists={"h": np.ones(3)})
    logger.close()
    assert os.listdir(tmp_path) == []


def test_logger_is_disabled_where_tensorboard_is_missing(tmp_path,
                                                         monkeypatch, capsys):
    real_import = builtins.__import__

    def no_tensorboard(name, *args, **kwargs):
        if name.startswith(("torch.utils.tensorboard", "tensorboard")):
            raise ImportError(f"No module named {name!r}")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    monkeypatch.setattr(summary, "_said", set())
    first = SummaryLogger(str(tmp_path), enabled=True)
    second = SummaryLogger(str(tmp_path), enabled=True)
    assert not first.enabled and not second.enabled
    first.update(1, scores={"s": 1.0})
    out = capsys.readouterr().out
    assert out.count("tensorboard package is not installed") == 1  # once
    assert os.listdir(tmp_path) == []


_ARGS = ["--model", "clstm", "--batchsize", "2", "--nfr", "8", "--isize",
         "16", "--compute_dtype", "float32", "--synthetic_data", "2",
         "--synthetic_test_batches", "1", "--synthetic_thick_masks", "--ep",
         "2", "--freq", "2", "--device", "cpu"]


def test_no_tensorboard_run_fetches_no_panel_and_keeps_metrics_jsonl(
        tmp_path, monkeypatch):
    engine = trainer.build_engine([*_ARGS, "--no-tensorboard",
                                   "--result_root", str(tmp_path)])
    fetched = []
    monkeypatch.setattr(engine, "_update_train_videos",
                        lambda: fetched.append(engine.global_step))
    engine.train()
    engine.close()
    assert not engine.summary.enabled and fetched == []
    assert engine._viz is None and not engine.panel_step
    assert engine.color_videos == engine.gray_videos == engine.hists == {}
    assert os.listdir(engine.dirs.runs) == []
    with open(os.path.join(engine.dirs.root, "metrics.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    assert [r["step"] for r in recs] == [2, 4]
    assert {"loss/err/train", "loss/err/test", "score/roc"} <= set(recs[0])


@pytest.mark.parametrize("model", ["clstm", "mygan"])
def test_tensorboard_run_writes_what_metrics_jsonl_holds(tmp_path, model):
    argv = list(_ARGS)
    if model == "mygan":
        argv[1:8] = ["mygan", "--batchsize", "1", "--nfr", "16", "--isize",
                     "64"]
        argv += ["--ngf", "2", "--ndf", "2"]
    engine = trainer.main([*argv, "--tensorboard", "--result_root",
                           str(tmp_path)])
    assert glob.glob(os.path.join(engine.dirs.runs, "events.out.tfevents.*"))
    scalars, hists = _accumulators(engine.dirs.runs)
    with open(os.path.join(engine.dirs.root, "metrics.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    assert [r["step"] for r in recs] == [2, 4]
    for key in ("score/roc", "score/pr", "score/f1"):
        got = scalars[key]
        assert [s for s, _ in got] == [2, 4]
        for (_, v), rec in zip(got, recs):
            assert v == pytest.approx(rec[key], rel=1e-6, nan_ok=True)
    # every error of metrics.jsonl is a nested series of its tag's head
    for tag in (k for k in recs[-1] if "/" in k and not k.startswith(
            "score/")):
        head, tail = tag.rsplit("/", 1)
        series = [v for k, v in scalars.items() if k.startswith(f"{head}|")
                  and k.endswith(f"{head.replace('/', '_')}_{tail}")]
        assert len(series) == 1, tag
        assert series[0][-1][1] == pytest.approx(recs[-1][tag], rel=1e-6)
    if model == "mygan":
        # the panels' tensors were fetched at the summary cadence: the
        # histograms of JAX's MyGAN engine
        assert set(hists) == {f"train/{k}" for k in (
            "input", "gt", "pred", "t_pre", "m_pre")}
        assert [h.step for h in hists["train/pred"]] == [2, 4]
        assert engine._viz is None          # dropped once fetched
    if not engine.summary.videos:
        assert engine.color_videos == engine.gray_videos == {}


def test_profile_trace_writes_a_trace_and_is_inert_without_a_logdir(
        tmp_path):
    import torch

    with profile_trace(None) as prof:
        assert prof is None
    with profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any("mm" in e.key for e in prof.key_averages())
    assert glob.glob(str(tmp_path / "trace" / "*.pt.trace.json*"))
