"""The port's ``--device_scoring`` on the CPU: ``eval/device_metrics.py``
against the JAX package's functions and against the port's host metrics
(``eval/metrics.py``, sklearn's semantics), and engine sweeps scored on
the device against the host path.

Cases (those of ``tests/test_device_metrics.py``): smooth scores, 8-bit
quantised ones (ties), binary ones (opened masks, the GAN sweep's) and
balanced classes; single-class labels; fractional gt truncated by the
int cast.  Tolerances are the JAX tests': 1e-5 for ROC, EER and PR, 1e-6
for F1; against JAX's own functions the port's are equal (the same
float32 arithmetic).
"""

import numpy as np
import pytest
import torch

from vfd_gan_tpu.eval import device_metrics as jdm
from vfd_gan_tpu_torch.cli import trainer
from vfd_gan_tpu_torch.eval import device_metrics as dm
from vfd_gan_tpu_torch.eval import metrics as host
from test_torch_port_threads import one_torch_thread  # noqa: F401


def _cases():
    rng = np.random.default_rng(0)
    n = 5000
    labels = (rng.uniform(size=n) < 0.03).astype(np.float32)
    smooth = np.clip(rng.normal(0.2, 0.2, n) + 0.5 * labels, 0, 1)
    yield "smooth", labels, smooth.astype(np.float32)
    yield "quantised", labels, (np.round(smooth * 255) / 255).astype(
        np.float32)
    yield "binary", labels, (smooth > 0.4).astype(np.float32)
    lab2 = (rng.uniform(size=n) < 0.5).astype(np.float32)
    yield "balanced", lab2, np.clip(
        rng.normal(0, 0.3, n) + 0.3 * lab2, -1, 2).astype(np.float32)


CASES = list(_cases())


@pytest.mark.parametrize("name, labels, scores", CASES,
                         ids=[c[0] for c in CASES])
def test_matches_jax_and_the_host_metrics(name, labels, scores):
    lab, sc = torch.from_numpy(labels), torch.from_numpy(scores)
    for fn in ("roc_auc", "roc_eer", "pr_auc", "f1_at"):
        got = getattr(dm, fn)(lab, sc)
        assert got.dtype == torch.float32 and got.dim() == 0, fn
        assert float(got) == float(getattr(jdm, fn)(labels, scores)), fn
    want_auc, want_eer, _, _ = host.roc_auc_with_eer(labels, scores)
    want_pr, _, _ = host.pr_auc(labels, scores)
    assert abs(float(dm.roc_auc(lab, sc)) - want_auc) < 1e-5
    assert abs(float(dm.pr_auc(lab, sc)) - want_pr) < 1e-5
    assert abs(float(dm.f1_at(lab, sc)) - host.f1_at(labels, scores)) < 1e-6
    if np.isfinite(want_eer):
        assert abs(float(dm.roc_eer(lab, sc)) - want_eer) < 1e-5


def test_score_sweep_int_cast_matches_jax_and_host():
    rng = np.random.default_rng(1)
    gts = rng.uniform(0, 1, (4, 8, 16, 16, 1)).astype(np.float32)
    gts[gts > 0.97] = 1.0                 # a few exact positives
    preds = rng.uniform(0, 1, gts.shape).astype(np.float32)
    got = [float(v) for v in dm.score_sweep(torch.from_numpy(gts),
                                            torch.from_numpy(preds))]
    assert got == [float(v) for v in jdm.score_sweep(gts, preds)]
    labels = np.asarray(gts, dtype=np.int32).ravel()
    want_auc, want_eer, _, _ = host.roc_auc_with_eer(labels, preds.ravel())
    assert abs(got[0] - want_auc) < 1e-5 and abs(got[1] - want_eer) < 1e-5
    assert abs(got[2] - host.pr_auc(labels, preds.ravel())[0]) < 1e-5
    assert abs(got[3] - host.f1_at(labels, preds.ravel())) < 1e-6


def test_single_class_is_nan():
    labels = torch.zeros(100)
    scores = torch.linspace(0, 1, 100)
    for fn in (dm.roc_auc, dm.roc_eer, dm.pr_auc):
        assert torch.isnan(fn(labels, scores)), fn.__name__
    assert float(dm.f1_at(labels, scores)) == 0.0


# the families whose sweeps score pixels, at tiny sizes: the supervised
# clstm (opened masks), AnoGAN (raw heat maps) and MyGAN (opened masks)
SWEEPS = {
    "clstm": ["--model", "clstm", "--nfr", "8", "--isize", "16"],
    "anogan": ["--model", "anogan", "--nfr", "8", "--isize", "16"],
    "mygan": ["--model", "mygan", "--nfr", "16", "--isize", "64", "--ngf",
              "2", "--ndf", "2"],
}


def _engine(family, root, *extra):
    return trainer.build_engine(
        [*SWEEPS[family], "--batchsize", "2", "--compute_dtype", "float32",
         "--synthetic_data", "1", "--synthetic_test_batches", "2",
         "--synthetic_thick_masks", "--device", "cpu", "--no-tensorboard",
         "--seed", "3", "--result_root", str(root), *extra])


@pytest.mark.parametrize("family", list(SWEEPS))
def test_engine_sweep_on_the_device_matches_the_host(family, tmp_path):
    """--device_scoring: the same roc/pr/f1 as the host path on the same
    weights and data, the EER besides, and the same best checkpoint."""
    torch.set_num_threads(2)
    results, saved = {}, {}
    for flag in (False, True):
        root = tmp_path / str(flag)
        eng = _engine(family, root, *(["--device_scoring"] if flag else []))
        assert eng.cfg.device_scoring == flag
        results[flag] = eng.test()
        assert ("score/eer" in eng.scores) == flag
        eng.close()
        saved[flag] = sorted(p.name for p in root.rglob("*.pth"))
    assert all(np.isfinite(results[True]))
    np.testing.assert_allclose(results[True], results[False], rtol=0,
                               atol=1e-5)
    assert saved[True] == saved[False] and saved[True]


def test_device_sweep_refuses_ragged_batches_and_saves_nothing_on_nan(
        tmp_path):
    eng = _engine("clstm", tmp_path, "--device_scoring")
    saves = []
    gts = [torch.zeros(2, 8, 16, 16, 1), torch.zeros(1, 8, 16, 16, 1)]
    with pytest.raises(ValueError, match="uniform per-batch shapes"):
        eng.score_and_checkpoint(gts, [torch.rand_like(g) for g in gts],
                                 saves.append)
    gts = [torch.zeros(2, 8, 16, 16, 1)] * 2      # single-class
    roc, pr, f1 = eng.score_and_checkpoint(
        gts, [torch.rand_like(g) for g in gts], saves.append)
    assert np.isnan(roc) and np.isnan(pr) and np.isnan(f1)
    assert saves == [] and eng.best_roc == 0.0
    eng.close()
