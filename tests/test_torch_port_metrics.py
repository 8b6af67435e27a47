"""The port's test-sweep scoring against the JAX package (which calls
sklearn) on the CPU: ROC AUC, PR AUC and F1 at 0.20 through ``evaluate``,
the curves themselves against sklearn's (ties, end points, collinear ROC
points dropped), and the engine's best-checkpoint rule.  Tolerance: 1e-12
(float64 on both sides; the trapezoid sums may run in another order)."""

import numpy as np
import pytest
import torch
from sklearn import metrics as skm

from vfd_gan_tpu.eval import metrics as jmetrics
from vfd_gan_tpu_torch.eval import metrics
from vfd_gan_tpu_torch.train.engine_base import EngineBase
from test_torch_port_threads import one_torch_thread  # noqa: F401


def _case(name):
    rng = np.random.default_rng(0)
    if name == "random":
        labels = (rng.uniform(size=4000) > 0.7).astype(np.int32)
        scores = np.clip(labels * 0.3 + rng.normal(0.4, 0.2, 4000), 0, 1)
    elif name == "ties":
        # opened binary masks: scores in {0, 1}, heavy ties
        labels = (rng.uniform(size=3000) > 0.8).astype(np.int32)
        scores = np.where(rng.uniform(size=3000) < 0.3 + 0.5 * labels,
                          1.0, 0.0)
    elif name == "few_levels":
        labels = (rng.uniform(size=500) > 0.5).astype(np.int32)
        scores = np.round(rng.uniform(size=500) * 4) / 4
    elif name == "perfect":
        labels = np.array([0, 0, 1, 1, 0, 1], np.int32)
        scores = labels * 0.9 + 0.05
    else:
        raise ValueError(name)
    return labels, scores.astype(np.float32)


CASES = ["random", "ties", "few_levels", "perfect"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("metric", ["roc", "pr", "f1_score"])
def test_evaluate_matches_jax(case, metric):
    labels, scores = _case(case)
    want = jmetrics.evaluate(labels, scores, metric=metric)
    got = metrics.evaluate(labels, scores, metric=metric)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("case", CASES)
def test_curves_match_sklearn(case):
    labels, scores = _case(case)
    for mine, theirs in ((metrics.roc_curve, skm.roc_curve),
                         (metrics.precision_recall_curve,
                          skm.precision_recall_curve)):
        for g, w in zip(mine(labels, scores), theirs(labels, scores)):
            assert g.shape == w.shape, mine.__name__
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)


@pytest.mark.parametrize("case", CASES)
def test_eer_matches_jax(case):
    labels, scores = _case(case)
    got = metrics.roc_auc_with_eer(labels, scores)[1]
    want = jmetrics.roc_auc_with_eer(labels, scores)[1]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


def test_auc_direction_and_refusal():
    assert metrics.auc([0, 0.5, 1], [0, 1, 1]) == skm.auc([0, 0.5, 1],
                                                          [0, 1, 1])
    assert metrics.auc([1, 0.5, 0], [1, 1, 0]) == skm.auc([1, 0.5, 0],
                                                          [1, 1, 0])
    with pytest.raises(ValueError):
        metrics.auc([0, 1, 0.5], [0, 1, 1])


def test_single_class_curves_are_nan_like_sklearn():
    labels = np.zeros(10, np.int32)
    scores = np.linspace(0, 1, 10).astype(np.float32)
    fpr, tpr, _ = metrics.roc_curve(labels, scores)
    assert np.isnan(tpr).all() and not np.isnan(fpr).any()
    with pytest.warns(Warning):
        want = skm.roc_curve(labels, scores)
    np.testing.assert_array_equal(fpr, want[0])
    assert metrics.f1_at(labels, scores) == 0.0


def test_curve_csv_written_only_on_improvement(tmp_path):
    labels, scores = _case("random")
    area = metrics.evaluate(labels, scores, 0.99, 3, str(tmp_path), "roc")
    assert not (tmp_path / "ROC_003").exists()
    metrics.evaluate(labels, scores, 0.0, 3, str(tmp_path), "roc")
    metrics.evaluate(labels, scores, 0.0, 3, str(tmp_path), "pr")
    rows = (tmp_path / "ROC_003").read_text().splitlines()
    assert len(rows) == len(metrics.roc_curve(labels, scores)[0])
    assert (tmp_path / "PR_003").exists() and 0.5 < area < 1.0


class _Scorer(EngineBase):
    """The scoring half of the engine, without run dirs or a model."""

    def __init__(self, root):
        self.best_roc = self.best_pr = 0.0
        self.epoch = 0
        self.scores = {}
        self.dirs = type("Dirs", (), {"root": str(root)})
        self.saved = []


def test_checkpoint_rule_roc_then_pr(tmp_path):
    eng = _Scorer(tmp_path)
    labels, scores = _case("random")
    save = eng.saved.append
    roc, pr, f1 = eng.score_and_checkpoint([labels], [scores], save)
    assert eng.saved == ["roc"] and eng.best_roc == roc
    # same ROC, better PR (ties only reorder within a score level): "pr"
    eng.best_pr = 0.0
    eng.score_and_checkpoint([labels], [scores], save)
    assert eng.saved == ["roc", "pr"]
    # nothing better: no save
    eng.score_and_checkpoint([labels], [scores], save)
    assert eng.saved == ["roc", "pr"]
    assert eng.scores["score/f1"] == pytest.approx(
        skm.f1_score(labels, scores >= 0.2))


def test_gt_truncates_to_int_and_single_class_scores_nan(tmp_path):
    eng = _Scorer(tmp_path)
    # fractional mask edges (0.5) truncate to 0: one class left
    gts = [np.full((2, 4), 0.5, np.float32)]
    preds = [np.linspace(0, 1, 8, dtype=np.float32).reshape(2, 4)]
    roc, pr, f1 = eng.score_and_checkpoint(gts, preds, eng.saved.append)
    assert np.isnan([roc, pr, f1]).all() and eng.saved == []
    assert np.isnan(eng.scores["score/roc"])
    roc, _, _ = eng.score_and_checkpoint([], [], eng.saved.append)
    assert np.isnan(roc) and eng.saved == []


def test_sweep_accumulator_takes_tensors():
    from vfd_gan_tpu_torch.train.engine_base import SweepAccumulator

    acc = SweepAccumulator()
    acc.add(torch.ones(2, 3), torch.zeros(2, 3), {"a": torch.tensor(1.0)})
    acc.add(torch.ones(2, 3), torch.zeros(2, 3), {"a": torch.tensor(3.0)})
    assert acc.mean_metrics() == {"a": 2.0}
    assert acc.gts[0].shape == (2, 3) and isinstance(acc.gts[0], np.ndarray)
