"""``chip_smoke.py``'s evaluate check: the bounds that a move of the
scores puts on ``cli.evaluate_models``' metrics (``_metric_bounds``).

On near-tied scores (a few distinct levels, as a young model's masks on
flat synthetic clips give) every score is moved by up to ``d`` at random,
as another device's rounding would; each metric of the moved scores lies
within its bound of the first's: the AUC within the share of
(positive, negative) pairs that lie within 2 d, the EER within the share
of a class's pixels within 2 d of the thresholds around its crossing, F1
within its extremes over the pixels within d of 0.20.  The check passes
such a move and refuses the control (scores moved past 1e-4)."""

import numpy as np
import pytest

import chip_smoke
from vfd_gan_tpu_torch.eval.metrics import f1_at, roc_auc_with_eer


def _metrics(labels, scores) -> dict:
    area, eer, _, _ = roc_auc_with_eer(labels, scores)
    return {"auc": area, "eer": eer, "f1": f1_at(labels, scores)}


def _near_tied(seed: int):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(500, 4000))
    labels = (rng.random(n) < rng.uniform(0.2, 0.8)).astype(np.int32)
    levels = rng.uniform(0.15, 0.6, int(rng.integers(3, 30)))
    scores = (levels[rng.integers(0, len(levels), n)]
              + labels * rng.uniform(0, 0.05)
              + rng.normal(0, rng.choice([0.0, 1e-5, 1e-3]), n))
    return rng, labels, scores.astype(np.float32)


@pytest.mark.parametrize("seed", range(8))
def test_a_move_of_the_scores_keeps_each_metric_within_its_bound(seed):
    rng, labels, scores = _near_tied(seed)
    want = _metrics(labels, scores)
    for d in (1e-6, 1e-5, 5e-5):
        moved = (scores + rng.uniform(-d, d, scores.shape)).astype(
            np.float32)
        got = _metrics(labels, moved)
        bounds = chip_smoke._metric_bounds(
            labels, scores,
            float(np.abs(moved.astype(np.float64) - scores).max()))
        for key, bound in bounds.items():
            assert abs(got[key] - want[key]) <= bound + \
                chip_smoke.EVAL_SLACK, (seed, d, key, got, want, bounds)
        ok, line = chip_smoke._evaluate_reading("seeded", labels, moved,
                                                scores, got, want)
        assert ok, line


def test_the_check_refuses_scores_moved_past_its_tolerance():
    _, labels, scores = _near_tied(0)
    moved = scores + np.where(labels == 1, chip_smoke.EVAL_CONTROL_MOVE,
                              -chip_smoke.EVAL_CONTROL_MOVE).astype(
                                  np.float32)
    ok, line = chip_smoke._evaluate_reading(
        "control", labels, moved, scores, _metrics(labels, moved),
        _metrics(labels, scores))
    assert not ok and "scores max |d| 0.0002" in line, line


def test_a_bound_reads_the_ties_not_a_constant():
    """Scores in two tied groups: a move that can cross between them
    bounds the AUC by the whole pair share, one that cannot by none."""
    labels = np.array([0] * 50 + [1] * 50, np.int32)
    scores = np.where(np.arange(100) % 2 == 0, 0.4, 0.4 + 1e-3).astype(
        np.float32)
    assert chip_smoke._metric_bounds(labels, scores, 1e-3)["auc"] == 1.0
    assert chip_smoke._metric_bounds(labels, scores, 1e-5)["auc"] == 0.5
