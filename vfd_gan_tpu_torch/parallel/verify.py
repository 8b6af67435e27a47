"""Self-calibrating sharded-vs-replica equivalence gate (port of
``vfd_gan_tpu.parallel.verify``, numpy only).

A sharded step (the candidate) is held to a replica step within
tolerances measured at test time from a yardstick: the same step on
another sharding, which differs from the replica only by the reduction
order.  The gate asks the candidate to stay within ``K`` times the
yardstick's distance, floored (the yardstick may be luckily tiny) and
capped (so a bug that moves yardstick and candidate alike cannot widen
the tolerance past the scale of a semantic error: unsynced gradients or
per-rank BatchNorm statistics move metrics by O(10-100%) and parameters
by O(weight scale 2e-2), above every cap here).
"""

from __future__ import annotations

import numpy as np

# Safety factor over the single noise sample, and the envelope bounds.
# Caps sit ~10x below the smallest semantic-bug signal; floors at the
# float32 single-step reassociation scale.
K = 10.0
REL_FLOOR, REL_CAP = 2e-4, 1e-2
ABS_FLOOR, ABS_CAP = 1e-4, 2e-3


def max_rel_delta(m1: dict, m2: dict) -> float:
    """Largest relative difference across two metric dicts."""
    worst = 0.0
    for k in m1:
        a, b = float(m1[k]), float(m2[k])
        worst = max(worst, abs(a - b) / max(abs(a), abs(b), 1e-6))
    return worst


def max_abs_delta(leaves1, leaves2) -> float:
    """Largest absolute elementwise difference across two leaf lists."""
    return max((float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
                for a, b in zip(leaves1, leaves2)), default=0.0)


def calibrated_tols(yard_metrics: float, yard_leaves: float
                    ) -> tuple[float, float]:
    """(rtol for metrics, atol for leaves) from measured yardstick
    deltas."""
    rtol = float(np.clip(K * yard_metrics, REL_FLOOR, REL_CAP))
    atol = float(np.clip(K * yard_leaves, ABS_FLOOR, ABS_CAP))
    return rtol, atol


def assert_replica_equivalence(replica, yardstick, candidate,
                               label: str = "") -> tuple[float, float]:
    """Gate: ``candidate`` ~= ``replica`` within tolerances calibrated from
    ``yardstick`` ~= ``replica``.  Each argument is ``(metrics_dict,
    leaf_list)``.  Returns the tolerances used."""
    rm, rl = replica
    ym, yl = yardstick
    cm, cl = candidate
    if not set(rm) == set(cm) == set(ym):
        raise AssertionError(f"{label}: metric names differ: "
                             f"{set(rm) ^ set(cm) | set(rm) ^ set(ym)}")
    for k, v in rm.items():
        if not (np.isfinite(v) and np.isfinite(cm[k])):
            raise AssertionError(f"{label}: metric {k} is not finite")
    # a candidate or yardstick missing trailing leaves must fail the gate,
    # not silently shorten the elementwise zip below
    if not len(rl) == len(cl) == len(yl):
        raise AssertionError(f"{label}: leaf counts {len(rl)}, {len(cl)}, "
                             f"{len(yl)}")
    rtol, atol = calibrated_tols(max_rel_delta(rm, ym),
                                 max_abs_delta(rl, yl))
    for k in rm:
        np.testing.assert_allclose(
            cm[k], rm[k], rtol=rtol, atol=1e-6,
            err_msg=f"{label} metric {k} (rtol calibrated {rtol:.2e})")
    for i, (a, b) in enumerate(zip(rl, cl)):
        np.testing.assert_allclose(
            a, b, atol=atol,
            err_msg=f"{label} leaf {i} (atol calibrated {atol:.2e})")
    return rtol, atol
