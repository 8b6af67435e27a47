"""``tools/dp_equivalence.Standing`` on the CPU: two gloo ranks that start
once and run batches of cases one after another give, batch by batch,
what two ranks started for that batch alone give, bit for bit; a failing
case stops them and raises, and closing them leaves no rank running.

The batches are small float64 cases: clstm at ``--dp 2`` (b4, T8, 16^2),
then GANomaly at ``--sp 2`` (b2, T8, 16^2), 2 steps each and a one-batch
sweep, each beside its one-process reference.  The ranks run
``vfd_gan_tpu_torch.tools.dp_equivalence``, so no rank imports JAX.
"""

import os
import threading

import pytest
import torch

from vfd_gan_tpu_torch.tools import dp_equivalence as eq
from rank_slots import Slots

JOIN_S = 300.0
_COMMON = ["--compute_dtype", "float32", "--synthetic_data", "2",
           "--synthetic_test_batches", "1", "--synthetic_thick_masks",
           "--ep", "1", "--seed", "3"]
_CLSTM = ["--model", "clstm", "--batchsize", "4", "--nfr", "8", "--isize",
          "16", *_COMMON]


def _ganomaly(sp: int) -> list:
    return ["--model", "ganomaly", "--batchsize", "2", "--nfr", "8",
            "--isize", "16", "--sp", str(sp), *_COMMON]


_BASE = dict(kind="train", steps=2, float64=True, sweep=True)
# one batch a parallel layout: its reference first (one rank alone), then
# the group's run held against it
BATCHES = (
    [dict(_BASE, name="clstm.dp1", dp=1, argv=_CLSTM),
     dict(_BASE, name="clstm.dp2", dp=2, argv=_CLSTM, ref="clstm.dp1")],
    [dict(_BASE, name="ganomaly.sp1", dp=1, arith="dp", argv=_ganomaly(1)),
     dict(_BASE, name="ganomaly.sp2", dp=2, argv=_ganomaly(2),
          ref="ganomaly.sp1")],
)

def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    # a child that exited but was not yet reaped still answers
    with open(f"/proc/{pid}/stat") as f:
        return f.read().split(") ")[1][0] != "Z"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The batches run by standing ranks, and each by ranks of its own
    (side by side)."""
    root = tmp_path_factory.mktemp("standing")
    fresh = [root / f"fresh{i}" for i in range(len(BATCHES))]
    failed = []
    # the standing pair and a fresh pair a batch, claimed from the
    # session's rank slots (tests/test_torch_port_sp._Ranks)
    slots = Slots(root, 2 * (len(BATCHES) + 1))
    slots.acquire()

    def alone(cases, out):
        try:
            eq.run(cases, out, world=2, backend="gloo", timeout=JOIN_S,
                   log=out.with_suffix(".log"))
        except BaseException as e:
            failed.append(e)

    threads = [threading.Thread(target=alone, args=(cases, out))
               for cases, out in zip(BATCHES, fresh)]
    try:
        for t in threads:
            t.start()
        with eq.Standing(root / "ranks") as ranks:
            for cases in BATCHES:
                ranks.run(cases, root / "standing", timeout=JOIN_S)
            pids = list(ranks.pids)
    finally:
        for t in threads:
            if t.is_alive():
                t.join()
        slots.release()
    assert not failed, failed
    return root / "standing", fresh, pids


@pytest.mark.parametrize("batch", range(len(BATCHES)),
                         ids=[b[1]["name"] for b in BATCHES])
def test_a_standing_batch_equals_ranks_of_its_own(runs, batch):
    standing, fresh, _ = runs
    ref, run = (case["name"] for case in BATCHES[batch])
    got = torch.load(standing / f"{ref}.ref.pt", weights_only=False)
    want = torch.load(fresh[batch] / f"{ref}.ref.pt", weights_only=False)
    for kind in eq.KINDS[:4]:
        assert got[kind].keys() == want[kind].keys()
        for k, v in want[kind].items():
            assert torch.equal(got[kind][k], v), f"{ref} {kind} {k}"
    assert got["scores"] == want["scores"]
    for rank in (0, 1):
        got = torch.load(standing / f"{run}.rank{rank}.pt",
                         weights_only=False)
        want = torch.load(fresh[batch] / f"{run}.rank{rank}.pt",
                          weights_only=False)
        assert got["digest"] == want["digest"], f"{run} rank {rank}"
        assert got["scores"] == want["scores"]
    got, want = (torch.load(root / f"{run}.rank0.pt", weights_only=False)
                 for root in (standing, fresh[batch]))
    assert got["distances"] == want["distances"]
    # and the run is the one-process run's (dp 2 == dp 1, sp 2 == sp 1)
    assert max(d for d, _ in got["distances"].values()) <= 1e-9


def test_closed_standing_ranks_are_gone(runs):
    *_, pids = runs
    assert len(pids) == 2
    assert not any(_alive(pid) for pid in pids)


def test_a_failing_case_stops_the_standing_ranks_and_raises(tmp_path):
    bad = dict(_BASE, name="nosuch.dp2", dp=2,
               argv=["--model", "nosuch", *_COMMON])
    with eq.Standing(tmp_path / "ranks") as ranks:
        with pytest.raises(RuntimeError, match="standing ranks stopped"):
            ranks.run([bad], tmp_path / "out", timeout=JOIN_S)
        pids = list(ranks.pids)
    assert len(pids) == 2
    assert not any(_alive(pid) for pid in pids)
