"""``tests/rank_slots.py``, the rank slots that every several-rank test
module claims before it starts its gloo ranks: the ranks held never pass
the capacity (a claim larger than it only alone), under more claiming
processes than cores; claims are served in arrival order; a dead
process's claim is dropped; a claim is given back when its last rank
has ended.  Each test keeps its table in its own tmp
dir, apart from the session's."""

import fcntl
import multiprocessing
import os
import random
import threading
import time

import pytest

import rank_slots

CAP = 4


def _root(tmp_path):
    """A root whose session directory (``rank_slots._session_dir``, with
    or without xdist) lies inside ``tmp_path``."""
    root = tmp_path / "a" / "b" / "c"
    root.mkdir(parents=True)
    return root


def _claimer(root, seed: int, rounds: int, ledger) -> None:
    """Claims of 1, 2, 3 and 6 ranks in turn; while each is held, the
    ranks held by every claimer, counted in ``ledger`` under a lock of its
    own, must be within ``CAP`` (or the claim alone)."""
    rank_slots.capacity = lambda: CAP
    rng = random.Random(seed)

    def count(delta: int) -> int:
        with open(f"{ledger}.lock", "a") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            total = int(open(ledger).read() or 0) + delta
            with open(ledger, "w") as f:
                f.write(str(total))
            return total

    for _ in range(rounds):
        ranks = rng.choice((1, 2, 3, 6))
        slots = rank_slots.Slots(root, ranks)
        slots.acquire(poll=0.005, timeout=60)
        total = count(ranks)
        if total > CAP and total != ranks:
            with open(f"{ledger}.bad", "a") as f:
                f.write(f"{total} held with a claim of {ranks}\n")
        time.sleep(rng.uniform(0, 0.01))
        count(-ranks)
        slots.release()


def test_held_ranks_never_pass_the_capacity_under_load(tmp_path):
    root = _root(tmp_path)
    ledger = tmp_path / "held"
    ledger.write_text("0")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_claimer, args=(root, i, 6, str(ledger)))
             for i in range(2 * len(os.sched_getaffinity(0)))]
    for p in procs:
        p.start()
    for p in procs:
        p.join(120)
    assert not any(p.is_alive() for p in procs)
    assert [p.exitcode for p in procs] == [0] * len(procs)
    assert not (tmp_path / "held.bad").exists(), \
        (tmp_path / "held.bad").read_text()
    assert ledger.read_text() == "0"


def test_claims_are_served_in_arrival_order(tmp_path, monkeypatch):
    """A claim that does not fit holds back the later ones that would."""
    monkeypatch.setattr(rank_slots, "capacity", lambda: CAP)
    root = _root(tmp_path)
    first = rank_slots.Slots(root, 1)
    first.acquire()
    served = []

    def claim(name, ranks):
        slots = rank_slots.Slots(root, ranks)
        slots.acquire(poll=0.005, timeout=60)
        served.append((name, slots))

    big = threading.Thread(target=claim, args=("big", CAP))
    big.start()
    time.sleep(0.2)                       # "big" queues first
    small = threading.Thread(target=claim, args=("small", 1))
    small.start()
    time.sleep(0.5)
    assert served == []                   # 1 + CAP does not fit; 1 + 1 would
    first.release()
    big.join(30)
    assert [n for n, _ in served] == ["big"]
    served[0][1].release()
    small.join(30)
    assert not big.is_alive() and not small.is_alive()
    assert [n for n, _ in served] == ["big", "small"]
    served[1][1].release()


def _hold_and_die(root) -> None:
    rank_slots.capacity = lambda: CAP
    rank_slots.Slots(root, CAP).acquire(timeout=60)
    os._exit(0)                           # no release


def test_a_dead_process_claim_is_dropped(tmp_path, monkeypatch):
    monkeypatch.setattr(rank_slots, "capacity", lambda: CAP)
    root = _root(tmp_path)
    ctx = multiprocessing.get_context("spawn")
    dead = ctx.Process(target=_hold_and_die, args=(root,))
    dead.start()
    dead.join(60)
    assert dead.exitcode == 0
    slots = rank_slots.Slots(root, CAP)
    slots.acquire(poll=0.005, timeout=10)
    slots.release()
    with pytest.raises(RuntimeError, match="no 2 rank slots"):
        holder = rank_slots.Slots(root, CAP)
        holder.acquire()
        try:
            rank_slots.Slots(root, 2).acquire(poll=0.005, timeout=0.2)
        finally:
            holder.release()


def test_a_claim_is_given_back_when_its_last_rank_ends(tmp_path,
                                                       monkeypatch):
    """``ended``: a module's claim stays held while any of its ranks
    runs, and is given back (once) when the last one has ended."""
    monkeypatch.setattr(rank_slots, "capacity", lambda: CAP)
    root = _root(tmp_path)
    module = rank_slots.Slots(root, CAP)
    module.acquire()
    module.ended(CAP - 1)
    with pytest.raises(RuntimeError, match="no 1 rank slots"):
        rank_slots.Slots(root, 1).acquire(poll=0.005, timeout=0.2)
    module.ended(1)
    after = rank_slots.Slots(root, CAP)
    after.acquire(poll=0.005, timeout=10)
    module.release()                      # given back already: no effect
    with pytest.raises(RuntimeError, match="no 1 rank slots"):
        rank_slots.Slots(root, 1).acquire(poll=0.005, timeout=0.2)
    after.release()
