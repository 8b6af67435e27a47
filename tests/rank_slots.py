"""Admission of the several-rank test modules' gloo ranks: at most
``capacity()`` rank processes compute at once across the pytest-xdist
workers of one session, so that whether a group meets its join timeout
(counted from its ranks' start, ``parallel/mesh.launch``) does not depend
on which files share a wave of ``--dist loadfile``.

A module claims the ranks of all its groups at once (``Slots``), before
its first group starts, and gives them back when its last group has
ended: its groups may wait on each other (a reference written by one
and read by another), so a module never holds part of its claim.
Claims are served in arrival order, each once the ranks held by the
others leave room for it (a claim larger than the capacity once nothing
else is held).  The table of claims is a JSON file beside the workers'
base temporary directories, under an ``fcntl`` lock; a claim whose
process is gone is dropped.
"""

from __future__ import annotations

import fcntl
import json
import os
import threading
import time
import uuid
from pathlib import Path


def capacity() -> int:
    """Rank processes at once: one and a half a core (each rank computes
    on one torch thread, and waits in its collectives part of the time);
    two modules of 6 ranks fit side by side on 8 cores."""
    cores = len(os.sched_getaffinity(0))
    return cores + cores // 2


def _session_dir(root: Path) -> Path:
    """The directory shared by the session's workers: the parent of a
    worker's base temporary directory under xdist (``root`` is a
    ``tmp_path_factory.mktemp`` directory), else the base itself."""
    base = Path(root).parent
    return base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


class Slots:
    """One module's claim on ``ranks`` rank processes (``acquire`` blocks
    until it is served; ``release`` gives it back, once)."""

    def __init__(self, root, ranks: int):
        where = _session_dir(root)
        self.table = where / "rank_slots.json"
        self.lock = where / "rank_slots.lock"
        self.ranks = ranks
        self.key = f"{os.getpid()}:{uuid.uuid4().hex}"
        self._state = "new"
        self._ended = 0
        self._mutex = threading.Lock()

    def _edit(self, change):
        """``change(table)`` under the lock, the table rewritten after it;
        returns what ``change`` returns."""
        with open(self.lock, "a") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                table = json.loads(self.table.read_text()) \
                    if self.table.exists() else {"queue": [], "held": {}}
                for kind in ("queue", "held"):
                    gone = [k for k in table[kind]
                            if not _alive(int(k.split(":")[0]))]
                    for k in gone:
                        if kind == "queue":
                            table[kind].remove(k)
                        else:
                            del table[kind][k]
                out = change(table)
                part = self.table.with_suffix(".part")
                part.write_text(json.dumps(table))
                os.replace(part, self.table)
                return out
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)

    def acquire(self, poll: float = 0.2, timeout: float = 1200.0) -> None:
        """Wait until the claim is served (raises after ``timeout``
        seconds, the claim withdrawn)."""
        with self._mutex:
            if self._state != "new":
                return
            start = time.monotonic()
            self._edit(lambda t: t["queue"].append(self.key))

            def serve(table):
                held = sum(table["held"].values())
                if table["queue"][0] != self.key or (
                        held and held + self.ranks > capacity()):
                    return False
                table["queue"].pop(0)
                table["held"][self.key] = self.ranks
                return True

            while not self._edit(serve):
                if time.monotonic() - start > timeout:
                    table = self._edit(lambda t: (
                        t["queue"].remove(self.key), dict(t))[1])
                    raise RuntimeError(f"no {self.ranks} rank slots in "
                                       f"{timeout:g} s: {table}")
                time.sleep(poll)
            self._state = "held"

    def release(self) -> None:
        with self._mutex:
            if self._state != "held":
                return
            self._edit(lambda t: t["held"].pop(self.key, None))
            self._state = "released"

    def ended(self, ranks: int) -> None:
        """``ranks`` of the claim's rank processes have ended: the claim
        is given back once all of them have."""
        with self._mutex:
            self._ended += ranks
            done = self._ended >= self.ranks
        if done:
            self.release()
