"""Checkpoints of the training engine (port of
``vfd_gan_tpu.train.checkpoints``).

*Best weights.*  The reference saves ``{head}_ep{epoch:04d}_netG.pth`` /
``_netD.pth`` pairs, each ``torch.save({'epoch', 'state_dict'})``, when the
test sweep's ROC or PR improves (lib/train_gan.py:52-57).  The port writes
the same files: the reference's ``test.py``, the JAX package's ``.pth``
import and the port's own loader (``utils/checkpoint.load_state_dict``)
read them.

*Full train state*, for autosave and exact resume (``weights/latest.pt``):
one ``torch.save`` file of a tree of tensors, Python numbers, strings, lists
and dicts (per net its ``state_dict()`` and its optimizer's, plus ``step``
and the ``loop`` sub-tree of ``EngineBase._loop_state``), which
``torch.load(..., weights_only=True)`` reads.  It is written through a
temporary name and ``os.replace``, so a reader never sees half a file.  The
JAX package stores the same state with Orbax; train state does not cross
the two frameworks (weights do, as ``.pth``).
"""

from __future__ import annotations

import os
import threading
from typing import Any

import torch
import torch.nn as nn


def best_ckpt_name(head: str, epoch: int, net: str | None = None) -> str:
    """Reference-style checkpoint names."""
    if net is None:
        return f"{head}_ep{epoch:04d}"
    return f"{head}_ep{epoch:04d}_{net}"


def save_pth(path: str, module: nn.Module, epoch: int) -> None:
    """Write ``{'epoch', 'state_dict'}`` with the tensors on the CPU,
    through a temporary name, so a reader never sees half a file."""
    sd = {k: v.detach().cpu() for k, v in module.state_dict().items()}
    tmp = f"{path}.tmp"
    torch.save({"epoch": int(epoch), "state_dict": sd}, tmp)
    os.replace(tmp, path)


def host_copy(tree: Any) -> Any:
    """``tree`` with every tensor copied to the CPU.  Always a copy, also
    of a CPU tensor: ``optimizer.step()`` writes in place, so what a
    background write holds must not alias the live state.  On return the
    device-to-host copies are complete."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_copy(v) for v in tree)
    return tree


def _write(path: str, host_tree: Any) -> None:
    tmp = f"{path}.tmp"
    torch.save(host_tree, tmp)
    os.replace(tmp, path)


def save_checkpoint(path: str, tree: Any) -> None:
    """Save a tree as one file (replaces an existing one at ``path``)."""
    _write(path, host_copy(tree))


def restore_checkpoint(path: str) -> Any:
    """The saved tree, its tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


class AsyncSaver:
    """Overlap a checkpoint's serialisation and IO with training
    (``--autosave_async``).

    ``save`` copies the state to the host before it returns (the next
    step's in-place updates must not reach what is being written), then a
    background thread writes the file.  Single-flight: while the last
    write is alive a new save is skipped (returns False), not queued: a
    rolling ``latest`` needs only the most recent state, and two writers
    on one path would race.  ``wait()`` joins the write in flight (before
    the process exits, before a final save or a restore of the same path).
    """

    def __init__(self):
        self._thread: threading.Thread | None = None

    def save(self, path: str, tree: Any) -> bool:
        if self._thread is not None and self._thread.is_alive():
            return False
        self._thread = threading.Thread(
            target=_write, args=(path, host_copy(tree)), daemon=True)
        self._thread.start()
        return True

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
