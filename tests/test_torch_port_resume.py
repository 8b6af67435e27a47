"""Autosave, SIGTERM parking and exact resume of the port's trainer, on
the CPU: a run stopped at step k and resumed equals the unbroken run bit
for bit (parameters, BatchNorm buffers, Adam state and the ``metrics.jsonl``
lines after k), as ``tests/test_exact_resume.py`` and
``tests/test_autosave.py`` hold the JAX engine.  Tolerance: none, every
comparison is ``torch.equal`` or ``==``.

Sizes: MyGAN (and ``--ae``) at b1, T16, 64x64, ngf = ndf = 2 (its smallest
valid size); the supervised families at the sizes of
``tests/test_torch_port_supervised.py``; mp4 files of 32x32 from the JAX
package's ``make_dataset``.  The runs use two torch threads: the tier runs
several workers on one machine, and eight threads each would only contend.
"""

import json
import os
import signal
import threading

import pytest
import torch

from vfd_gan_tpu.data.synthetic import make_dataset
from vfd_gan_tpu_torch.cli import trainer
from vfd_gan_tpu_torch.train import checkpoints
from vfd_gan_tpu_torch.train.checkpoints import (
    AsyncSaver,
    restore_checkpoint,
    save_checkpoint,
)
from test_torch_port_threads import one_torch_thread  # noqa: F401

_COMMON = ["--compute_dtype", "float32", "--no-tensorboard", "--device",
           "cpu", "--lr", "2e-4", "--seed", "3", "--workers", "1"]
# net -> the flags of its smallest run
NETS = {
    "mygan": ["--model", "mygan", "--batchsize", "1", "--nfr", "16",
              "--isize", "64", "--ngf", "2", "--ndf", "2"],
    "mygan_ae": ["--model", "mygan", "--ae", "--batchsize", "1", "--nfr",
                 "16", "--isize", "64", "--ndf", "2"],
    "clstm": ["--model", "clstm", "--batchsize", "2", "--nfr", "8",
              "--isize", "16"],
    "c2plus1d": ["--model", "c2plus1d", "--batchsize", "2", "--nfr", "16",
                 "--isize", "16"],
    "xception": ["--model", "xception", "--batchsize", "2", "--nfr", "8",
                 "--isize", "32", "--xwidth", "0.0625"],
}
# two epochs of two synthetic batches: steps 1-4, a sweep and a metrics
# line at steps 2 and 4; step 3 lies across the epoch boundary, mid-epoch
SYNTHETIC = ["--synthetic_data", "2", "--synthetic_test_batches", "1",
             "--synthetic_thick_masks", "--ep", "2", "--freq", "2"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(argv, root, hook=None):
    """Train ``argv`` under ``root``; returns the engine and its
    ``metrics.jsonl`` records, without the wall-clock field, as text."""
    engine = trainer.build_engine([*argv, *_COMMON, "--result_root",
                                   str(root)])
    if hook is not None:
        hook(engine)
    try:
        engine.train()
    finally:
        engine.close()
    recs = []
    path = os.path.join(engine.dirs.root, "metrics.jsonl")
    if os.path.exists(path):
        with open(path) as f:
            for ln in f:
                rec = json.loads(ln)
                rec.pop("perf/steps_per_sec")
                # as text: a NaN score then equals a NaN score
                recs.append(json.dumps(rec, sort_keys=True))
    return engine, recs


def _latest(engine) -> str:
    return os.path.join(engine.dirs.weights, "latest.pt")


def _assert_tree_equal(a, b, where="tree"):
    assert type(a) is type(b), where
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def _assert_same_end_state(a, b):
    """Parameters, buffers, Adam state, generator, cursor, best scores."""
    ta, tb = a._ckpt_tree(), b._ckpt_tree()
    for t in (ta, tb):          # the iterators' own counters aside
        t["loop"].pop("train_iter_epoch")
    _assert_tree_equal(ta, tb)


@pytest.mark.parametrize("net", list(NETS))
def test_stopped_and_resumed_run_equals_the_unbroken_run(net, tmp_path):
    """Stop at step k with an autosave, read ``latest.pt`` with
    ``weights_only``, restore it into a fresh engine (every tensor and
    number comes back) and run on: the unbroken run, bit for bit."""
    argv = NETS[net] + SYNTHETIC
    # the AutoEncoder's 36M parameters are slow on the CPU: one epoch,
    # stopped at step 1; the others two epochs, stopped at step 3
    n, k = (2, 1) if net in ("mygan_ae", "c2plus1d") else (4, 3)
    argv = argv + ["--ep", str(n // 2)]
    whole, recs_a = _run(argv, tmp_path / "a")
    assert [json.loads(r)["step"] for r in recs_a] == list(range(2, n + 1, 2))
    first, recs_b1 = _run(argv + ["--max_steps", str(k), "--autosave_every",
                                  str(k)], tmp_path / "b1")
    assert first.global_step == k and os.path.isfile(_latest(first))
    saved = torch.load(_latest(first), map_location="cpu", weights_only=True)
    _assert_tree_equal(saved, checkpoints.host_copy(first._ckpt_tree()))

    second = trainer.build_engine([*argv, *_COMMON, "--resume",
                                   _latest(first), "--result_root",
                                   str(tmp_path / "b2")])
    _assert_tree_equal(checkpoints.host_copy(second._ckpt_tree()), saved)
    assert second.global_step == k
    assert (second.epoch, second.batch_in_epoch) == ((k - 1) // 2,
                                                     (k - 1) % 2 + 1)
    for net_state in second._nets().values():
        for group in net_state.optimizer.state_dict()["param_groups"]:
            assert group["betas"] == (0.5, 0.999) and group["lr"] == 2e-4
    second.train()
    second.close()
    assert second.global_step == n
    # only the steps after k ran, from the cursor
    assert len(second.step_seconds) == n - k
    with open(os.path.join(second.dirs.root, "metrics.jsonl")) as f:
        recs_b2 = [json.dumps({k_: v for k_, v in json.loads(ln).items()
                               if k_ != "perf/steps_per_sec"},
                              sort_keys=True) for ln in f]
    assert recs_b1 + recs_b2 == recs_a
    _assert_same_end_state(whole, second)
    # the Adam moments moved and were compared
    state = next(iter(second._nets().values())).optimizer.state_dict()
    assert float(state["state"][0]["step"]) == float(n)


def test_restore_overwrites_another_seeds_state(tmp_path):
    """A fresh engine of another seed, restored: nothing of its own
    initial state is left."""
    argv = NETS["clstm"] + SYNTHETIC
    first, _ = _run(argv + ["--max_steps", "1", "--autosave_every", "1"],
                    tmp_path / "a")
    saved = restore_checkpoint(_latest(first))
    fresh = trainer.build_engine([*argv, *_COMMON, "--seed", "9",
                                  "--result_root", str(tmp_path / "f")])
    assert not torch.equal(
        fresh._ckpt_tree()["state"]["module"]["conv_last.weight"],
        saved["state"]["module"]["conv_last.weight"])
    fresh.close()
    other = trainer.build_engine(
        [*argv, *_COMMON, "--seed", "9", "--resume", _latest(first),
         "--result_root", str(tmp_path / "b")])
    assert other.global_step == 1
    assert (other.epoch, other.batch_in_epoch) == (0, 1)
    _assert_tree_equal(checkpoints.host_copy(other._ckpt_tree()), saved)
    other.close()


@pytest.fixture(scope="module")
def mp4_lists(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("resume_vids"))
    return make_dataset(root, n_train=2, n_test=1, frames=16, size=32)


def _mp4_args(lists, **kw):
    opts = {"--ep": "2", "--freq": "4", **kw}
    return ["--model", "clstm", "--batchsize", "1", "--nfr", "8", "--isize",
            "16", "--tr_plist", lists[0], "--ts_plist", lists[1],
            *[x for kv in opts.items() for x in kv]]


def test_kill_midepoch_resume_is_bit_exact_on_mp4_data(mp4_lists, tmp_path):
    """``tests/test_exact_resume.py`` for the port: 8 train windows, two
    epochs, stopped at step 3 and at step 9 (across the epoch boundary)."""
    whole, recs_a = _run(_mp4_args(mp4_lists), tmp_path / "a")
    assert whole.global_step == 16 and len(recs_a) == 4
    for k in (3, 9):
        first, recs_b1 = _run(_mp4_args(mp4_lists) + [
            "--max_steps", str(k), "--autosave_every", "1"],
            tmp_path / f"b1_{k}")
        second, recs_b2 = _run(_mp4_args(mp4_lists) + [
            "--resume", _latest(first)], tmp_path / f"b2_{k}")
        assert second.global_step == 16
        assert len(second.step_seconds) == 16 - k
        assert recs_b1 + recs_b2 == recs_a
        _assert_same_end_state(whole, second)


def test_sigterm_saves_latest_and_exits_cleanly(mp4_lists, tmp_path):
    """A SIGTERM raised after step 2 parks ``latest.pt``, ``train()``
    returns, the handlers are restored, and the resumed run ends where the
    unbroken run does."""
    whole, recs_a = _run(_mp4_args(mp4_lists, **{"--ep": "1"}),
                         tmp_path / "a")
    before = signal.getsignal(signal.SIGTERM)

    def raise_after_step_2(engine):
        step = engine._train_step_impl

        def step_then_sigterm(batch):
            out = step(batch)
            if engine.global_step == 2:
                signal.raise_signal(signal.SIGTERM)
            return out

        engine._train_step_impl = step_then_sigterm

    first, recs_b1 = _run(_mp4_args(mp4_lists, **{"--ep": "1"}),
                          tmp_path / "b1", hook=raise_after_step_2)
    assert first.global_step == 2 and os.path.isfile(_latest(first))
    assert signal.getsignal(signal.SIGTERM) == before
    second, recs_b2 = _run(_mp4_args(mp4_lists, **{"--ep": "1"})
                           + ["--resume", _latest(first)], tmp_path / "b2")
    assert (second.global_step, second.epoch) == (whole.global_step, 0)
    assert recs_b1 + recs_b2 == recs_a
    _assert_same_end_state(whole, second)


def test_signal_latch_is_a_no_op_off_the_main_thread(tmp_path):
    engine = trainer.build_engine([*NETS["clstm"], *SYNTHETIC, *_COMMON,
                                   "--max_steps", "1", "--result_root",
                                   str(tmp_path)])
    before = signal.getsignal(signal.SIGTERM)
    errors = []

    def run():
        try:
            engine.train()
        except Exception as e:  # pragma: no cover - the failure path
            errors.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert not errors and engine.global_step == 1
    assert signal.getsignal(signal.SIGTERM) == before
    engine.close()


def test_async_autosave_writes_latest_and_resumes(tmp_path):
    argv = NETS["clstm"] + SYNTHETIC
    first, _ = _run(argv + ["--autosave_every", "2", "--autosave_async"],
                    tmp_path / "a")
    tree = restore_checkpoint(_latest(first))
    # single-flight: a save is skipped while one is in flight, so latest
    # is from step 2 or 4
    assert tree["step"] in (2, 4)
    second = trainer.build_engine([*argv, *_COMMON, "--resume",
                                   _latest(first), "--result_root",
                                   str(tmp_path / "b")])
    assert second.global_step == tree["step"]
    second.close()


def test_async_saver_is_single_flight_and_copies_before_it_returns(
        tmp_path, monkeypatch):
    gate, started = threading.Event(), threading.Event()
    write = checkpoints._write

    def slow_write(path, tree):
        started.set()
        gate.wait(timeout=30)
        write(path, tree)

    monkeypatch.setattr(checkpoints, "_write", slow_write)
    saver = AsyncSaver()
    live = {"w": torch.zeros(3), "step": 1}
    path = str(tmp_path / "latest.pt")
    assert saver.save(path, live) is True
    started.wait(timeout=30)
    live["w"].add_(1.0)                 # the next step's in-place update
    assert saver.save(path, {"w": torch.ones(3), "step": 2}) is False
    gate.set()
    saver.wait()
    got = restore_checkpoint(path)
    assert got["step"] == 1 and torch.equal(got["w"], torch.zeros(3))
    assert saver.save(path, live) is True       # free again
    saver.wait()
    assert torch.equal(restore_checkpoint(path)["w"], torch.ones(3))
    assert not os.path.exists(path + ".tmp")


def test_save_checkpoint_replaces_atomically(tmp_path):
    path = str(tmp_path / "latest.pt")
    save_checkpoint(path, {"a": torch.arange(3), "n": 1, "s": "x",
                           "l": [1.5, (2, 3)]})
    save_checkpoint(path, {"a": torch.arange(4), "n": 2, "s": "y",
                           "l": [2.5, (4, 5)]})
    got = restore_checkpoint(path)
    assert got["n"] == 2 and got["s"] == "y" and got["l"] == [2.5, (4, 5)]
    assert torch.equal(got["a"], torch.arange(4))
    assert os.listdir(tmp_path) == ["latest.pt"]


def test_resume_refuses_a_state_from_another_device_type(tmp_path):
    argv = NETS["clstm"] + SYNTHETIC
    first, _ = _run(argv + ["--max_steps", "1", "--autosave_every", "1"],
                    tmp_path / "a")
    tree = restore_checkpoint(_latest(first))
    assert tree["loop"]["device"] == "cpu"
    tree["loop"]["device"] = "cuda"
    moved = str(tmp_path / "from_the_card.pt")
    save_checkpoint(moved, tree)
    with pytest.raises(SystemExit, match="saved on device 'cuda' and cannot "
                                         "continue on 'cpu'.*generator"):
        trainer.build_engine([*argv, *_COMMON, "--resume", moved,
                              "--result_root", str(tmp_path / "b")])


def test_resume_refuses_an_orbax_directory_and_another_models_state(
        tmp_path):
    argv = NETS["clstm"] + SYNTHETIC
    (tmp_path / "orbax_latest").mkdir()
    with pytest.raises(SystemExit, match="vfd_gan_tpu.cli.export_torch"):
        trainer.build_engine([*argv, *_COMMON, "--resume",
                              str(tmp_path / "orbax_latest"),
                              "--result_root", str(tmp_path / "a")])
    first, _ = _run(argv + ["--max_steps", "1", "--autosave_every", "1"],
                    tmp_path / "b")
    with pytest.raises(SystemExit, match="not this model's train state"):
        trainer.build_engine([*NETS["mygan"], *SYNTHETIC, *_COMMON,
                              "--resume", _latest(first), "--result_root",
                              str(tmp_path / "c")])
