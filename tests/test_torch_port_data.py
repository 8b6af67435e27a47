"""The port's mp4 data path against the JAX package's, on the same files:
mask preparation, the window table, every dataset item, two epochs of
batches (one and two decode workers, a ``skip_batches`` resume), the
synthetic-video writer, and ``device_prefetch`` on the CPU.

Tolerance: none.  Decode, Canny, resize, the shuffle (numpy's
``default_rng((seed, epoch))``) and the packing are the same calls in both
packages, so every array is compared with ``assert_array_equal``, the
``index`` field included.  Files: 24 frames of 48x48 written by
``vfd_gan_tpu.data.synthetic.make_dataset``.
"""

import threading
import time

import numpy as np
import pytest
import torch

from vfd_gan_tpu.data import dataset as jds
from vfd_gan_tpu.data import native as jnative
from vfd_gan_tpu.data import synthetic as jsyn
from vfd_gan_tpu.data import video_io as jio
from vfd_gan_tpu_torch.data import dataset as pds
from vfd_gan_tpu_torch.data import native as pnative
from vfd_gan_tpu_torch.data import synthetic as psyn
from vfd_gan_tpu_torch.data import video_io as pio
from vfd_gan_tpu_torch.data.device_synthetic import DeviceSyntheticIterator
from vfd_gan_tpu_torch.parallel import prefetch
from vfd_gan_tpu_torch.parallel.prefetch import device_prefetch, to_device
from test_torch_port_threads import one_torch_thread  # noqa: F401

FIELDS = ("data", "real", "mask", "label", "index")


@pytest.fixture(scope="module")
def lists(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("vids"))
    return jsyn.make_dataset(root, n_train=2, n_test=1, frames=24, size=48)


def _first_fake(lists):
    with open(lists[0]) as f:
        return f.readline().strip()


def test_derive_triple_and_count_frames(lists):
    fake = _first_fake(lists)
    assert pds.derive_triple(fake) == jds.derive_triple(fake)
    for path in pds.derive_triple(fake):
        assert pio.count_frames(path) == jio.count_frames(path) == 24


@pytest.mark.parametrize("resize_to", [None, (32, 32), (20, 52)],
                         ids=["native", "32x32", "20x52"])
@pytest.mark.parametrize("mask", [False, True], ids=["rgb", "mask"])
def test_read_clip_equals_jax(lists, mask, resize_to):
    path = pds.derive_triple(_first_fake(lists))[2 if mask else 0]
    got = pio.read_clip(path, 8, 8, resize_to=resize_to, mask=mask)
    want = jio.read_clip(path, 8, 8, resize_to=resize_to, mask=mask)
    assert got.dtype == np.uint8
    assert got.shape == (8, *(resize_to or (48, 48)), 1 if mask else 3)
    np.testing.assert_array_equal(got, want)
    if mask and resize_to is None:
        # an edge map, not a filled region
        assert set(np.unique(got).tolist()) <= {0, 255}
        assert 0 < (got > 0).mean() < 0.2


def test_mask_edge_frames_equals_jax_and_read_clip(lists):
    path = pds.derive_triple(_first_fake(lists))[2]
    rgb = pio.read_clip(path, 0, 4)
    got = pio.mask_edge_frames(rgb)
    np.testing.assert_array_equal(got, jio.mask_edge_frames(rgb))
    np.testing.assert_array_equal(got, pio.read_clip(path, 0, 4, mask=True))


@pytest.mark.parametrize("frames, nfr", [
    ([24, 24, 24, 24], 8), ([16], 8), ([7, 40, 9], 8), ([33, 16, 50], 16),
    ([], 8), ([5, 3], 8)], ids=str)
def test_window_table_equals_jax(frames, nfr, monkeypatch):
    video, first = pnative.window_table(frames, nfr)
    want_video, want_first = jnative.window_table(frames, nfr)
    np.testing.assert_array_equal(video, want_video)
    np.testing.assert_array_equal(first, want_first)
    # and the JAX package's pure-Python form, whatever library it loaded
    monkeypatch.setattr(jnative, "_load", lambda: None)
    want_video, want_first = jnative.window_table(frames, nfr)
    np.testing.assert_array_equal(video, want_video)
    np.testing.assert_array_equal(first, want_first)
    assert video.dtype == first.dtype == np.int64


def test_window_table_keeps_the_off_by_one_quirk():
    video, first = pnative.window_table([24, 24], 8)
    # index k maps to window k - 1 (clamped): 0 and 1 both start at frame
    # 0, and a video's last window is reached from the boundary index
    assert first[:5].tolist() == [0, 0, 8, 16, 0]
    assert video[:5].tolist() == [0, 0, 0, 0, 1]


@pytest.mark.parametrize("staging", [None, 32], ids=["native", "staged32"])
def test_every_dataset_item_equals_jax(lists, staging):
    mine = pds.MdfVideoDataset(lists[0], nfr=8, staging=staging)
    theirs = jds.MdfVideoDataset(lists[0], nfr=8, staging=staging)
    assert len(mine) == len(theirs) == 12
    assert mine._records == [pds.ClipRecord(r.video_idx, r.first_frame)
                             for r in theirs._records]
    kinds = set()
    for i in range(len(mine)):
        assert mine.is_fake(i) == theirs.is_fake(i)
        kinds.add(mine.is_fake(i))
        for got, want in zip(mine[i], theirs[i]):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    assert kinds == {True, False}
    data, real, mask, label = mine[next(i for i in range(12)
                                        if not mine.is_fake(i))]
    assert real is data and mask.max() == 0 and label.tolist() == [0.0] * 8


def _assert_batches_equal(mine, theirs):
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        assert set(a) == set(b) == set(FIELDS)
        for k in FIELDS:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("workers", [1, 2])
def test_two_epochs_of_batches_equal_jax(lists, workers):
    mine = pds.ClipBatchIterator(
        pds.MdfVideoDataset(lists[0], nfr=8, staging=32), 5, seed=3,
        workers=workers)
    theirs = jds.ClipBatchIterator(
        jds.MdfVideoDataset(lists[0], nfr=8, staging=32), 5, seed=3,
        workers=workers)
    assert len(mine) == len(theirs) == 2            # drop-last: 12 // 5
    epochs = []
    for epoch in (0, 1):
        assert mine.epoch == epoch
        got, want = list(mine), list(theirs)
        _assert_batches_equal(got, want)
        assert got[0]["data"].shape == (5, 8, 32, 32, 3)
        assert got[0]["mask"].shape == (5, 8, 32, 32, 1)
        assert got[0]["label"].shape == (5, 8)
        epochs.append(got)
    assert mine.epoch == 2
    # another order in the second pass
    assert epochs[0][0]["index"].tolist() != epochs[1][0]["index"].tolist()
    # a resume into pass 1 at batch 1
    for it in (mine, theirs):
        it.epoch, it.skip_batches = 1, 1
    tail, want = list(mine), list(theirs)
    _assert_batches_equal(tail, want)
    _assert_batches_equal(tail, epochs[1][1:])
    assert mine.skip_batches == 0 and mine.epoch == 2


def test_iterator_hands_a_decode_error_over_and_handles_an_empty_split():
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == 2:
                raise IOError("cannot decode clip 2")
            z = np.zeros((2, 4, 4, 3), np.uint8)
            return z, z, z[..., :1], np.zeros(2, np.float32)

    it = pds.ClipBatchIterator(Broken(), 1, shuffle=False)
    seen = []
    with pytest.raises(IOError, match="clip 2"):
        for batch in it:
            seen.append(int(batch["index"][0]))
    assert seen == [0, 1]
    short = pds.ClipBatchIterator(Broken(), 5)
    assert len(short) == 0 and list(short) == [] and short.epoch == 1


def test_queue_put_gives_up_when_stopped():
    q = pnative.make_queue(1)
    assert q.put("a") is True
    stop = threading.Event()
    threading.Timer(0.05, stop.set).start()
    t0 = time.perf_counter()
    assert q.put("b", stop_event=stop) is False     # full, then stopped
    assert time.perf_counter() - t0 < 5
    assert q.get() == "a"
    np.testing.assert_array_equal(
        pnative.pack_clips([np.ones((2, 3), np.uint8)] * 2),
        jnative.pack_clips([np.ones((2, 3), np.uint8)] * 2))


def test_synthetic_frames_equal_jax_before_encoding(tmp_path, monkeypatch):
    written = {}
    monkeypatch.setattr(jsyn, "write_video",
                        lambda path, frames: written.__setitem__(
                            path.rsplit("/", 1)[1], frames))
    jsyn.make_clip_dir(str(tmp_path), "c", frames=6, size=40, seed=11)
    fake, orig, mask = psyn.clip_frames(frames=6, size=40, seed=11)
    np.testing.assert_array_equal(fake, written["[Fake]c.mp4"])
    np.testing.assert_array_equal(orig, written["[Original]c.mp4"])
    np.testing.assert_array_equal(mask, written["[Mask]c.mp4"])
    assert not np.array_equal(fake, orig)


def test_make_dataset_writes_the_layout_the_jax_package_reads(tmp_path):
    tr, ts = psyn.make_dataset(str(tmp_path / "mine"), n_train=1, n_test=1,
                               frames=16, size=32, seed=5)
    jtr, _ = jsyn.make_dataset(str(tmp_path / "theirs"), n_train=1, n_test=1,
                               frames=16, size=32, seed=5)
    mine = jds.MdfVideoDataset(tr, nfr=8)           # read by the JAX package
    theirs = pds.MdfVideoDataset(jtr, nfr=8)        # and the other way round
    assert len(mine) == len(theirs) == 4
    for i in range(4):
        for got, want in zip(mine[i], theirs[i]):
            np.testing.assert_array_equal(got, want)
    with open(tr) as f, open(ts) as g:
        assert len(f.read().split()) == len(g.read().split()) == 2
    tr_only, _ = psyn.make_dataset(str(tmp_path / "fakes"), n_train=2,
                                   n_test=1, frames=8, size=32,
                                   include_originals=False)
    with open(tr_only) as f:
        assert all("[Fake]" in ln for ln in f.read().split())


# -- device_prefetch on the CPU ----------------------------------------------

def test_prefetch_preserves_order_and_count():
    batches = [{"x": np.full((4, 3), i, np.float32),
                "index": np.arange(4) + 4 * i} for i in range(7)]
    out = list(device_prefetch(batches, "cpu", depth=3))
    assert len(out) == 7
    for got, want in zip(out, batches):
        assert got is want                      # a CPU target passes through
        moved = to_device(got, torch.device("cpu"))
        assert isinstance(moved["x"], torch.Tensor)
        assert isinstance(moved["index"], np.ndarray)
        np.testing.assert_array_equal(moved["x"].numpy(), want["x"])


def test_prefetch_short_and_empty_iterators():
    assert len(list(device_prefetch([{"x": np.ones((2, 2))}], "cpu",
                                    depth=4))) == 1
    assert list(device_prefetch([], "cpu")) == []


def test_prefetch_passes_device_batches_through():
    it = DeviceSyntheticIterator(2, 8, 16, n_batches=3, seed=1)
    want = [it.batch(0, i) for i in range(3)]
    for got, w in zip(device_prefetch(it, "cpu"), want):
        assert all(torch.equal(got[k], w[k]) for k in w)
    assert prefetch._on_device(want[0], torch.device("cpu"))
    assert not prefetch._on_device({"x": np.ones(2)}, torch.device("cpu"))


def test_staging_thread_keeps_order_hands_errors_over_and_stops():
    """The thread that stages batches ahead for a card, driven here with a
    plain staging function: order, an exception at its place in the order,
    and a consumer that leaves early."""
    def source(n, fail_at=None):
        for i in range(n):
            if i == fail_at:
                raise IOError(f"batch {i}")
            yield i

    stage = lambda b: (b * 10, None)  # noqa: E731
    it = source(6)
    got = list(prefetch._staged_ahead(next(it), it, stage, depth=2))
    assert got == [(i * 10, None) for i in range(6)]

    it = source(6, fail_at=3)
    seen = []
    with pytest.raises(IOError, match="batch 3"):
        for item, _ in prefetch._staged_ahead(next(it), it, stage, depth=2):
            seen.append(item)
    assert seen == [0, 10, 20]

    closed = []

    def closing_source():
        try:
            yield from range(100)
        finally:
            closed.append(True)

    it = closing_source()
    before = threading.active_count()
    staged = prefetch._staged_ahead(next(it), it, stage, depth=2)
    assert next(staged) == (0, None)
    staged.close()                       # the consumer leaves early
    assert closed == [True] and threading.active_count() == before


def test_device_synthetic_iterator_fast_forwards():
    it = DeviceSyntheticIterator(2, 8, 16, n_batches=4, seed=2)
    it.epoch, it.skip_batches = 1, 3
    tail = list(it)
    assert len(tail) == 1 and it.skip_batches == 0 and it.epoch == 2
    assert torch.equal(tail[0]["data"], it.batch(1, 3)["data"])
    it.skip_batches = 9                  # past the end: an empty pass
    assert list(it) == [] and it.epoch == 3
