"""The host runtime ``native/vfd_host.cpp`` bound by the port
(``vfd_gan_tpu_torch/data/native.py``) against its plain Python forms and
the JAX package's binding (``vfd_gan_tpu/data/native.py``), as
``tests/test_native.py`` holds the JAX binding to its fallbacks.

The port builds the library into ``build/vfd_gan_tpu_torch/`` (never the
JAX package's ``native/libvfd_host.so``), and a build that fails raises
with the compiler's message.
"""

import threading
import time

import numpy as np
import pytest

from vfd_gan_tpu.data import native as jnative
from vfd_gan_tpu_torch.data import dataset
from vfd_gan_tpu_torch.data import native


def test_the_library_is_built_in_the_ports_build_dir():
    path = native.build()
    assert path.parent == native.BUILD_DIR
    assert path.parts[-3:-1] == ("build", "vfd_gan_tpu_torch")
    assert path.name.startswith("libvfd_host_") and path.exists()
    assert native.load() is native.load()
    assert native.SOURCE.name == "vfd_host.cpp"
    assert path != native.SOURCE.parent / "libvfd_host.so"


@pytest.mark.parametrize("frames, nfr", [
    ([24, 24, 24, 24], 8), ([16], 8), ([7, 40, 9], 8), ([33, 16, 50], 16),
    ([], 8), ([5, 3], 8), ([0, 96, 17, 8], 8)], ids=str)
def test_window_table_equals_plain_and_jax(frames, nfr, monkeypatch):
    got = native.window_table(frames, nfr)
    plain = native.window_table_plain(frames, nfr)
    jax_lib = jnative.window_table(frames, nfr)
    monkeypatch.setattr(jnative, "_load", lambda: None)
    jax_py = jnative.window_table(frames, nfr)
    for want in (plain, jax_lib, jax_py):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == np.int64


@pytest.mark.parametrize("invert", [False, True])
@pytest.mark.parametrize("k, threads", [(1, None), (5, None), (7, 3)])
def test_pack_clips_equals_plain_and_jax(k, threads, invert, monkeypatch):
    rng = np.random.default_rng(k)
    clips = [rng.integers(0, 256, (4, 12, 12, 3), dtype=np.uint8)
             for _ in range(k)]
    got = native.pack_clips(clips, invert=invert, n_threads=threads)
    np.testing.assert_array_equal(got, native.pack_clips_plain(clips,
                                                               invert))
    np.testing.assert_array_equal(got, jnative.pack_clips(clips, invert))
    monkeypatch.setattr(jnative, "_load", lambda: None)
    np.testing.assert_array_equal(got, jnative.pack_clips(clips, invert))
    assert got.dtype == np.uint8 and got.shape == (k, 4, 12, 12, 3)


def test_pack_clips_refuses_unequal_shapes():
    with pytest.raises(ValueError, match="equal shapes"):
        native.pack_clips([np.zeros((2, 3), np.uint8),
                           np.zeros((3, 2), np.uint8)])


@pytest.mark.parametrize("make", [native.make_queue, native.make_queue_plain,
                                  jnative.make_queue],
                         ids=["port", "plain", "jax"])
def test_queue_hands_over_in_order_and_gives_up_when_stopped(make):
    q = make(2)
    got = []
    consumer = threading.Thread(target=lambda: got.extend(
        q.get() for _ in range(50)))
    consumer.start()
    for i in range(50):
        assert q.put(i) is True
    consumer.join(10)
    assert not consumer.is_alive() and got == list(range(50))
    assert q.put("a") and q.put("b")                 # full now
    stop = threading.Event()
    threading.Timer(0.05, stop.set).start()
    t0 = time.perf_counter()
    assert q.put("c", stop_event=stop) is False
    assert time.perf_counter() - t0 < 5
    assert [q.get(), q.get()] == ["a", "b"]


def test_the_dataset_uses_the_library():
    assert isinstance(native.make_queue(1), native.RingQueue)
    assert dataset.native.make_queue is native.make_queue
    assert dataset.native.pack_clips is native.pack_clips


def test_a_failed_build_raises_with_the_compilers_message(tmp_path,
                                                         monkeypatch):
    broken = tmp_path / "vfd_host.cpp"
    broken.write_text("extern \"C\" int vfd_window_table( {\n")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="building the host runtime "
                                           "failed") as info:
        native.build(broken)
    assert "error" in str(info.value)
    assert not any((tmp_path / "build").glob("*.so"))
    monkeypatch.setenv("CXX", str(tmp_path / "no_such_compiler"))
    with pytest.raises(RuntimeError, match="no_such_compiler did not run"):
        native.build(broken)
