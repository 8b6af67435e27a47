"""``--host_flow``: OpenCV's Farneback on the host in place of the device
flow, against the JAX package's ``train/host_flow.py`` on the CPU.

* ``host_video_to_flow_rgb`` is the JAX function restated in numpy: equal
  bit for bit on the same video, one stream and two.
* One ``_gan_core`` step of an engine built with ``--host_flow``: the flow
  it gives D is, bit for bit, JAX's ``host_video_to_flow_rgb`` of the
  step's own (gt, predicted) mask videos as two streams; and JAX's step on
  those flows, from the same weights, dropout zeroed, matches it at the
  tolerances of ``tests/test_torch_port_train.py``, except that the
  temporal D's train-mode values are held as the spatial D's are there
  (5e-4 relative: measured 2.6e-5 on ``err_g_adv_t``, over 1e-5 absolute;
  OpenCV's flow fields hold large patches of one uint8 level, which
  condition D's BatchNorms worse than the uniform fields of the step
  tests).  JAX's step is not
  given its own host flow: the gray frames are truncated to uint8, so the
  two frameworks' masks, 6e-6 apart, put 2% of the predicted stream's
  flow values on other levels (measured), a step function of the input
  and no error of either side.
* Where cv2 does not import (a PyTorch-only install), the engine exits
  when it is built, naming cv2 and the flag, and does not fall back to the
  device flow.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_train import (
    ATOL,
    B,
    NDF,
    NGF,
    TRAIN_D_RTOL,
    S,
    T,
    _cfg,
    _jax_init,
    _load,
    _np_tree,
    _step_parity,
    _t,
)
from vfd_gan_tpu.models.mygan import DualDisc as JaxDualDisc
from vfd_gan_tpu.models.mygan import Generator as JaxGenerator
from vfd_gan_tpu.train import host_flow as jhost
from vfd_gan_tpu.train.gan_engine import MyGanEngine as JaxEngine
from vfd_gan_tpu.train.state import NetState as JaxNetState
from vfd_gan_tpu.train.state import make_adam
from vfd_gan_tpu_torch.cli import trainer
from vfd_gan_tpu_torch.ops.image import to_channel_first, to_channel_last
from vfd_gan_tpu_torch.train import host_flow
from vfd_gan_tpu_torch.train.gan_engine import MyGanEngine
from vfd_gan_tpu_torch.utils.weights import (
    dualdisc_state_dict,
    generator_state_dict,
)
from test_torch_port_threads import one_torch_thread  # noqa: F401

pytest.importorskip("cv2")


def _video(b: int, seed: int) -> np.ndarray:
    """A moving square over noise, in [-1, 1]."""
    rng = np.random.default_rng(seed)
    v = rng.uniform(-1, -0.6, (b, 6, 40, 40, 3)).astype(np.float32)
    for i in range(b):
        for j in range(6):
            y, x = 5 + 3 * j + i, 8 + 2 * j
            v[i, j, y:y + 12, x:x + 10] = rng.uniform(0.5, 1.0, 3)
    return v


@pytest.mark.parametrize("streams", [1, 2])
def test_host_flow_bit_equal_to_jax(streams):
    v = _video(4, streams)
    got = host_flow.host_video_to_flow_rgb(v, streams)
    want = jhost.host_video_to_flow_rgb(v, streams)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got[0], got[1])      # the flow moved
    # the tensor form copies to the host and back
    out = host_flow.video_to_flow_rgb_host(torch.from_numpy(v), streams)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), want)


def test_host_flow_gan_step_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    data = rng.uniform(-1, 1, (B, T, S, S, 3)).astype(np.float32)
    gt = (rng.uniform(size=(B, T, S, S, 1)) > 0.85).astype(np.float32)
    cfg = _cfg(tmp_path, host_flow=True)
    x = jnp.zeros((B, T, S, S, 3), jnp.float32)
    netg = JaxGenerator(ngf=NGF, dtype=jnp.float32, drop_rate=0.0)
    netd = JaxDualDisc(ndf=NDF, dtype=jnp.float32)
    g_vars, d_vars = _jax_init(netg, x), _jax_init(netd, x, x)

    port = MyGanEngine(cfg, None, None, device=torch.device("cpu"))
    assert port._flow is host_flow.video_to_flow_rgb_host
    _load(port.netg, generator_state_dict(g_vars))
    _load(port.netd, dualdisc_state_dict(d_vars))
    port.netg.drop_rate = 0.0
    calls = []

    def recorded(video, streams=1):
        out = host_flow.video_to_flow_rgb_host(video, streams)
        calls.append((video.numpy().copy(), streams, out.numpy().copy()))
        return out

    port._flow = recorded
    pred = port.netg.train()(to_channel_first(_t(data))).detach()
    _load(port.netg, generator_state_dict(g_vars))      # the stats back
    got = port._gan_core(_t(data), _t(gt))

    (video, streams, flows), = calls
    mask3 = np.repeat(np.concatenate(
        [gt, to_channel_last(pred).numpy()]), 3, -1)
    np.testing.assert_array_equal(video, mask3)
    assert streams == 2
    np.testing.assert_array_equal(
        flows, jhost.host_video_to_flow_rgb(video, streams=2))
    assert np.ptp(flows[:B]) > 0.5 and np.ptp(flows[B:]) > 0.5

    jeng = object.__new__(JaxEngine)
    jeng.cfg, jeng.netg, jeng.netd = cfg, netg, netd
    jeng.tx_g, jeng.tx_d = (make_adam(cfg.lr, cfg.beta1) for _ in range(2))
    jeng._flow = lambda v, streams=1: jnp.asarray(flows)
    g_state, d_state, want, _ = jax.jit(jeng._gan_core)(
        JaxNetState.create(g_vars, jeng.tx_g),
        JaxNetState.create(d_vars, jeng.tx_d), jnp.asarray(data),
        jnp.asarray(gt), jax.random.key(0))
    assert set(got) == set(want)
    for k in want:
        rtol = 0.0 if k == "g/err_g_con/train" else TRAIN_D_RTOL
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol,
                                   atol=ATOL, err_msg=k)
    d_new = dualdisc_state_dict(_np_tree(d_state.variables()))
    _step_parity(port.netg.state_dict(),
                 generator_state_dict(_np_tree(g_state.variables())), "",
                 0.02)
    _step_parity(port.netd.state_dict(), d_new, "tempdisc", 0.02)
    _step_parity(port.netd.state_dict(), d_new, "spatdisc", 0.10)


def test_host_flow_without_cv2_exits_when_the_engine_is_built(
        tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "cv2", None)     # import cv2 fails
    with pytest.raises(SystemExit) as exit_info:
        MyGanEngine(_cfg(tmp_path, host_flow=True), None, None,
                    device=torch.device("cpu"))
    msg = str(exit_info.value)
    assert "--host_flow" in msg and "cv2" in msg
    with pytest.raises(SystemExit, match="--host_flow needs cv2"):
        trainer.build_engine(
            ["--model", "mygan", "--batchsize", "2", "--nfr", "16",
             "--isize", "64", "--ngf", "2", "--ndf", "2", "--host_flow",
             "--synthetic_data", "1", "--device", "cpu",
             "--no-tensorboard", "--result_root", str(tmp_path)])
    # without the flag the engine builds and keeps the device flow
    engine = MyGanEngine(_cfg(tmp_path), None, None,
                         device=torch.device("cpu"))
    assert engine._flow != host_flow.video_to_flow_rgb_host
    engine.close()
