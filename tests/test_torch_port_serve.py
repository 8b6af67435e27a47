"""The port's serving slice: its InferenceServer against the JAX one, the
infer post-processing against JAX, and the HTTP and CLI surfaces.

Every HTTP server binds port 0, every call has a timeout and every server
is closed in ``finally``.
"""

import base64
import functools
import json
import os
import socket
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfd_gan_tpu.cli.serve import InferenceServer as JaxInferenceServer
from vfd_gan_tpu.models.mygan import Generator as JaxGenerator
from vfd_gan_tpu.ops.image import threshold as jthreshold
from vfd_gan_tpu.ops.morphology import video_open as jvideo_open
from vfd_gan_tpu_torch.cli import infer
from vfd_gan_tpu_torch.cli.serve import (
    InferenceServer,
    OverloadedError,
    build_parser,
    make_handler,
    serve,
)
from vfd_gan_tpu_torch.models.mygan import Generator
from vfd_gan_tpu_torch.ops.image import to_channel_first, to_channel_last
from vfd_gan_tpu_torch.utils.weights import generator_state_dict
from test_torch_port_threads import one_torch_thread  # noqa: F401

NGF, T, S = 4, 16, 16
TIMEOUT = 30
# float32 generator forward, XLA vs PyTorch CPU summation order (see
# test_torch_port_generator.py)
MASK_ATOL = 2e-5


@functools.lru_cache(maxsize=None)
def _jax_variables():
    """JAX Generator(ngf=4) weights with random positive BN statistics and
    a wider zero-mean head, so that the mask crosses 0.5 (at init it sits
    just above it everywhere)."""
    model = JaxGenerator(ngf=NGF)
    v = jax.jit(model.init, static_argnums=2)(
        jax.random.key(0), jnp.zeros((1, T, S, S, 3)), False)
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(-0.3, 0.3, a.shape) if p[-1].key == "mean"
                      else rng.uniform(0.3, 2.0, a.shape)).astype(np.float32),
        v["batch_stats"])
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    head = rng.normal(0, 0.5, params["head_kernel"].shape).astype(np.float32)
    params["head_kernel"] = head - head.mean()
    return {"params": params, "batch_stats": stats}


def _port_model():
    model = Generator(ngf=NGF)
    model.load_state_dict(
        {k: torch.from_numpy(np.array(a))
         for k, a in generator_state_dict(_jax_variables()).items()},
        strict=True)
    return model.eval()


def _clips(seed, k):
    return np.random.default_rng(seed).uniform(
        -1, 1, (k, T, S, S, 3)).astype(np.float32)


def _server(max_batch=2, max_wait_ms=5.0, **kw):
    return InferenceServer(_port_model(), "port", isize=S, nfr=T,
                           max_batch=max_batch, max_wait_ms=max_wait_ms, **kw)


def _start_http(srv, **kw):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(srv, **kw))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _post(url, body, headers=None):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers=headers or {})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return json.loads(r.read())


def _status(fn):
    try:
        fn()
    except urllib.error.HTTPError as e:
        return e.code
    return 200


def test_port_server_matches_jax_server():
    """max_batch=2 and a 3-clip request: one full and one zero-padded
    forward on each side."""
    jax_srv = JaxInferenceServer(
        JaxGenerator(ngf=NGF), jax.tree_util.tree_map(jnp.asarray,
                                                      _jax_variables()),
        "jax", isize=S, nfr=T, max_batch=2, max_wait_ms=5.0)
    srv = _server()
    try:
        clips = _clips(1, 3)
        want = jax_srv.predict(clips, timeout=TIMEOUT)
        got = srv.predict(clips, timeout=TIMEOUT)
        assert got.shape == want.shape == (3, T, S, S, 1)
        np.testing.assert_allclose(got, want, atol=MASK_ATOL, rtol=0)
        # padding must not leak into real rows: the same clips unpadded
        with torch.inference_mode():
            direct = to_channel_last(srv.model(to_channel_first(
                torch.from_numpy(clips)))).numpy()
        np.testing.assert_allclose(got, direct, atol=1e-6, rtol=0)
        assert srv.stats()["clips"] == 3 and srv.stats()["batches"] == 1
    finally:
        jax_srv.close()
        srv.close()


@pytest.mark.parametrize("plane", ["th", "hw"])
def test_postprocess_of_jax_pred_equals_jax(plane):
    """The port's infer post-processing on the JAX Generator's own
    prediction: threshold and opening are exact, so bit for bit."""
    model = JaxGenerator(ngf=NGF)
    pred = np.asarray(jax.jit(lambda v, x: model.apply(v, x, False))(
        _jax_variables(), _clips(2, 2)))
    assert 0 < (pred > 0.5).mean() < 1
    want = np.asarray(jvideo_open(jthreshold(jnp.asarray(pred)), plane))
    got = infer.postprocess(torch.from_numpy(pred.copy()), plane).numpy()
    np.testing.assert_array_equal(got, want)


def test_predict_clips_scales_uint8_like_the_jax_infer():
    model = _port_model()
    frames = np.random.default_rng(3).integers(0, 256, (2, T, S, S, 3),
                                               dtype=np.uint8)
    pred, opened, scores = infer.predict_clips(model, frames, "th")
    x = frames.astype(np.float32) / 255.0 * 2.0 - 1.0       # cli/infer.py
    with torch.inference_mode():
        want = to_channel_last(model(to_channel_first(torch.from_numpy(x))))
    assert torch.equal(pred, want)
    assert torch.equal(opened, infer.postprocess(pred, "th"))
    torch.testing.assert_close(scores, pred[..., 0].mean(dim=(2, 3)))


def test_concurrent_requests_share_a_batch_and_poison_is_isolated():
    srv = _server(max_batch=8, max_wait_ms=200.0)
    try:
        outs = {}

        def worker(i):
            outs[i] = srv.predict(_clips(10 + i, 1), timeout=TIMEOUT)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in threads)
        assert len(outs) == 4 and srv.stats()["batches"] <= 3

        with pytest.raises(RuntimeError, match="inference failed"):
            srv.predict(np.zeros((1, T, S, S, 4), np.float32),
                        timeout=TIMEOUT)
        assert srv.predict(_clips(20, 1), timeout=TIMEOUT).shape == \
            (1, T, S, S, 1)
    finally:
        srv.close()


def test_http_predict_stream_healthz_stats():
    srv = _server()
    httpd, base = _start_http(srv)
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=TIMEOUT) as r:
            h = json.loads(r.read())
        assert h["ok"] and h["nfr"] == T and h["isize"] == S

        one = _clips(4, 1)
        out = _post(f"{base}/predict", one.tobytes())
        want = srv.predict(one, timeout=TIMEOUT)
        np.testing.assert_allclose(
            out["frame_scores"], want[..., 0].reshape(1, T, -1).mean(axis=2),
            atol=1e-6)

        three = _clips(5, 3)
        out = _post(f"{base}/predict?mask=1", three.tobytes(),
                    {"X-Clip-Count": "3"})
        assert out["clip_count"] == 3 and out["mask_shape"] == [3, T, S, S]
        mask = np.frombuffer(base64.b64decode(out["mask_u8_b64"]), np.uint8)
        pred = srv.predict(three, timeout=TIMEOUT)[..., 0]
        np.testing.assert_array_equal(
            mask.reshape(3, T, S, S),
            (np.clip(pred, 0, 1) * 255).astype(np.uint8))

        assert _status(lambda: _post(f"{base}/predict", b"123")) == 400
        assert _status(lambda: _post(f"{base}/predict", one.tobytes(),
                                     {"X-Clip-Count": "0"})) == 400

        # streaming: two clips trickled over a raw socket, NDJSON lines back
        two = _clips(6, 2)
        body = two.tobytes()
        with socket.create_connection(httpd.server_address,
                                      timeout=TIMEOUT) as sk:
            sk.sendall((f"POST /predict_stream HTTP/1.0\r\n"
                        f"Content-Length: {len(body)}\r\n\r\n").encode())
            half = len(body) // 2
            sk.sendall(body[:half])
            sk.sendall(body[half:])
            raw = b""
            while chunk := sk.recv(65536):
                raw += chunk
        head, _, payload = raw.partition(b"\r\n\r\n")
        assert b"200" in head.split(b"\r\n")[0]
        lines = [json.loads(ln) for ln in payload.splitlines() if ln]
        assert [ln["clip"] for ln in lines] == [0, 1]
        want = srv.predict(two, timeout=TIMEOUT)[..., 0].reshape(
            2, T, -1).mean(axis=2)
        np.testing.assert_allclose([ln["frame_scores"] for ln in lines],
                                   want, atol=1e-6)

        with urllib.request.urlopen(f"{base}/stats", timeout=TIMEOUT) as r:
            st = json.loads(r.read())
        assert st["clips"] >= 8 and st["device"] == "cpu"
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()


def test_http_bearer_token_and_load_shedding():
    srv = _server(max_queued_clips=2)
    httpd, base = _start_http(srv, auth_token="s3cret")
    auth = {"Authorization": "Bearer s3cret"}
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=TIMEOUT) as r:
            assert json.loads(r.read())["ok"]              # always open
        assert _status(lambda: urllib.request.urlopen(
            f"{base}/stats", timeout=TIMEOUT)) == 401
        one = _clips(7, 1).tobytes()
        assert _status(lambda: _post(f"{base}/predict", one)) == 401
        assert _status(lambda: _post(f"{base}/predict", one,
                                     {"Authorization": "Bearer nope"})) == 401
        assert "frame_scores" in _post(f"{base}/predict", one, auth)

        # 3 clips > the admission bound of 2: shed at once with a 429
        three = _clips(8, 3).tobytes()
        assert _status(lambda: _post(
            f"{base}/predict", three, {**auth, "X-Clip-Count": "3"})) == 429
        assert srv.stats()["shed_requests"] == 1
        with pytest.raises(OverloadedError):
            srv.predict(_clips(9, 3), timeout=TIMEOUT)
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()


def test_http_predict_video_is_jailed(tmp_path):
    from vfd_gan_tpu.data.video_io import write_video

    vid = str(tmp_path / "clip.mp4")
    write_video(vid, np.random.default_rng(11).integers(
        0, 255, (2 * T + 1, S, S, 3), dtype=np.uint8))
    srv = _server()
    httpd, base = _start_http(srv, video_root=str(tmp_path))
    closed, closed_base = _start_http(srv)
    post = lambda b, p: _post(f"{b}/predict_video",  # noqa: E731
                              json.dumps({"video_path": p}).encode())
    try:
        out = post(base, "clip.mp4")
        assert out["clip_count"] == 2 and len(out["frame_scores"]) == 2 * T
        assert _status(lambda: post(base, "nope.mp4")) == 404
        for evil in ("../../../etc/passwd", "/etc/passwd", "a/../../x.mp4"):
            assert _status(lambda: post(base, evil)) == 403, evil
        assert _status(lambda: post(closed_base, "clip.mp4")) == 403
    finally:
        for h in (httpd, closed):
            h.shutdown()
            h.server_close()
        srv.close()


def _save_pth(tmp_path, name="run_netG.pth"):
    path = str(tmp_path / name)
    torch.save({"epoch": 0, "state_dict": _port_model().state_dict()}, path)
    return path


def _args(path, *extra):
    return build_parser().parse_args(
        ["--ckpt", path, "--port", "0", "--isize", str(S), "--nfr", str(T),
         "--max_batch", "2", "--device", "cpu", *extra])


def test_serve_args_from_pth(tmp_path):
    httpd = serve(_args(_save_pth(tmp_path)))
    try:
        srv = httpd.inference
        assert srv.name == "Propose model[GAN]" and not srv.model.training
        clips = _clips(12, 1)
        want = _port_model()(to_channel_first(torch.from_numpy(clips)))
        np.testing.assert_allclose(
            srv.predict(clips, timeout=TIMEOUT),
            to_channel_last(want).detach().numpy(), atol=1e-6)
    finally:
        httpd.inference.close()
        httpd.server_close()


@pytest.mark.parametrize("flag,value", [("--dp", "2"), ("--quant", "int8")])
def test_serve_refuses_unported_options(tmp_path, flag, value):
    if flag == "--dp":
        # ported since: two replicas on the CPU serve the one-replica
        # predictions (test_serve_dp_replicas_equal_one_replica)
        httpd = serve(_args(_save_pth(tmp_path), flag, value))
        try:
            srv = httpd.inference
            assert len(srv.replicas) == 2 and srv.replicas[0] is srv.model
            clips = _clips(12, 2)
            want = to_channel_last(_port_model()(to_channel_first(
                torch.from_numpy(clips)))).detach().numpy()
            np.testing.assert_allclose(srv.predict(clips, timeout=TIMEOUT),
                                       want, atol=1e-6)
        finally:
            httpd.inference.close()
            httpd.server_close()
        return
    # ported since: the int8 forward is served (quant/qmygan.py), and
    # tracks the float model as the JAX int8 server does
    # (tests/test_quant.py: mean error below 0.02)
    httpd = serve(_args(_save_pth(tmp_path), flag, value,
                        "--calib_clips", "2"))
    try:
        srv = httpd.inference
        assert srv.name == "Propose model[GAN] [int8]"
        assert type(srv.model).__name__ == "Int8Model"
        clips = _clips(12, 2)
        got = srv.predict(clips, timeout=TIMEOUT)
        with torch.no_grad():
            want = to_channel_last(_port_model().eval()(
                to_channel_first(torch.from_numpy(clips)))).numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).mean() < 0.02
    finally:
        httpd.inference.close()
        httpd.server_close()


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_serve_dp_replicas_equal_one_replica(tmp_path, quant):
    """``--dp 2 --device cpu``: two replicas, each batch split into two
    row slices; the predictions are ``--dp 1``'s within 1e-6 (under
    ``--quant int8`` too: the int8 model copied), over HTTP as well, and
    ``/stats`` counts the replicas and times each."""
    extra = ("--quant", "int8", "--calib_clips", "2") if quant == "int8" \
        else ()
    one = serve(_args(_save_pth(tmp_path), "--max_batch", "4", *extra))
    two = serve(_args(_save_pth(tmp_path), "--max_batch", "4", "--dp", "2",
                      *extra))
    http, base = _start_http(two.inference)
    try:
        assert [str(d) for d in two.inference.devices] == ["cpu", "cpu"]
        if quant == "int8":
            assert type(two.inference.replicas[1]).__name__ == "Int8Model"
        clips = _clips(13, 3)
        want = one.inference.predict(clips, timeout=TIMEOUT)
        got = two.inference.predict(clips, timeout=TIMEOUT)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        out = _post(f"{base}/predict", clips.tobytes(),
                    {"X-Clip-Count": "3"})
        np.testing.assert_allclose(
            out["frame_scores"],
            want[..., 0].reshape(3, T, -1).mean(axis=2), atol=1e-6)
        with urllib.request.urlopen(f"{base}/stats", timeout=TIMEOUT) as r:
            stats = json.loads(r.read())
        assert stats["replicas"] == 2
        assert len(stats["replica_forward_ms"]) == 2
        assert all(ms > 0 for ms in stats["replica_forward_ms"])
        assert one.inference.stats()["replicas"] == 1
    finally:
        http.shutdown()
        http.server_close()
        for h in (one, two):
            h.inference.close()
            h.server_close()


def test_serve_dp_exits_name_their_reasons(tmp_path):
    """JAX's words for a batch that does not split over the replicas, and
    the visible count for more replicas than cards; never fewer replicas
    than asked."""
    with pytest.raises(SystemExit,
                       match=r"--max_batch 3 must be divisible by dp=2"):
        serve(_args(_save_pth(tmp_path), "--max_batch", "3", "--dp", "2"))
    from vfd_gan_tpu_torch.cli.serve import replica_devices

    cards = torch.cuda.device_count()
    with pytest.raises(SystemExit,
                       match=rf"--dp {cards + 1}: only {cards} CUDA"):
        replica_devices(torch.device("cuda"), cards + 1)
    with pytest.raises(SystemExit, match="must be >= 1"):
        replica_devices(torch.device("cpu"), 0)
    assert replica_devices(torch.device("cpu"), 3) == [torch.device("cpu")] * 3


def test_serve_dtype_bfloat16_matches_the_jax_bf16_server(tmp_path):
    """``--dtype bfloat16``: the checkpoint's float32 parameters, the
    model computing in bfloat16, `` [bf16]`` in its name, as the JAX
    server rebuilds its module (cli/serve.py:539-544); float32 clips in,
    float32 masks out.  Held to JAX's bf16 server within 2^-7 relative on
    99.9% of the mask's elements (tests/test_torch_port_bf16.py)."""
    httpd = serve(_args(_save_pth(tmp_path), "--dtype", "bfloat16"))
    jax_srv = JaxInferenceServer(
        JaxGenerator(ngf=NGF, dtype=jnp.bfloat16),
        jax.tree_util.tree_map(jnp.asarray, _jax_variables()), "jax",
        isize=S, nfr=T, max_batch=2, max_wait_ms=5.0)
    try:
        srv = httpd.inference
        assert srv.name == "Propose model[GAN] [bf16]"
        assert srv.model.dconv1.bn.dtype == torch.bfloat16
        assert all(p.dtype == torch.float32 for p in srv.model.parameters())
        clips = _clips(12, 3)
        got = srv.predict(clips, timeout=TIMEOUT)
        want = jax_srv.predict(clips, timeout=TIMEOUT)
        assert got.dtype == np.float32 and got.shape == want.shape
        err = np.abs(got - want)
        assert (err > 2.0 ** -7 * np.abs(want)).mean() <= 1e-3, err.max()
        with torch.inference_mode():
            direct = to_channel_last(srv.model(to_channel_first(
                torch.from_numpy(clips)))).numpy()
        np.testing.assert_allclose(got, direct, atol=1e-6, rtol=0)
    finally:
        jax_srv.close()
        httpd.inference.close()
        httpd.server_close()


def test_cuda_device_never_falls_back_to_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda is valid here")
    args = _args(_save_pth(tmp_path), "--device", "cuda")
    with pytest.raises(SystemExit, match="CUDA is not available"):
        serve(args)


def test_load_dispatch_rules(tmp_path):
    from vfd_gan_tpu_torch.models.stcnn import AutoEncoder

    cpu = torch.device("cpu")
    model, name = infer._load(_save_pth(tmp_path, "x_ganbase.pth"), cpu)
    assert isinstance(model, Generator) and not model.training
    assert name == "Propose model[GAN]"
    with pytest.raises(SystemExit, match="export_torch"):
        infer._load(str(tmp_path), cpu)
    # a supervised family's name loads that family (strict: a Generator's
    # weights under it are refused, an AutoEncoder's load)
    with pytest.raises(RuntimeError, match="Missing key"):
        infer._load(_save_pth(tmp_path, "run_c2plus1d.pth"), cpu)
    path = str(tmp_path / "roc_c2plus1d.pth")
    torch.save({"epoch": 0, "state_dict": AutoEncoder(
        generator=torch.Generator().manual_seed(0)).state_dict()}, path)
    model, name = infer._load(path, cpu)
    assert isinstance(model, AutoEncoder) and not model.training
    assert name == "(2+1)DCNN"
    with pytest.raises(SystemExit, match="cannot infer model type"):
        infer._load(str(tmp_path / "weights.pth"), cpu)


def test_infer_main_writes_mask_overlay_scores(tmp_path):
    from vfd_gan_tpu.data.video_io import read_clip, write_video

    vid = str(tmp_path / "in.mp4")
    write_video(vid, np.random.default_rng(13).integers(
        0, 255, (2 * T, S, S, 3), dtype=np.uint8))
    out = str(tmp_path / "out")
    path = _save_pth(tmp_path)
    infer.main(["--video", vid, "--ckpt", path, "--out", out,
                "--isize", str(S), "--nfr", str(T), "--device", "cpu"])
    assert {"mask.mp4", "overlay.mp4", "scores.csv"} <= set(os.listdir(out))
    with open(os.path.join(out, "scores.csv")) as f:
        rows = f.read().splitlines()
    assert rows[0] == "frame,mean_mask_score" and len(rows) == 1 + 2 * T
    frames = read_clip(vid, T, T, resize_to=(S, S))
    _, _, scores = infer.predict_clips(_port_model(), frames[None])
    np.testing.assert_allclose([float(r.split(",")[1]) for r in rows[1 + T:]],
                               scores[0].numpy(), atol=1e-6)


def test_infer_main_dtype_bfloat16(tmp_path):
    """``infer --dtype bfloat16`` (JAX cli/infer.py:53-57, 97-98): the
    model computes in bfloat16 from the float32 checkpoint; its scores are
    those of ``predict_clips`` on that model, and near the float32 run's."""
    from vfd_gan_tpu.data.video_io import read_clip, write_video

    vid = str(tmp_path / "in.mp4")
    write_video(vid, np.random.default_rng(14).integers(
        0, 255, (T, S, S, 3), dtype=np.uint8))
    path = _save_pth(tmp_path)
    rows = {}
    for dtype in ("float32", "bfloat16"):
        out = str(tmp_path / dtype)
        infer.main(["--video", vid, "--ckpt", path, "--out", out, "--isize",
                    str(S), "--nfr", str(T), "--dtype", dtype, "--device",
                    "cpu"])
        with open(os.path.join(out, "scores.csv")) as f:
            rows[dtype] = np.array([float(r.split(",")[1])
                                    for r in f.read().splitlines()[1:]])
    model, name = infer._load(path, torch.device("cpu"), torch.bfloat16)
    assert name == "Propose model[GAN] [bf16]"
    frames = read_clip(vid, 0, T, resize_to=(S, S))
    _, _, scores = infer.predict_clips(model, frames[None])
    np.testing.assert_allclose(rows["bfloat16"], scores[0].numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(rows["bfloat16"], rows["float32"], atol=2e-2)
