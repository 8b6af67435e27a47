"""The port's optical flow against the JAX package on the CPU.

The same numpy inputs go through ``vfd_gan_tpu.ops.flow`` (its XLA body,
and the Pallas kernels in interpret mode) and ``vfd_gan_tpu_torch.ops``.
On CPU tensors the port's kernel wrappers take their plain PyTorch
versions, which is what these tests hold against JAX; the kernels
themselves are held against the plain versions on the card
(``tests/test_torch_port_cuda.py``, ``chip_smoke.py``).

Tolerances.  Both sides round correlation operands to bfloat16 and sum in
float32 (``CORR_DTYPE``), but in different orders, so a float32 sum that
lands next to a bfloat16 rounding boundary can round the other way: one
bfloat16 step (2^-8 relative) in an intermediate, now and then.  Hence
flows are compared by quantiles in pixels (the precedent:
``tests/test_pallas_flow_fused.py``, q90 < 0.05 px), and the HSV-encoded
video by quantiles, because where the flow is near zero its hue is chaotic
(V is near zero there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from vfd_gan_tpu.ops import flow as jflow
from vfd_gan_tpu.ops import image as jimage
from vfd_gan_tpu.ops import resize as jresize
from vfd_gan_tpu.ops.pallas.flow_fused import flow_refine_fused_pallas
from vfd_gan_tpu.ops.pallas.flow_refine import flow_refine_step_pallas
from vfd_gan_tpu.ops.pallas.warp import bilinear_warp_pallas
from vfd_gan_tpu_torch.ops import corr, flow, flow_fused, flow_refine, warp
from vfd_gan_tpu_torch.ops import image, resize
from test_torch_port_threads import one_torch_thread  # noqa: F401


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def _planar(x) -> torch.Tensor:
    """Channel-last numpy (N, H, W, C) -> planar (N, C, H, W) tensor."""
    return _t(x).permute(0, 3, 1, 2).contiguous()


def _smooth(h, w, seed):
    r = np.random.default_rng(seed)
    img = np.kron(r.normal(size=(h // 4 + 1, w // 4 + 1)),
                  np.ones((4, 4)))[:h, :w]
    img = gaussian_filter(img, 3.0)
    img = (img - img.min()) / (img.max() - img.min() + 1e-9)
    return (img * 255).astype(np.float32)


def _pair(n, h, w, shift=(1, 2), seed=0):
    """Smooth frames and copies translated by ``shift`` = (dx, dy) px."""
    prev = np.stack([_smooth(h, w, seed + i) for i in range(n)])
    cur = np.roll(np.roll(prev, shift[1], axis=1), shift[0], axis=2)
    return prev, cur


def _quantiles(a, b):
    err = np.abs(np.asarray(a) - np.asarray(b))
    return np.quantile(err, [0.5, 0.9, 0.99, 1.0])


@pytest.mark.parametrize("shape", [(3, 32, 40), (2, 24, 24), (1, 16, 64)])
def test_poly_expansion_matches_jax(shape):
    img = np.random.default_rng(1).uniform(0, 255, shape).astype(np.float32)
    want = np.asarray(jflow.poly_expansion(jnp.asarray(img)))
    got = flow.poly_expansion(_t(img)).numpy()
    assert got.shape == want.shape == shape + (5,)
    # float32 sums of bfloat16 operands in another order (module doc):
    # measured ~2e-5 of coefficients up to ~20
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)


@pytest.mark.parametrize("sizes", [((17, 23), (9, 40)), ((64, 64), (32, 32)),
                                   ((8, 8), (16, 12))])
def test_resize_bilinear_matches_jax(sizes):
    (h, w), out = sizes
    x = np.random.default_rng(2).normal(size=(3, h, w, 2)).astype(np.float32)
    want = np.asarray(jresize.resize_bilinear(jnp.asarray(x), out))
    got = resize.resize_bilinear(_t(x), out).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_minmax_normalize_and_gray2rgb_match_jax():
    x = np.random.default_rng(3).normal(size=(2, 4, 6, 5, 3)).astype(
        np.float32)
    for axes in (None, (-2, -1), (1, 3, 4)):
        want = np.asarray(jimage.minmax_normalize(jnp.asarray(x), axes))
        got = image.minmax_normalize(_t(x), axes).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        image.gray2rgb(_t(x[..., :1])).numpy(),
        np.asarray(jimage.gray2rgb(jnp.asarray(x[..., :1]))))


@pytest.mark.parametrize("n", [15, 24, 64])
def test_band_table_is_the_bf16_correlation_matrix(n):
    taps = corr.box_taps(15)
    m = corr.corr_matrix(n, taps, "cpu").numpy()
    band = corr.band_table(n, taps, "cpu").numpy()
    rebuilt = np.zeros_like(m)
    for i in range(n):
        for d in range(15):
            if 0 <= i + d - 7 < n:
                rebuilt[i, i + d - 7] = band[i, d]
    np.testing.assert_array_equal(rebuilt, m)
    # the border entry holds the piled-up taps, rounded once
    pile = np.float32(0.0)
    for _ in range(8):
        pile = np.float32(pile + np.float32(1 / 15))
    assert band[0, 7] == corr.bf16_round(torch.tensor(pile)).item()
    jm = np.asarray(jnp.asarray(jflow._corr_matrix(n, taps),
                                jflow.CORR_DTYPE).astype(jnp.float32))
    np.testing.assert_array_equal(m, jm)


def test_box_blur_stack_matches_jax():
    x = np.random.default_rng(4).normal(size=(2, 20, 28, 5)).astype(
        np.float32)
    want = np.asarray(jflow._box_blur_stack(jnp.asarray(x), 15))
    got = flow._box_blur_stack(_t(x), 15).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _fields_and_flow(n, h, w, scale, seed):
    r = np.random.default_rng(seed)
    fields = r.normal(size=(n, h, w, 5)).astype(np.float32)
    fl = (r.normal(size=(n, h, w, 2)) * scale).astype(np.float32)
    return fields, fl


@pytest.mark.parametrize("scale", [0.7, 6.0, 40.0],
                         ids=["subpixel", "pixels", "off_image"])
def test_plain_warp_equals_jax_xla_warp(scale):
    fields, fl = _fields_and_flow(3, 20, 24, scale, 5)
    want = np.asarray(jflow._bilinear_warp(
        jnp.asarray(fields), jnp.asarray(fl[..., 0]), jnp.asarray(fl[..., 1]),
        use_pallas=False))
    got = warp.bilinear_warp(_planar(fields), _planar(fl))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_plain_warp_matches_pallas_v3_interpret():
    """The TPU kernel casts the planes and its one-hot weights to
    bfloat16: within a few bfloat16 steps of the planes' magnitude."""
    fields, fl = _fields_and_flow(2, 16, 24, 3.0, 6)
    want = np.asarray(bilinear_warp_pallas(
        jnp.asarray(fields), jnp.asarray(fl[..., 0]), jnp.asarray(fl[..., 1]),
        variant="v3", interpret=True))
    got = warp.bilinear_warp(_planar(fields), _planar(fl))
    scale = np.abs(fields).max()
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=scale * 2 ** -6)


def _level_inputs(n, h, w, seed=7):
    prev, cur = _pair(n, h, w, (1, 2), seed)
    both = np.asarray(jflow.poly_expansion(jnp.asarray(
        np.concatenate([prev, cur]))))
    return both[:n], both[n:], np.zeros((n, h, w, 2), np.float32)


def test_flow_level_plain_matches_jax_and_recovers_translation():
    p1, p2, f0 = _level_inputs(2, 32, 40)
    want = np.asarray(jflow._flow_level(jnp.asarray(p1), jnp.asarray(p2),
                                        jnp.asarray(f0), 15, 3))
    got = flow._flow_level(_t(p1), _t(p2), _t(f0), 15, 3).numpy()
    q50, q90, q99, worst = _quantiles(got, want)
    # measured ~1e-7 px: same operands, sums in another order
    assert q90 < 1e-3 and q99 < 1e-2, (q50, q90, q99, worst)
    inner = got[:, 8:-8, 8:-8]
    assert abs(np.median(inner[..., 0]) - 1) < 0.25
    assert abs(np.median(inner[..., 1]) - 2) < 0.25


def test_refine_step_plain_matches_pallas_interpret():
    p1, p2, f0 = _level_inputs(2, 24, 32, seed=8)
    flow0 = np.random.default_rng(9).normal(size=f0.shape).astype(
        np.float32) * 0.5
    w2 = np.asarray(jflow._bilinear_warp(
        jnp.asarray(p2), jnp.asarray(flow0[..., 0]),
        jnp.asarray(flow0[..., 1]), use_pallas=False))
    want = np.asarray(flow_refine_step_pallas(
        jnp.moveaxis(jnp.asarray(p1), -1, 1), jnp.moveaxis(jnp.asarray(w2),
                                                           -1, 1),
        jnp.moveaxis(jnp.asarray(flow0), -1, 1), 15, interpret=True))
    got = flow_refine.flow_refine_step(_planar(p1), _planar(w2),
                                       _planar(flow0), 15).numpy()
    q50, q90, q99, worst = _quantiles(got, want)
    assert q90 < 1e-3 and q99 < 1e-2, (q50, q90, q99, worst)


def test_fused_plain_matches_pallas_fused_interpret():
    """32-row planes: the TPU kernel applies no band clamp there, so only
    its bfloat16 warp operands separate it from the XLA body."""
    p1, p2, f0 = _level_inputs(1, 32, 32, seed=10)
    want = np.asarray(flow_refine_fused_pallas(
        *(jnp.moveaxis(jnp.asarray(a), -1, 1) for a in (p1, p2, f0)), 15, 3,
        interpret=True))
    got = flow_fused.flow_refine_fused(_planar(p1), _planar(p2),
                                       _planar(f0), 15, 3).numpy()
    q50, q90, q99, worst = _quantiles(got, want)
    assert q90 < 0.05, (q50, q90, q99, worst)


def test_every_impl_takes_the_plain_body_on_cpu():
    p1, p2, f0 = (_planar(a) for a in _level_inputs(2, 16, 24, seed=11))
    counts = (warp.bilinear_warp_cuda.launches,
              flow_refine.flow_refine_step_cuda.launches,
              flow_fused.flow_refine_fused_cuda.launches)
    want = flow_fused.flow_refine_fused_plain(p1, p2, f0, 15, 3)
    for impl in flow.IMPLS:
        got = flow._flow_level_planar(p1, p2, f0, 15, 3, impl)
        assert torch.equal(got, want), impl
    assert counts == (warp.bilinear_warp_cuda.launches,
                      flow_refine.flow_refine_step_cuda.launches,
                      flow_fused.flow_refine_fused_cuda.launches)
    with pytest.raises(ValueError, match="impl"):
        flow._flow_level_planar(p1, p2, f0, 15, 3, "xla")


def test_flow_wrappers_refuse_grad_and_cuda_versions_refuse_cpu():
    p1, p2, f0 = (_planar(a) for a in _level_inputs(1, 16, 16, seed=12))
    g = f0.clone().requires_grad_()
    with pytest.raises(ValueError, match="forward-only"):
        warp.bilinear_warp(p2, g)
    with pytest.raises(ValueError, match="forward-only"):
        flow_refine.flow_refine_step(p1, p2, g, 15)
    with pytest.raises(ValueError, match="forward-only"):
        flow_fused.flow_refine_fused(p1, p2, g, 15, 3)
    with pytest.raises(ValueError, match="CUDA"):
        warp.bilinear_warp_cuda(p2, f0)
    with pytest.raises(ValueError, match="CUDA"):
        flow_refine.flow_refine_step_cuda(p1, p2, f0, 15)
    with pytest.raises(ValueError, match="CUDA"):
        flow_fused.flow_refine_fused_cuda(p1, p2, f0, 15, 3)


def test_plain_versions_take_another_winsize_and_match_jax():
    """winsize is a free parameter of the plain versions (and of the JAX
    functions); held at 9 against JAX's XLA body."""
    p1, p2, f0 = _level_inputs(2, 24, 32, seed=13)
    want = np.asarray(jflow._flow_level(jnp.asarray(p1), jnp.asarray(p2),
                                        jnp.asarray(f0), 9, 2))
    planar = [_planar(a) for a in (p1, p2, f0)]
    fused = flow_fused.flow_refine_fused(*planar, 9, 2)
    stepped = planar[2]
    for _ in range(2):
        stepped = flow_refine.flow_refine_step(
            planar[0], warp.bilinear_warp(planar[1], stepped), stepped, 9)
    assert torch.equal(fused, stepped)
    q50, q90, q99, worst = _quantiles(fused.permute(0, 2, 3, 1).numpy(), want)
    assert q90 < 1e-3 and q99 < 1e-2, (q50, q90, q99, worst)
    # and winsize changes the answer: 15 is not silently used
    assert not torch.equal(fused, flow_fused.flow_refine_fused(*planar, 15, 2))


@pytest.mark.parametrize("wrapper, extra", [
    (flow_refine.flow_refine_step_cuda, ()),
    (flow_fused.flow_refine_fused_cuda, (3,)),
], ids=["refine", "fused"])
def test_cuda_solver_wrappers_name_the_winsize_they_refuse(wrapper, extra):
    """The kernels are built for winsize 15: another value is refused
    before anything else, and the message names it."""
    p1, p2, f0 = (_planar(a) for a in _level_inputs(1, 16, 16, seed=14))
    with pytest.raises(ValueError, match=r"winsize 15, got 9"):
        wrapper(p1, p2, f0, 9, *extra)
    for fn in (flow.farneback_flow, flow_refine.flow_refine_step,
               flow_fused.flow_refine_fused, wrapper):
        doc = " ".join(fn.__doc__.split())
        assert "CUDA: 15 only" in doc and "any odd value" in doc, fn.__name__


@pytest.mark.parametrize("size", [(32, 40), (24, 24)])
def test_farneback_flow_matches_jax_and_recovers_translation(size):
    h, w = size
    prev, cur = _pair(3, h, w, (1, 2), seed=13)
    want = np.asarray(jflow.farneback_flow(jnp.asarray(prev),
                                           jnp.asarray(cur)))
    got = flow.farneback_flow(_t(prev), _t(cur)).numpy()
    q50, q90, q99, worst = _quantiles(got, want)
    # measured q90 ~5e-5, q99 ~1e-3 px
    assert q90 < 0.01 and q99 < 0.05, (q50, q90, q99, worst)
    inner = got[:, 6:-6, 6:-6]
    assert abs(np.median(inner[..., 0]) - 1) < 0.3
    assert abs(np.median(inner[..., 1]) - 2) < 0.3


def test_flow_to_rgb_matches_jax():
    fl = np.random.default_rng(14).normal(size=(2, 3, 12, 16, 2)).astype(
        np.float32) * 3
    want = np.asarray(jflow.flow_to_rgb(jnp.asarray(fl)))
    got = flow.flow_to_rgb(_t(fl)).numpy()
    # away from sector boundaries hue, and so RGB, is a float32 function
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _mask_videos(b, t, h, w, seed):
    """gt-like binary squares and prediction-like soft masks, as RGB in
    [-1, 1], gt stream first (the engine's streams=2 batch)."""
    r = np.random.default_rng(seed)
    gt = np.zeros((b, t, h, w), np.float32)
    for i in range(b):
        y, x = r.integers(4, h // 2, 2)
        for f in range(t):
            gt[i, f, y + f // 4:y + f // 4 + h // 3,
               x + f // 3:x + f // 3 + w // 3] = 1.0
    pred = np.stack([gaussian_filter(g, (0, 2, 2)) for g in gt])
    pred = pred * 0.6 + 0.2 + r.normal(size=pred.shape).astype(np.float32) \
        * 0.01
    video = np.concatenate([gt, pred])[..., None]
    return np.repeat(video, 3, axis=-1) * 2.0 - 1.0


def test_video_to_flow_rgb_streams2_scale_half_matches_jax():
    video = _mask_videos(2, 16, 64, 64, 15).astype(np.float32)
    want = np.asarray(jflow.video_to_flow_rgb(jnp.asarray(video), scale=0.5,
                                              streams=2))
    got = flow.video_to_flow_rgb(_t(video), scale=0.5, streams=2).numpy()
    assert got.shape == want.shape == video.shape
    q50, q90, q99, worst = _quantiles(got, want)
    # RGB in [-1, 1]; measured q90 ~3e-3 and q99 ~2e-2 on random videos
    assert q50 < 1e-3 and q90 < 0.02 and q99 < 0.1, (q50, q90, q99, worst)
    assert np.isfinite(got).all()


def test_video_to_flow_rgb_normalises_each_stream_on_its_own():
    """streams=2 is not one joint min-max: the predicted stream, whose
    values span a narrow range, is stretched on its own."""
    video = _mask_videos(2, 16, 32, 32, 16).astype(np.float32)
    two = flow.video_to_flow_rgb(_t(video), scale=0.5, streams=2)
    apart = torch.cat([flow.video_to_flow_rgb(_t(video[:2]), scale=0.5),
                       flow.video_to_flow_rgb(_t(video[2:]), scale=0.5)])
    torch.testing.assert_close(two, apart, rtol=0, atol=1e-5)
    joint = flow.video_to_flow_rgb(_t(video), scale=0.5, streams=1)
    assert (joint[2:] - two[2:]).abs().max() > 0.1
