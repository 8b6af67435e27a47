"""Port ops (``vfd_gan_tpu_torch.ops``) against the JAX functions they port.

Same numpy inputs (``np.random.default_rng``) through both; JAX on the CPU,
the port on CPU tensors, where the opening takes its plain PyTorch version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfd_gan_tpu.ops import convs as jconvs
from vfd_gan_tpu.ops.image import threshold as jthreshold
from vfd_gan_tpu.ops.morphology import VIDEO_PLANES as jVIDEO_PLANES
from vfd_gan_tpu.ops.morphology import morphology_open as jmorphology_open
from vfd_gan_tpu.ops.morphology import video_open as jvideo_open
from vfd_gan_tpu.ops.pallas.morphology import morphology_open_pallas
from vfd_gan_tpu.ops.resize import upsample2x as jupsample2x
from vfd_gan_tpu_torch.ops import convs, morphology
from vfd_gan_tpu_torch.ops.image import threshold
from vfd_gan_tpu_torch.ops.resize import upsample2x
from test_torch_port_threads import one_torch_thread  # noqa: F401

# float32 on both sides, summed in a different order: a few ulps of the
# O(1) outputs at these sizes, well inside 1e-5.
ATOL = 1e-5


def _video(seed, shape):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def _port(fn, *arrays, **kw):
    return fn(*map(torch.from_numpy, arrays), **kw).numpy()


def test_upsample2x_matches_jax():
    x = _video(0, (2, 3, 5, 4, 6))
    np.testing.assert_allclose(_port(upsample2x, x),
                               np.asarray(jupsample2x(jnp.asarray(x))),
                               atol=ATOL)


@pytest.mark.parametrize("window,stride", [
    ((2, 2, 2), None), ((1, 2, 2), None), ((4, 1, 1), (1, 1, 1))])
def test_avg_pool3d_matches_jax(window, stride):
    x = _video(1, (2, 4, 6, 8, 5))
    np.testing.assert_allclose(
        _port(convs.avg_pool3d, x, window=window, stride=stride),
        np.asarray(jconvs.avg_pool3d(jnp.asarray(x), window, stride)),
        atol=ATOL)


@pytest.mark.parametrize("stride,padding", [
    (1, "SAME"), (2, 1), (1, [(1, 1), (1, 1)]), (2, "SAME"), (1, "VALID")])
def test_spatial_conv_matches_jax(stride, padding):
    x = _video(2, (2, 3, 9, 8, 4))
    k = _video(3, (3, 3, 4, 6)) * 0.3
    got = _port(convs.spatial_conv, x, k, stride=stride, padding=padding)
    want = jconvs.spatial_conv(jnp.asarray(x), jnp.asarray(k), stride=stride,
                               padding=padding)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("stride,padding", [
    (1, 1), (1, "SAME"), (2, 1), (1, 0), (2, "SAME")])
def test_temporal_conv_matches_jax(stride, padding):
    x = _video(4, (2, 7, 3, 4, 5))
    k = _video(5, (3, 5, 6)) * 0.3
    got = _port(convs.temporal_conv, x, k, stride=stride, padding=padding)
    want = jconvs.temporal_conv(jnp.asarray(x), jnp.asarray(k),
                                stride=stride, padding=padding)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("stride,padding", [
    ((1, 1, 1), ((1, 1), (1, 1), (1, 1))), ((1, 2, 2), 1),
    ((1, 1, 1), ((0, 2), (1, 1), (2, 0)))])
def test_conv3d_matches_jax(stride, padding):
    x = _video(6, (2, 4, 6, 6, 5))
    k = _video(7, (3, 3, 3, 5, 2)) * 0.2
    got = _port(convs.conv3d, x, k, stride=stride, padding=padding)
    want = jconvs.conv3d(jnp.asarray(x), jnp.asarray(k), stride=stride,
                         padding=padding)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("shape", [(3, 3, 3, 3, 32), (3, 3, 3, 96, 32),
                                   (3, 3, 3, 512, 256), (3, 1, 1, 7, 9)])
def test_r2plus1d_mid_channels_matches_jax(shape):
    assert convs.r2plus1d_mid_channels(*shape) == \
        jconvs.r2plus1d_mid_channels(*shape)


def test_threshold_matches_jax_and_keeps_dtype():
    x = np.random.default_rng(8).uniform(0, 1, (2, 4, 5, 5, 1)).astype(
        np.float32)
    x[0, 0, 0, :3, 0] = [0.5, np.nextafter(0.5, 1), np.nextafter(0.5, 0)]
    got = threshold(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jthreshold(jnp.asarray(x))))
    assert threshold(torch.from_numpy(x).double()).dtype == torch.float64


def _mask_video(seed, shape, binary):
    x = np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)
    return (x > 0.5).astype(np.float32) if binary else x


# Min and max are exact, so the opening must agree bit for bit.
@pytest.mark.parametrize("binary", [True, False], ids=["binary", "float"])
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("plane", ["th", "hw"])
@pytest.mark.parametrize("shape", [(2, 8, 12, 10, 1), (1, 13, 37, 3, 1)],
                         ids=["small", "ragged13x37"])
def test_video_open_equals_jax_and_pallas(shape, plane, k, binary):
    x = _mask_video(9, shape, binary)
    got = morphology.video_open(torch.from_numpy(x), plane, k).numpy()
    want = np.asarray(jvideo_open(jnp.asarray(x), plane, k,
                                  use_pallas=False))
    np.testing.assert_array_equal(got, want)
    # the Pallas kernel in interpret mode, reached as on a TPU
    pallas = jmorphology_open(jnp.asarray(x), k, jVIDEO_PLANES[plane],
                              use_pallas=True, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas))


def test_open_planes_plain_equals_pallas_on_a_ragged_plane():
    x = _mask_video(10, (3, 13, 37), binary=True)
    got = morphology.open_planes(torch.from_numpy(x), 5).numpy()
    want = np.asarray(morphology_open_pallas(jnp.asarray(x), k=5,
                                             interpret=True))
    np.testing.assert_array_equal(got, want)


def test_morphology_open_keeps_input_dtype():
    x = torch.from_numpy(_mask_video(11, (1, 6, 7, 8, 1), binary=False))
    got = morphology.video_open(x.to(torch.float16), "hw")
    assert got.dtype == torch.float16
    want = morphology.video_open(x.to(torch.float16).float(), "hw")
    torch.testing.assert_close(got.float(), want, atol=0, rtol=0)


# The route a CUDA video takes, as far as the CPU reaches it: the result is
# contiguous in the video's own layout, for channels, ragged sizes and
# float16 alike, and equals JAX (min and max are exact in either dtype).
@pytest.mark.parametrize("dtype", [np.float32, np.float16],
                         ids=["float32", "float16"])
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("plane", ["th", "hw"])
@pytest.mark.parametrize("shape", [(2, 8, 12, 10, 3), (1, 13, 37, 5, 3),
                                   (1, 7, 9, 11, 1)],
                         ids=["c3", "ragged_c3", "ragged_c1"])
def test_video_open_is_contiguous_and_equals_jax(shape, plane, k, dtype):
    x = _mask_video(12, shape, binary=False).astype(dtype)
    got = morphology.video_open(torch.from_numpy(x), plane, k)
    assert got.is_contiguous() and tuple(got.shape) == shape
    assert got.numpy().dtype == dtype
    want = jvideo_open(jnp.asarray(x), plane, k, use_pallas=False)
    assert want.dtype == dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if dtype == np.float32:
        pallas = jmorphology_open(jnp.asarray(x), k, jVIDEO_PLANES[plane],
                                  use_pallas=True, interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    # a view in another memory order (NCDHW, as a model returns it) opens
    # to the same contiguous channel-last result
    view = torch.from_numpy(x).permute(0, 4, 1, 2, 3).contiguous().permute(
        0, 2, 3, 4, 1)
    again = morphology.video_open(view, plane, k)
    assert again.is_contiguous() and torch.equal(again, got)


def _open_by_layout(x, axes, k):
    """What the kernel is asked to do, in plain PyTorch: open the (O, P, Q,
    L) view that ``_layout`` describes and write it through the contiguous
    result's own layout."""
    sizes, strides = morphology._layout(x, axes)
    out = torch.empty(x.shape, dtype=x.dtype)
    _, out_strides = morphology._layout(out, axes)
    view = x.as_strided(sizes, strides, x.storage_offset())
    o, p, q, lanes = sizes
    planes = view.permute(0, 3, 1, 2).reshape(o * lanes, p, q)
    opened = morphology.open_planes_plain(planes, k).reshape(
        o, lanes, p, q).permute(0, 2, 3, 1)
    out.as_strided(sizes, out_strides).copy_(opened)
    return out


@pytest.mark.parametrize("case", ["th", "hw", "hw_c3", "planes", "ncdhw_view",
                                  "transposed", "sliced", "swapped_axes"])
def test_layout_walks_the_video_in_place(case):
    """The strides handed to the kernel describe the video's own memory:
    opening the strided four-axis view and writing through the result's
    strides equals ``morphology_open``."""
    x5 = torch.from_numpy(_mask_video(13, (2, 6, 9, 7, 3), binary=False))
    x3 = torch.from_numpy(_mask_video(14, (3, 8, 10), binary=False))
    x, axes = {
        "th": (x5[..., :1].contiguous(), (1, 2)),
        "hw": (x5[..., :1].contiguous(), (2, 3)),
        "hw_c3": (x5, (2, 3)),
        "planes": (x3, (1, 2)),
        # a model's (B, 1, T, H, W) mask seen channel-last
        "ncdhw_view": (x5[..., :1].permute(0, 4, 1, 2, 3).contiguous()
                       .permute(0, 2, 3, 4, 1), (1, 2)),
        "transposed": (x3.transpose(1, 2), (1, 2)),
        "sliced": (x3[:, ::2, 1::3], (1, 2)),
        "swapped_axes": (x5, (3, 2)),
    }[case]
    got = _open_by_layout(x, axes, 5)
    assert got.is_contiguous()
    assert torch.equal(got, morphology.morphology_open(x, 5, axes))


def test_layout_refuses_what_no_four_strides_describe():
    x = torch.zeros(2, 4, 6, 8, 3)
    assert morphology._layout(x, (1, 3)) is None        # not neighbours
    assert morphology._layout(x[:, :, :, ::2], (1, 2)) is None   # lanes
    assert morphology._layout(x.permute(1, 0, 2, 3, 4)[:, :, ::2],
                              (3, 4)) is None           # outer axes
    # axes of size 1 carry any stride
    sizes, strides = morphology._layout(x[:, :1, :, :, :1], (2, 3))
    assert sizes == (2, 6, 8, 1) and strides[1:3] == (24, 3)
    # and the CPU route still opens a plane of axes that are no neighbours
    y = torch.from_numpy(_mask_video(15, (2, 5, 6, 7, 1), binary=True))
    want = np.asarray(jmorphology_open(jnp.asarray(y.numpy()), 3, (1, 3),
                                       use_pallas=False))
    got = morphology.morphology_open(y, 3, (1, 3))
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


def test_video_planes_match_jax():
    assert morphology.VIDEO_PLANES == jVIDEO_PLANES


def test_open_planes_dispatches_on_device_and_never_falls_back():
    x = torch.zeros(2, 4, 4)
    before = morphology.open_planes_cuda.launches
    morphology.open_planes(x, 5)                 # CPU: plain, no launch
    assert morphology.open_planes_cuda.launches == before
    with pytest.raises(ValueError, match="no opening for device"):
        morphology.open_planes(torch.zeros(2, 4, 4, device="meta"), 5)
    # the CUDA wrapper refuses a CPU tensor instead of computing it
    with pytest.raises(ValueError, match="CUDA tensor"):
        morphology.open_planes_cuda(x, 5)
    with pytest.raises(ValueError, match="CUDA tensor"):
        morphology.open_planes_cuda(x[None, ..., None], 5, (1, 2))
