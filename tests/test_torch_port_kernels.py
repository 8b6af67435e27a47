"""The plain versions of the port's augment gather and 3x3 conv against
the JAX package's Pallas kernels (in interpret mode) on the CPU.

* ``conv3x3``: the port's function (``F.conv2d`` forward; dx through the
  same forward with flipped, transposed weights; dw as tap products)
  against ``conv3x3_pallas(x, w, interpret=True)`` and its custom VJP, and
  against ``lax.conv_general_dilated``.  Unit-normal x, w x 0.1, as
  ``tests/test_pallas_spatial_conv.py`` uses; forward within 1e-5, x and w
  gradients within 1e-4 (float32 sums in another order).  W is a multiple
  of 8, as the Mosaic kernel needs.
* the augment gather: bit-exact against ``augment_gather_pallas`` (scaled
  as the JAX function scales) and against ``augment_clips(use_pallas=True,
  interpret=True)`` with the same draws injected into both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from vfd_gan_tpu.ops import augment as jaug
from vfd_gan_tpu.ops.pallas.augment import augment_gather_pallas
from vfd_gan_tpu.ops.pallas.spatial_conv import conv3x3_pallas
from vfd_gan_tpu_torch.ops import augment
from vfd_gan_tpu_torch.ops.spatial_conv import conv3x3, conv3x3_plain

FWD_TOL = 1e-5
GRAD_TOL = 1e-4

# (N, H, W, Cin, Cout): the ConvLSTM's gate convs at a small size (input
# half 3 -> 64, hidden halves 16 -> 64 and 12 -> 48), a ragged one
CONV_SHAPES = [(4, 16, 16, 3, 64), (2, 16, 16, 16, 64), (2, 8, 16, 12, 48),
               (3, 16, 24, 10, 7)]


def _conv_inputs(shape, seed=0):
    n, h, w, cin, cout = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, w, cin)).astype(np.float32)
    k = (rng.normal(size=(3, 3, cin, cout)) * 0.1).astype(np.float32)
    dy = rng.normal(size=(n, h, w, cout)).astype(np.float32)
    return x, k, dy


@pytest.mark.parametrize("shape", CONV_SHAPES, ids=str)
def test_conv3x3_matches_pallas_kernel_and_vjp(shape):
    x, k, dy = _conv_inputs(shape)
    want, vjp = jax.vjp(lambda a, b: conv3x3_pallas(a, b, True),
                        jnp.asarray(x), jnp.asarray(k))
    want_dx, want_dk = vjp(jnp.asarray(dy))

    xt = torch.from_numpy(x).requires_grad_()
    kt = torch.from_numpy(k).requires_grad_()
    got = conv3x3(xt, kt)
    got.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx),
                               rtol=GRAD_TOL, atol=GRAD_TOL)
    np.testing.assert_allclose(kt.grad.numpy(), np.asarray(want_dk),
                               rtol=GRAD_TOL, atol=GRAD_TOL)


def test_conv3x3_plain_matches_lax_conv_at_odd_sizes():
    """Any H and W (the card kernel takes them too)."""
    x, k, _ = _conv_inputs((2, 7, 13, 5, 9), seed=1)
    want = lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = conv3x3_plain(torch.from_numpy(x), torch.from_numpy(k))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_TOL,
                               atol=FWD_TOL)


def test_conv3x3_backward_matches_autograd_of_plain():
    """dx through the forward with flipped weights and dw as tap products
    are the gradients of ``F.conv2d``."""
    x, k, dy = _conv_inputs((2, 9, 11, 6, 5), seed=2)
    grads = []
    for fn in (conv3x3, conv3x3_plain):
        xt = torch.from_numpy(x).requires_grad_()
        kt = torch.from_numpy(k).requires_grad_()
        fn(xt, kt).backward(torch.from_numpy(dy))
        grads.append((xt.grad, kt.grad))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


# -- the augment gather ---------------------------------------------------------

def _staged(b, t, s, seed):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (b, t, s, s, 3), dtype=np.uint8)
    real = rng.integers(0, 256, (b, t, s, s, 3), dtype=np.uint8)
    mask = (rng.uniform(size=(b, t, s, s, 1)) > 0.5).astype(np.uint8) * 255
    return data, real, mask


# per-clip (angle rad, crop_y, crop_x, flip): a plain crop, the reference's
# +-10 degree range, and 45 degrees, which leaves much of the clip outside
# the source (zero fill)
_DRAWS = [(0.0, 0, 1, False), (0.1234, 1, 0, True), (-0.1745, 1, 1, False),
          (0.7854, 0, 0, True)]


def _params(draws):
    return (np.array([d[0] for d in draws], np.float32),
            np.array([d[1] for d in draws], np.int32),
            np.array([d[2] for d in draws], np.int32),
            np.array([d[3] for d in draws]))


def _torch_params(params):
    angle, cy, cx, flip = params
    return (torch.from_numpy(angle), torch.from_numpy(cy).long(),
            torch.from_numpy(cx).long(), torch.from_numpy(flip))


@pytest.mark.parametrize("isize", [16, 24])
def test_augment_gather_matches_pallas_kernel(isize):
    s = augment.staging_size(isize)
    streams = _staged(len(_DRAWS), 3, s, isize)
    params = _params(_DRAWS)
    src_x, src_y = jax.vmap(jaug._src_coords,
                            in_axes=(0, 0, 0, 0, None, None))(
        *map(jnp.asarray, params), s, isize)
    joint = jnp.concatenate([jnp.asarray(v) for v in streams], axis=-1)
    out = augment_gather_pallas(joint, src_x, src_y, isize, interpret=True)
    want = (out[..., :3] / 255.0 * 2.0 - 1.0, out[..., 3:6] / 255.0 * 2.0 - 1.0,
            out[..., 6:] / 255.0)

    px, py = augment._src_coords(*_torch_params(params), s, isize)
    np.testing.assert_array_equal(px.numpy(), np.asarray(src_x))
    np.testing.assert_array_equal(py.numpy(), np.asarray(src_y))
    got = augment.augment_gather(*map(torch.from_numpy, streams),
                                 px.contiguous(), py.contiguous())
    assert float(np.asarray(out[-1] == 0).mean()) > 0.1   # 45 deg: zero fill
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_augment_clips_matches_pallas_route_with_injected_draws(monkeypatch):
    isize = 16
    s = augment.staging_size(isize)
    streams = _staged(len(_DRAWS), 2, s, 7)
    params = _params(_DRAWS)
    monkeypatch.setattr(jaug, "sample_clip_params",
                        lambda *a, **k: tuple(map(jnp.asarray, params)))
    want = jaug.augment_clips(jax.random.key(0),
                              *map(jnp.asarray, streams), isize,
                              use_pallas=True, interpret=True)
    got = augment.augment_clips(_torch_params(params),
                                *map(torch.from_numpy, streams), isize)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
