"""The plain versions of the port's augment gather and 3x3 conv against
the JAX package's Pallas kernels (in interpret mode) on the CPU.

* ``conv3x3``: the port's function (``F.conv2d`` forward; dx through the
  same forward with flipped, transposed weights; dw as tap products)
  against ``conv3x3_pallas(x, w, interpret=True)`` and its custom VJP, and
  against ``lax.conv_general_dilated``.  Unit-normal x, w x 0.1, as
  ``tests/test_pallas_spatial_conv.py`` uses; forward within 1e-5, x and w
  gradients within 1e-4 (float32 sums in another order).  W is a multiple
  of 8, as the Mosaic kernel needs.  The cases are the nine channel pairs
  of one ConvLSTM step (forward F1-F5, dx D1-D4) and a ragged one.
* the card kernel's arithmetic and indexing, which cannot run here: an
  emulation of its 3xTF32 split (operands split into a rounded and a cut
  tf32 part by integer arithmetic, three products per K step of 8, the
  running sum in float32)
  against a float64 convolution, and its dx weight index map against
  ``w.flip(0, 1).transpose(2, 3)``.
* the solver kernels' tiling (``flow_fused.cu``, ``flow_refine.cu``): the
  index maps that ``ops/flow_refine.py`` restates, walked item by item in
  PyTorch with the kernels' arithmetic (bfloat16 maps, float32 sums in
  the tap order d = 0 .. 14, the interior weight a constant), against
  ``flow_refine_step_plain``: every output once, no load outside its row's
  data and zeros, the blurred maps within 1e-6 (the sums' order) and the
  flow's q99 within 1e-3 px, at ragged sizes and every item height.
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
from test_torch_port_threads import one_torch_thread  # noqa: F401

FWD_TOL = 1e-5
GRAD_TOL = 1e-4

# (N, H, W, Cin, Cout): the nine distinct launches of one ConvLSTM step
# (hidden widths 16/12/12) at a small size, the input halves with more
# frames than the hidden ones, dx with the channels swapped; a ragged one
CONV_SHAPES = {"F1": (4, 16, 16, 3, 64), "F2": (4, 8, 16, 16, 48),
               "F3": (4, 8, 16, 12, 48), "F4": (2, 16, 16, 16, 64),
               "F5": (2, 8, 16, 12, 48), "D1": (2, 8, 16, 64, 16),
               "D2": (2, 8, 16, 48, 12), "D3": (4, 8, 16, 48, 16),
               "D4": (4, 8, 8, 48, 12), "ragged": (3, 16, 24, 10, 7)}


def _conv_inputs(shape, seed=0):
    n, h, w, cin, cout = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, h, w, cin)).astype(np.float32)
    k = (rng.normal(size=(3, 3, cin, cout)) * 0.1).astype(np.float32)
    dy = rng.normal(size=(n, h, w, cout)).astype(np.float32)
    return x, k, dy


@pytest.mark.parametrize("case", list(CONV_SHAPES))
def test_conv3x3_matches_pallas_kernel_and_vjp(case):
    x, k, dy = _conv_inputs(CONV_SHAPES[case])
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


@pytest.mark.parametrize("shape", [(2, 7, 13, 5, 9), (1, 9, 35, 4, 5),
                                   (2, 5, 33, 1, 3), (1, 6, 10, 20, 70)],
                         ids=str)
def test_conv3x3_plain_matches_lax_conv_at_odd_sizes(shape):
    """Any H and W, any channel counts (the card kernel takes them too)."""
    x, k, _ = _conv_inputs(shape, seed=1)
    want = lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = conv3x3_plain(torch.from_numpy(x), torch.from_numpy(k))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_TOL,
                               atol=FWD_TOL)


@pytest.mark.parametrize("shape", [(2, 9, 11, 6, 5), (1, 5, 7, 3, 8),
                                   (2, 4, 6, 12, 4)], ids=str)
def test_conv3x3_backward_matches_autograd_of_plain(shape):
    """dx through the forward with flipped weights and dw as tap products
    are the gradients of ``F.conv2d``."""
    x, k, dy = _conv_inputs(shape, seed=2)
    grads = []
    for fn in (conv3x3, conv3x3_plain):
        xt = torch.from_numpy(x).requires_grad_()
        kt = torch.from_numpy(k).requires_grad_()
        fn(xt, kt).backward(torch.from_numpy(dy))
        grads.append((xt.grad, kt.grad))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


# -- the card kernel's arithmetic and indexing, emulated ---------------------------

def _tf32(v: torch.Tensor) -> torch.Tensor:
    """float32 rounded to tf32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds: add half of the last
    kept bit to the bit pattern, clear the 13 dropped bits."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(v):
    """hi: ``v`` rounded to tf32; lo: the rest, exact in float32, cut to
    tf32 as the tensor cores read a float32 operand (its low 13 bits
    dropped)."""
    hi = _tf32(v)
    lo = (v - hi).contiguous().view(torch.int32) & ~0x1FFF
    return hi, lo.view(torch.float32)


def _patches(x: torch.Tensor) -> torch.Tensor:
    """(N*H*W, 9*Cin) rows of the implicit GEMM, K ordered (tap, channel)."""
    n, h, w, cin = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    return torch.cat([xp[:, i:i + h, j:j + w].reshape(-1, cin)
                      for i in range(3) for j in range(3)], dim=1)


def conv3x3_split_emulation(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The card kernel's sum in plain PyTorch: per K step of 8, a_lo b_hi +
    a_hi b_lo + a_hi b_hi (products of tf32 values, exact in float32), added
    to a float32 running sum."""
    a = _patches(x)
    b = w.reshape(-1, w.shape[-1])
    pad = -a.shape[1] % 8
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    (a_hi, a_lo), (b_hi, b_lo) = _split(a), _split(b)
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        acc += (a_lo[:, s] @ b_hi[s] + a_hi[:, s] @ b_lo[s]) + (
            a_hi[:, s] @ b_hi[s])
    return acc.reshape(*x.shape[:3], -1)


def test_tf32_rounding_by_integer_arithmetic():
    v = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10,
                      -(1.0 + 2.0 ** -11), 3.0e-5, 0.0])
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                         -(1.0 + 2.0 ** -10), 0.0, 0.0])
    got = _tf32(v)
    assert torch.equal(got[:4], want[:4]) and got[5] == 0
    assert abs(got[4] - v[4]) <= 2.0 ** -11 * v[4]
    hi, lo = _split(torch.randn(1000, generator=torch.Generator()
                                .manual_seed(0)))
    assert torch.equal(_tf32(hi), hi) and torch.equal(_tf32(lo), lo)
    v = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    assert ((hi + lo) - v).abs().max() <= 2.0 ** -21 * v.abs().max()


@pytest.mark.parametrize("decades", [0, 6], ids=["unit", "six_decades"])
@pytest.mark.parametrize("cin", [3, 16, 64], ids=["K27", "K144", "K576"])
def test_split_emulation_is_as_close_to_float64_as_float32_conv(cin, decades):
    """max-abs error against a float64 convolution: the split's no more
    than twice ``conv3x3_plain``'s in float32, on unit-normal inputs and on
    inputs whose magnitudes span six decades (the weights keep their one
    scale, as a layer's do).  Where a few products dominate a sum, the
    split's own error shows: each operand is kept to 2^-22 and a_lo b_lo
    is dropped, against float32's 2^-24 per rounding."""
    rng = np.random.default_rng(cin + decades)
    x = rng.normal(size=(2, 12, 16, cin))
    k = rng.normal(size=(3, 3, cin, 24)) * 0.1
    if decades:
        x *= 10.0 ** rng.uniform(-decades / 2, decades / 2, size=x.shape)
    x32 = torch.from_numpy(x.astype(np.float32))
    k32 = torch.from_numpy(k.astype(np.float32))
    exact = conv3x3_plain(x32.double(), k32.double())
    err_plain = (conv3x3_plain(x32, k32).double() - exact).abs().max().item()
    err_split = (conv3x3_split_emulation(x32, k32).double()
                 - exact).abs().max().item()
    assert err_split <= 2 * err_plain, (err_split, err_plain)
    # and a single tf32 pass is far outside: the split is what holds 1e-5
    a, b = _patches(x32), k32.reshape(-1, 24)
    one_pass = (_tf32(a) @ _tf32(b)).reshape(exact.shape)
    assert (one_pass.double() - exact).abs().max().item() > 20 * err_plain


@pytest.mark.parametrize("cin,cout", [(16, 64), (12, 48), (3, 5), (7, 9)],
                         ids=str)
def test_flipped_weight_index_is_flip_and_transpose(cin, cout):
    """The dx launch (cin_l = the forward's Cout, cout_l = its Cin) reads
    the forward's ``w (3, 3, Cin, Cout)`` in place."""
    from vfd_gan_tpu_torch.ops.spatial_conv import flipped_weight_index

    w = torch.arange(9 * cin * cout, dtype=torch.float32).reshape(
        3, 3, cin, cout)
    want = w.flip(0, 1).transpose(2, 3)          # (3, 3, cin_l, cout_l)
    cin_l, cout_l = cout, cin
    flat = w.flatten()
    got = torch.tensor([[[flat[flipped_weight_index(tap, ci, co, cin_l,
                                                    cout_l)]
                          for co in range(cout_l)] for ci in range(cin_l)]
                        for tap in range(9)]).reshape(3, 3, cin_l, cout_l)
    assert torch.equal(got, want)


def test_conv3x3_forward_flip_is_the_input_gradient():
    x, k, dy = _conv_inputs((2, 6, 8, 5, 7), seed=3)
    from vfd_gan_tpu_torch.ops.spatial_conv import conv3x3_forward

    xt = torch.from_numpy(x).requires_grad_()
    conv3x3_plain(xt, torch.from_numpy(k)).backward(torch.from_numpy(dy))
    got = conv3x3_forward(torch.from_numpy(dy), torch.from_numpy(k),
                          flip=True)
    np.testing.assert_allclose(got.numpy(), xt.grad.numpy(), rtol=GRAD_TOL,
                               atol=GRAD_TOL)


# -- the solver kernels' tiling, walked on the CPU -------------------------------

# (H, W): the smallest legal level (narrower and lower than the window), a
# width that is no multiple of the run nor of 2, taller than wide, and the
# two small levels of a train step
TILE_PLANES = [(8, 8), (17, 33), (40, 24), (16, 16), (32, 32)]


def _solver_inputs(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    p1, w2 = (torch.from_numpy(rng.normal(size=(n, 5, h, w))
                               .astype(np.float32)) for _ in range(2))
    flow = torch.from_numpy(rng.normal(size=(n, 2, h, w)).astype(np.float32))
    return p1, w2, flow


def tiled_solve_emulation(p1, w2, flow, rows):
    """One field at a time through the kernels' scratch layout and items.
    Returns the blurred maps, the flow, and how often each pixel's flow was
    stored.  T starts as NaN except where the kernel zeroes it, so a read
    of anything unwritten shows in the result."""
    from vfd_gan_tpu_torch.ops import corr, flow_refine as fr

    n, _, h, w = p1.shape
    pitch, q_elems, t_elems = fr.scratch_layout(h, w)
    taps = corr.box_taps(fr.WINSIZE)
    band_h = corr.band_table(h, taps, "cpu")
    band_w = corr.band_table(w, taps, "cpu")
    quant = corr.bf16_round(fr.normal_quantities(p1, w2, flow))
    blurred = torch.full((n, 5, h, w), float("nan"))
    stores = torch.zeros((n, h, w), dtype=torch.int64)
    cs, ys, xs = torch.meshgrid(torch.arange(5), torch.arange(h),
                                torch.arange(w), indexing="ij")
    is_data = torch.zeros(q_elems, dtype=torch.bool)
    is_data[fr.q_index(cs, ys, xs, h, pitch)] = True
    for f in range(n):
        q = torch.zeros(q_elems)
        q[fr.q_index(cs, ys, xs, h, pitch)] = quant[f]
        t = torch.full((t_elems,), float("nan"))
        t2 = t.view(-1, pitch)
        for c in range(6):                     # the halo rows
            t2[c * (h + fr.RADIUS):c * (h + fr.RADIUS) + fr.RADIUS] = 0
        for row in range(5 * h):               # the W pass
            c, y = divmod(row, h)
            for run in range(pitch // fr.RUN - 1):
                x0, loads, outs = fr.w_run(run, row, pitch)
                loads = torch.tensor(list(loads))
                assert loads.min() >= 0 and loads.max() < q_elems
                data = loads[is_data[loads]]   # only this row's data
                assert ((data >= fr.q_index(c, y, 0, h, pitch))
                        & (data <= fr.q_index(c, y, w - 1, h, pitch))).all()
                v = q[loads]
                acc = torch.zeros(fr.RUN)
                const = fr.interior(x0, fr.RUN, w)
                wt = band_w[[min(x, w - 1) for x in outs]]
                if const:
                    wt = band_w[x0, fr.RADIUS].expand(fr.RUN, fr.WINSIZE)
                for d in range(fr.WINSIZE):
                    acc = acc + wt[:, d] * v[d + 1:d + 1 + fr.RUN]
                first = fr.t_index(c, y, x0, h, pitch)
                t[first:first + fr.RUN] = corr.bf16_round(acc)
        plane = (h + fr.RADIUS) * pitch
        for group in range(-(-h // rows)):     # the H pass, all columns
            out_rows, t_rows = fr.h_item(group, rows)
            assert max(t_rows) * pitch + 4 * plane + w - 1 < t_elems
            const = fr.interior(out_rows[0], rows, h)
            for c in range(5):
                tile = t2[c * (h + fr.RADIUS) + t_rows[0]:
                          c * (h + fr.RADIUS) + t_rows[-1] + 1, :w]
                for o, y in enumerate(out_rows):
                    if y >= h:
                        break
                    wt = band_h[y]
                    if const:
                        wt = band_h[out_rows[0], fr.RADIUS].expand(fr.WINSIZE)
                    acc = torch.zeros(w)
                    for d in range(fr.WINSIZE):
                        acc = acc + wt[d] * tile[o + d]
                    blurred[f, c, y] = acc
                    stores[f, y] += c == 0
    return blurred, fr.solve(blurred), stores


@pytest.mark.parametrize("rows", [1, 2, 4])
@pytest.mark.parametrize("plane", TILE_PLANES, ids=str)
def test_solver_tiling_covers_the_plane_and_matches_plain(plane, rows):
    from vfd_gan_tpu_torch.ops import corr, flow_refine as fr

    h, w = plane
    p1, w2, flow = _solver_inputs(2, h, w, seed=h * w + rows)
    blurred, got, stores = tiled_solve_emulation(p1, w2, flow, rows)
    assert (stores == 1).all()                   # every output, once
    taps = corr.box_taps(fr.WINSIZE)
    want_blur = corr.sep_corr(fr.normal_quantities(p1, w2, flow), taps, taps)
    # the same bfloat16 operands; only the order of the float32 sums differs
    np.testing.assert_allclose(blurred.numpy(), want_blur.numpy(), rtol=1e-6,
                               atol=1e-6)
    err = (got - fr.flow_refine_step_plain(p1, w2, flow, fr.WINSIZE)).abs()
    assert torch.quantile(err.flatten(), 0.99).item() <= 1e-3


@pytest.mark.parametrize("size", [8, 15, 16, 22, 23, 33, 64])
def test_interior_runs_have_one_weight(size):
    """Where ``interior`` says so, the band rows of a run hold one value
    15 times, so the kernels may keep it in a register; and it says so for
    every run that has."""
    from vfd_gan_tpu_torch.ops import corr, flow_refine as fr

    band = corr.band_table(size, corr.box_taps(fr.WINSIZE), "cpu")
    for count in (1, 2, 4, fr.RUN):
        for first in range(0, size, count):
            rows = band[first:first + count]
            same = bool((rows == rows[0, fr.RADIUS]).all()) \
                and first + count <= size
            assert fr.interior(first, count, size) == same, (first, count)


@pytest.mark.parametrize("plane,rows,threads", [
    ((64, 64), 4, 256), ((32, 32), 4, 256), ((16, 16), 2, 160),
    ((8, 8), 1, 64), ((128, 128), 4, 256)], ids=str)
def test_plan_block_at_the_train_steps_levels(plane, rows, threads):
    from vfd_gan_tpu_torch.ops import flow_refine as fr

    assert fr.plan_block(*plane, in_shared=plane != (128, 128)) == (
        rows, threads)


def test_scratch_layout_keeps_16_byte_words_aligned():
    """Q rows and T rows start on 16 bytes, T follows Q on 16 bytes, and two
    fields of 64^2 fit in one SM's 227 KB of shared memory beside their
    band tables (two blocks per SM: all 240 fields of a level at once)."""
    from vfd_gan_tpu_torch.ops import flow_refine as fr

    for h, w in TILE_PLANES + [(64, 64), (128, 128)]:
        pitch, q_elems, t_elems = fr.scratch_layout(h, w)
        assert pitch % fr.RUN == 0 and q_elems % fr.RUN == 0
        assert t_elems % fr.RUN == 0 and pitch >= w + fr.RUN
    pitch, q_elems, t_elems = fr.scratch_layout(64, 64)
    per_block = 2 * (q_elems + t_elems) + 4 * 16 * (64 + 64) + 1024
    assert 2 * per_block <= 227 * 1024
    # 16-byte loads of 32 lanes on 32 consecutive rows: 8 lanes fill the
    # 32 banks when the pitch in 4-byte words is an odd multiple of 4
    for w in (16, 32, 64, 128):
        assert (fr.scratch_layout(w, w)[0] // 2) % 8 == 4


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
