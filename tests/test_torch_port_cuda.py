"""The port's CUDA kernels: how their library is built and, on a card, each
kernel against its plain version.

Tests marked ``gpu`` need an NVIDIA card and skip without one.  This file
imports no jax, so on a machine with a card and no jax it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

import shutil

import numpy as np
import pytest
import torch

from vfd_gan_tpu_torch.ops import augment, corr, cuda, flow, flow_fused
from vfd_gan_tpu_torch.ops import flow_refine, morphology, spatial_conv, warp


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.parametrize("edited", ["morphology_open.cu", "flow_fused.cu",
                                    "augment_gather.cu", "conv3x3.cu",
                                    "flow_common.cuh", "launch_common.cuh"])
def test_library_name_follows_the_sources_and_headers(tmp_path, monkeypatch,
                                                      edited):
    for src in cuda.sources() + cuda.headers():
        shutil.copy(src, tmp_path / src.name)
    monkeypatch.setattr(cuda, "SOURCE_DIR", tmp_path)
    first = cuda.library_path()
    assert first == cuda.library_path()
    src = tmp_path / edited
    src.write_text(src.read_text() + "\n// edited\n")
    assert cuda.library_path() != first
    assert cuda.library_path().parent == cuda.BUILD_DIR


def test_every_entry_point_is_bound():
    names = {"vfd_morphology_open_f32", "vfd_flow_warp_f32",
             "vfd_flow_refine_f32", "vfd_flow_fused_f32",
             "vfd_flow_workspace_bytes", "vfd_augment_gather_u8",
             "vfd_conv3x3_f32"}
    assert set(cuda.ENTRIES) == names
    text = "".join(src.read_text() for src in cuda.sources())
    for name in names:
        assert f"extern \"C\" int {name}(" in text \
            or f"extern \"C\" long long {name}(" in text, name


def test_stage_clock_tool_matches_the_solver_sources():
    """``tools/flow_stages.py`` builds the solver sources a second time with
    ``-DVFD_STAGE_CLOCKS`` and with stage A's gathers taken out by a text
    substitution: the sources still hold what it looks for."""
    from vfd_gan_tpu_torch.tools import flow_stages

    common = (cuda.SOURCE_DIR / "flow_common.cuh").read_text()
    assert flow_stages._substitute(common, flow_stages.NO_GATHER) != common
    assert f"kClockedBlocks = {flow_stages.CLOCKED_BLOCKS};" in common
    assert f"kClockSlots = {flow_stages.CLOCK_SLOTS};" in common
    for src, kernel in zip(flow_stages.SOLVER_SOURCES, ("fused", "refine")):
        text = (cuda.SOURCE_DIR / src).read_text()
        assert f"int vfd_flow_{kernel}_stage_clocks(void* dst)" in text
    with pytest.raises(SystemExit, match="expected 1 x"):
        flow_stages._substitute("nothing to find", flow_stages.NO_GATHER)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    if shutil.which("nvcc"):
        pytest.skip("nvcc is on PATH here")
    import torch.utils.cpp_extension as cpp

    monkeypatch.setattr(cuda, "BUILD_DIR", tmp_path)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda.build()
    assert not any(tmp_path.iterdir())           # no half-written library


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "float"])
@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("shape", [
    (8 * 128, 16, 128),       # infer "th": B*W planes of (T, H)
    (8 * 16, 128, 128),       # infer "hw": B*T planes of (H, W)
    (2, 512, 512),            # too large for one block: tiled
    (3, 13, 37),              # ragged
], ids=["th", "hw", "tiled512", "ragged"])
@pytest.mark.gpu
def test_kernel_equals_plain_on_card(card, shape, k, binary):
    g = torch.Generator(device=card).manual_seed(0)
    x = torch.rand(shape, generator=g, device=card)
    if binary:
        x = (x > 0.5).float()
    before = morphology.open_planes_cuda.launches
    got = morphology.open_planes(x, k)
    torch.cuda.synchronize()
    assert morphology.open_planes_cuda.launches == before + 1
    assert torch.equal(got, morphology.open_planes_plain(x, k))


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(card):
    x = torch.zeros(2, 8, 8, device=card)
    with pytest.raises(TypeError):
        morphology.open_planes_cuda(x.half(), 5)
    with pytest.raises(ValueError):
        morphology.open_planes_cuda(x.transpose(1, 2), 5)
    with pytest.raises(ValueError):
        morphology.open_planes_cuda(x, 4)
    with pytest.raises(ValueError):
        morphology.open_planes_cuda(x[0], 5)


@pytest.mark.gpu
def test_video_open_on_card_equals_cpu(card):
    x = (np.random.default_rng(1).uniform(size=(2, 16, 32, 24, 1)) > 0.4)
    video = torch.from_numpy(x.astype(np.float32))
    for plane in ("th", "hw"):
        got = morphology.video_open(video.to(card), plane).cpu()
        assert torch.equal(got, morphology.video_open(video, plane))


# -- the flow kernels ---------------------------------------------------------

def _flow_inputs(card, n, h, w, flow_scale, seed=0):
    """Polynomial planes of smooth frames with a planted (1, 2) px shift,
    and a flow of ``flow_scale`` px around it."""
    g = torch.Generator(device=card).manual_seed(seed)
    yy = torch.arange(h, device=card, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=card, dtype=torch.float32)[None, :]
    phase = torch.rand(n, 1, 1, generator=g, device=card) * 6.28

    def frame(dx, dy):
        return 128 + 60 * torch.sin(0.21 * (xx - dx) + phase) * torch.cos(
            0.17 * (yy - dy)) + 30 * torch.sin(0.11 * (xx + yy - dx - dy))

    planes = flow._poly_planes(torch.cat([frame(0, 0), frame(1, 2)]))
    p1, p2 = planes[:n].contiguous(), planes[n:].contiguous()
    f0 = (torch.randn(n, 2, h, w, generator=g, device=card)
          * flow_scale).contiguous()
    return p1, p2, f0


# the train step's levels at flow_scale 0.5 and 1.0, a ragged plane, a
# flow far outside the TPU warp's |fy| <= 3 px band at 64 rows, and what the
# solver kernels' tiling can get wrong: the smallest legal level (narrower
# and lower than the 15-tap window), a width that is no multiple of the
# W-pass run of 8 nor of 2 over a height that is no multiple of the H-pass
# item, a plane taller than wide, and a single field
FLOW_CASES = {"64": (16, 64, 64, 1.0), "32": (16, 32, 32, 1.0),
              "16": (16, 16, 16, 1.0), "128": (4, 128, 128, 1.0),
              "ragged": (3, 24, 40, 1.0), "large_flow": (4, 64, 64, 12.0),
              "8x8": (3, 8, 8, 1.0), "17x33": (2, 17, 33, 1.0),
              "tall": (2, 40, 24, 1.0), "one_field": (1, 64, 64, 1.0)}


@pytest.mark.parametrize("case", list(FLOW_CASES))
@pytest.mark.gpu
def test_warp_kernel_matches_plain_on_card(card, case):
    n, h, w, scale = FLOW_CASES[case]
    _, p2, f0 = _flow_inputs(card, n, h, w, scale)
    before = warp.bilinear_warp_cuda.launches
    got = warp.bilinear_warp(p2, f0)
    torch.cuda.synchronize()
    assert warp.bilinear_warp_cuda.launches == before + 1
    want = warp.bilinear_warp_plain(p2, f0)
    assert (got - want).abs().max().item() <= 1e-5 * p2.abs().max().item()


@pytest.mark.parametrize("case", list(FLOW_CASES))
@pytest.mark.gpu
def test_refine_kernel_matches_plain_on_card(card, case):
    n, h, w, scale = FLOW_CASES[case]
    p1, p2, f0 = _flow_inputs(card, n, h, w, scale)
    w2 = warp.bilinear_warp_plain(p2, f0)
    before = flow_refine.flow_refine_step_cuda.launches
    got = flow_refine.flow_refine_step(p1, w2, f0, 15)
    torch.cuda.synchronize()
    assert flow_refine.flow_refine_step_cuda.launches == before + 1
    err = (got - flow_refine.flow_refine_step_plain(p1, w2, f0, 15)).abs()
    assert torch.quantile(err.flatten()[:1 << 24], 0.99).item() <= 1e-3


@pytest.mark.parametrize("iterations", [3, 1, 2])
@pytest.mark.parametrize("case", list(FLOW_CASES))
@pytest.mark.gpu
def test_fused_kernel_matches_plain_on_card(card, case, iterations):
    n, h, w, scale = FLOW_CASES[case]
    p1, p2, _ = _flow_inputs(card, n, h, w, scale)
    f0 = torch.zeros(n, 2, h, w, device=card)
    before = flow_fused.flow_refine_fused_cuda.launches
    by_plane = flow_fused.flow_refine_fused_cuda.launches_by_plane[(h, w)]
    got = flow_fused.flow_refine_fused(p1, p2, f0, 15, iterations)
    torch.cuda.synchronize()
    assert flow_fused.flow_refine_fused_cuda.launches == before + 1
    assert flow_fused.flow_refine_fused_cuda.launches_by_plane[(h, w)] \
        == by_plane + 1
    err = (got - flow_fused.flow_refine_fused_plain(p1, p2, f0, 15,
                                                    iterations)).abs()
    assert torch.quantile(err.flatten(), 0.99).item() <= 1e-3
    if min(h, w) >= 32 and iterations == 3:
        inner = got[:, :, 8:-8, 8:-8]
        assert abs(inner[:, 0].median().item() - 1) < 0.3
        assert abs(inner[:, 1].median().item() - 2) < 0.3


@pytest.mark.gpu
def test_flow_kernels_refuse_what_they_do_not_take(card):
    p1, p2, f0 = _flow_inputs(card, 2, 16, 16, 1.0)
    with pytest.raises(TypeError):
        warp.bilinear_warp_cuda(p2.double(), f0)
    with pytest.raises(ValueError):
        warp.bilinear_warp_cuda(p2, f0[:, :1].contiguous())
    with pytest.raises(ValueError):
        flow_refine.flow_refine_step_cuda(p1.transpose(2, 3), p2, f0, 15)
    with pytest.raises(ValueError):
        flow_fused.flow_refine_fused_cuda(p1, p2, f0, 14, 3)
    with pytest.raises(ValueError, match="winsize"):
        flow_refine.flow_refine_step_cuda(p1, p2, f0, 13)
    with pytest.raises(ValueError):
        flow_fused.flow_refine_fused_cuda(p1, p2.cpu(), f0, 15, 3)
    with pytest.raises(ValueError, match="forward-only"):
        flow_fused.flow_refine_fused(p1, p2, f0.requires_grad_(), 15, 3)


@pytest.mark.gpu
def test_band_table_on_card_equals_cpu(card):
    taps = corr.box_taps(15)
    assert torch.equal(corr.band_table(64, taps, card).cpu(),
                       corr.band_table(64, taps, "cpu"))


@pytest.mark.gpu
def test_video_to_flow_rgb_impls_agree_on_card(card):
    g = torch.Generator(device=card).manual_seed(3)
    video = (torch.rand(4, 16, 64, 64, 3, generator=g, device=card) > 0.7
             ).float() * 2 - 1
    out = {impl: flow.video_to_flow_rgb(video, 0.5, 2, impl)
           for impl in flow.IMPLS}
    for impl in ("two_kernel", "warp"):
        err = (out[impl] - out["fused"]).abs().flatten()
        assert torch.quantile(err, 0.99).item() <= 0.05, impl
    assert torch.isfinite(out["fused"]).all()


# -- the augment gather ---------------------------------------------------------

# (B, T, S, isize, max angle in degrees): the train step, a ragged clip, and
# a 45 degree draw that leaves much of each clip to the zero fill
AUGMENT_CASES = {"train": (8, 16, 140, 128, 10.0), "ragged": (3, 5, 37, 33,
                                                              10.0),
                 "rot45": (4, 4, 140, 128, 45.0)}


def _augment_inputs(card, b, t, s, isize, degrees, seed=0):
    g = torch.Generator(device=card).manual_seed(seed)
    data = torch.randint(0, 256, (b, t, s, s, 3), generator=g, device=card,
                         dtype=torch.uint8)
    real = torch.randint(0, 256, (b, t, s, s, 3), generator=g, device=card,
                         dtype=torch.uint8)
    mask = (torch.rand((b, t, s, s, 1), generator=g, device=card) > 0.5
            ).to(torch.uint8) * 255
    params = augment.sample_clip_params(g, b, s, isize, degrees)
    if degrees == 45.0:
        params = (torch.full_like(params[0], 0.785398),) + params[1:]
    src_x, src_y = augment._src_coords(*params, s, isize)
    return (data, real, mask), params, src_x.contiguous(), src_y.contiguous()


@pytest.mark.parametrize("case", list(AUGMENT_CASES))
@pytest.mark.gpu
def test_augment_kernel_equals_plain_on_card(card, case):
    streams, _, src_x, src_y = _augment_inputs(card, *AUGMENT_CASES[case])
    before = augment.augment_gather_cuda.launches
    got = augment.augment_gather(*streams, src_x, src_y)
    torch.cuda.synchronize()
    assert augment.augment_gather_cuda.launches == before + 1
    want = augment.augment_gather_plain(*streams, src_x, src_y)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_augment_gather_on_card_is_the_cpu_function(card):
    """From the same coordinates, the card's gather equals the CPU's to
    float32 rounding: PyTorch's CUDA division by a Python scalar multiplies
    by the reciprocal, so the scaled values may differ in the last bit."""
    streams, params, _, _ = _augment_inputs(card, 2, 3, 37, 33, 10.0, 1)
    src_x, src_y = (c.contiguous() for c in augment._src_coords(
        *(p.cpu() for p in params), 37, 33))
    got = augment.augment_gather(*streams, src_x.to(card), src_y.to(card))
    want = augment.augment_gather(*(v.cpu() for v in streams), src_x, src_y)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=2.4e-7)


@pytest.mark.gpu
def test_augment_kernel_refuses_what_it_does_not_take(card):
    streams, _, src_x, src_y = _augment_inputs(card, 2, 2, 17, 16, 10.0)
    data, real, mask = streams
    with pytest.raises(ValueError):
        augment.augment_gather_cuda(data.cpu(), real, mask, src_x, src_y)
    with pytest.raises(ValueError):
        augment.augment_gather_cuda(data, real, mask, src_x.cpu(), src_y)
    with pytest.raises(TypeError):
        augment.augment_gather_cuda(data.float(), real, mask, src_x, src_y)
    with pytest.raises(TypeError):
        augment.augment_gather_cuda(data, real, mask, src_x.double(), src_y)
    with pytest.raises(ValueError):
        augment.augment_gather_cuda(data, real[:, :1].contiguous(), mask,
                                    src_x, src_y)
    with pytest.raises(ValueError):
        augment.augment_gather_cuda(data, real, mask,
                                    src_x.transpose(1, 2), src_y)


# -- the 3x3 conv -----------------------------------------------------------------

# (N, H, W, Cin, Cout).  The nine distinct launches of one ConvLSTM step at
# b8, T16, 128^2 (forward F1-F5: the three layers' input halves over B*T
# frames and hidden halves over B frames; dx D1-D4 with the channels
# swapped), a wide case, and a ragged case for each dimension the kernel
# pads: H and W off its 8 x 32 tile, Cin off 8 (and off 4: scalar loads),
# Cout off 16 (and off 4: scalar stores), Cin <= 4 with K = 9 Cin off 8,
# Cout beyond one block's 64 channels.
CONV_CASES = {"F1": (128, 128, 128, 3, 64), "F2": (128, 128, 128, 16, 48),
              "F3": (128, 128, 128, 12, 48), "F4": (8, 128, 128, 16, 64),
              "F5": (8, 128, 128, 12, 48), "D1": (8, 128, 128, 64, 16),
              "D2": (8, 128, 128, 48, 12), "D3": (128, 128, 128, 48, 16),
              "D4": (128, 128, 128, 48, 12), "wide": (8, 128, 128, 64, 64),
              "ragged": (5, 24, 40, 7, 9), "ragged_hw": (3, 13, 37, 16, 16),
              "ragged_cin": (2, 16, 32, 10, 16),
              "ragged_cout": (2, 16, 32, 8, 22),
              "ragged_packed": (3, 9, 35, 4, 5), "one_channel": (2, 17, 33, 1,
                                                                 3),
              "two_slices": (2, 40, 40, 20, 96)}


def _conv_inputs(card, n, h, w, cin, cout, seed=0):
    """Unit-normal x, w x 0.1, and dy scaled by 1 / sqrt(N*H*W) so that dw,
    a sum over every pixel, stays O(1) (as for the models' mean losses)."""
    g = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn((n, h, w, cin), generator=g, device=card)
    k = torch.randn((3, 3, cin, cout), generator=g, device=card) * 0.1
    dy = torch.randn((n, h, w, cout), generator=g, device=card) / (
        n * h * w) ** 0.5
    return x, k, dy


@pytest.mark.parametrize("case", list(CONV_CASES))
@pytest.mark.gpu
def test_conv3x3_kernel_matches_plain_on_card(card, case):
    """Forward within 1e-5 of ``F.conv2d`` in float32 (TF32 off), dx and
    dw within 1e-4 of its autograd in float64: at 64 -> 64 the library's
    own float32 weight gradient is 2e-4 from the float64 one."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    x, k, dy = _conv_inputs(card, *CONV_CASES[case])
    before = spatial_conv.conv3x3_cuda.launches
    xa, ka = x.clone().requires_grad_(), k.clone().requires_grad_()
    got = spatial_conv.conv3x3(xa, ka)
    got.backward(dy)
    torch.cuda.synchronize()
    assert spatial_conv.conv3x3_cuda.launches == before + 2    # fwd, dx
    xb = x.double().requires_grad_()
    kb = k.double().requires_grad_()
    spatial_conv.conv3x3_plain(xb, kb).backward(dy.double())
    torch.testing.assert_close(got, spatial_conv.conv3x3_plain(x, k),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(xa.grad, xb.grad.float(), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ka.grad, kb.grad.float(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", ["F4", "D2", "ragged", "ragged_packed"])
@pytest.mark.gpu
def test_conv3x3_kernel_reads_flipped_weights_in_place(card, case):
    """``flip`` convolves by ``w.flip(0, 1).transpose(2, 3)`` without the
    copy: held to the plain version on that copy."""
    torch.backends.cudnn.allow_tf32 = False
    n, h, w, cin, cout = CONV_CASES[case]
    x, _, _ = _conv_inputs(card, n, h, w, cin, cout)
    g = torch.Generator(device=card).manual_seed(1)
    k = torch.randn((3, 3, cout, cin), generator=g, device=card) * 0.1
    got = spatial_conv.conv3x3_cuda(x, k, flip=True)
    want = spatial_conv.conv3x3_plain(x, k.flip(0, 1).transpose(2, 3))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_conv3x3_kernel_refuses_what_it_does_not_take(card):
    x, k, _ = _conv_inputs(card, 2, 8, 8, 4, 5)
    with pytest.raises(ValueError):
        spatial_conv.conv3x3_cuda(x, k.cpu())
    with pytest.raises(ValueError):
        spatial_conv.conv3x3_cuda(x.cpu(), k)
    with pytest.raises(TypeError):
        spatial_conv.conv3x3_cuda(x.double(), k)
    with pytest.raises(TypeError):
        spatial_conv.conv3x3_cuda(x, k.half())
    with pytest.raises(ValueError):
        spatial_conv.conv3x3_cuda(x.transpose(1, 2), k)
    with pytest.raises(ValueError):
        spatial_conv.conv3x3_cuda(x, k[:, :, :3].contiguous())
    with pytest.raises(ValueError):        # flip wants (3, 3, Cout, Cin)
        spatial_conv.conv3x3_cuda(x, k, flip=True)
