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
             "vfd_conv3x3_f32", "vfd_conv3x3_bf16"}
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
        morphology.open_planes_cuda(x, 4)
    with pytest.raises(ValueError):
        morphology.open_planes_cuda(x[0, 0], 5)
    with pytest.raises(ValueError):
        morphology.open_planes_cuda(x.cpu(), 5)
    video = torch.zeros(2, 4, 6, 8, 3, device=card)
    with pytest.raises(ValueError, match="neighbours"):
        morphology.open_planes_cuda(video, 5, (1, 3))
    with pytest.raises(ValueError, match="in place"):
        morphology.open_planes_cuda(video[:, :, :, ::2], 5, (1, 2))
    with pytest.raises(RuntimeError, match="cudaError"):   # no such tile
        morphology.open_planes_cuda(video, 5, (1, 2), (-1, 0, 0))


# A channel-last video as the entry points hold it, a channel-3 video, ragged
# sizes in every axis, and a model's NCDHW mask seen channel-last.
VIDEO_CASES = {"serve": (8, 16, 128, 128, 1), "c3": (2, 16, 32, 24, 3),
               "ragged": (1, 13, 37, 3, 1), "ragged_c2": (2, 5, 7, 9, 2),
               "wide_lanes": (1, 16, 40, 160, 1), "tall": (1, 40, 70, 33, 1)}


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("plane", ["th", "hw"])
@pytest.mark.parametrize("case", list(VIDEO_CASES))
@pytest.mark.gpu
def test_video_open_on_card_is_one_launch_in_place(card, case, plane, k):
    """Bit-equal to the plain version (the CPU route), contiguous, from one
    launch and no other kernel's work on the video: the allocator sees the
    result and nothing of a copy's size."""
    g = torch.Generator(device=card).manual_seed(1)
    video = torch.rand(VIDEO_CASES[case], generator=g, device=card)
    if k == 5:
        video = (video > 0.4).float()
    want = morphology.video_open(video.cpu(), plane, k)
    before = morphology.open_planes_cuda.launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    got = morphology.video_open(video, plane, k)
    torch.cuda.synchronize()
    assert morphology.open_planes_cuda.launches == before + 1
    assert got.is_contiguous() and got.shape == video.shape
    assert torch.equal(got.cpu(), want)
    # the result (rounded up by the allocator) and no second tensor
    size = video.numel() * 4
    assert torch.cuda.max_memory_allocated() - held < size + max(
        size // 2, 1 << 20)


@pytest.mark.gpu
def test_video_open_on_card_equals_cpu(card):
    x = (np.random.default_rng(1).uniform(size=(2, 16, 32, 24, 1)) > 0.4)
    video = torch.from_numpy(x.astype(np.float32))
    for plane in ("th", "hw"):
        got = morphology.video_open(video.to(card), plane).cpu()
        assert torch.equal(got, morphology.video_open(video, plane))
    half = morphology.video_open(video.to(card).half(), "hw")
    assert half.dtype == torch.float16
    assert torch.equal(half.float().cpu(), morphology.video_open(video, "hw"))


@pytest.mark.parametrize("view", ["ncdhw", "transposed", "sliced",
                                  "swapped_axes"])
@pytest.mark.gpu
def test_strided_kernel_equals_plain_on_a_view(card, view):
    g = torch.Generator(device=card).manual_seed(2)
    if view == "ncdhw":           # a model's (B, 1, T, H, W) mask
        x = torch.rand((4, 1, 16, 64, 48), generator=g,
                       device=card).permute(0, 2, 3, 4, 1)
        axes = (1, 2)
    elif view == "swapped_axes":
        x = torch.rand((2, 6, 20, 30, 3), generator=g, device=card)
        axes = (3, 2)
    else:
        x = torch.rand((3, 40, 60), generator=g, device=card)
        x = x.transpose(1, 2) if view == "transposed" else x[:, ::2, 1::3]
        axes = (1, 2)
    before = morphology.open_planes_cuda.launches
    got = morphology.open_planes_cuda(x, 5, axes)
    torch.cuda.synchronize()
    assert morphology.open_planes_cuda.launches == before + 1
    assert got.is_contiguous()
    assert torch.equal(got.cpu(), morphology.morphology_open(x.cpu(), 5,
                                                             axes))


@pytest.mark.parametrize("tile", [(16, 8, 32), (8, 16, 32), (4, 7, 16),
                                  (16, 4, 128), (3, 5, 1)])
@pytest.mark.gpu
def test_any_tile_gives_the_same_opening(card, tile):
    g = torch.Generator(device=card).manual_seed(3)
    video = (torch.rand((2, 16, 40, 96, 1), generator=g, device=card)
             > 0.5).float()
    got = morphology.open_planes_cuda(video, 5, (1, 2), tile)
    assert torch.equal(got.cpu(), morphology.video_open(video.cpu(), "th"))


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
                 "rot45": (4, 4, 140, 128, 45.0),
                 # T off the kernel's group of frames, pixels off its chunk
                 "t18": (2, 18, 37, 32, 10.0)}


def _augment_inputs(card, b, t, s, isize, degrees, seed=0, channels=(3, 3, 1)):
    g = torch.Generator(device=card).manual_seed(seed)
    cd, cr, cm = channels
    data = torch.randint(0, 256, (b, t, s, s, cd), generator=g, device=card,
                         dtype=torch.uint8)
    real = torch.randint(0, 256, (b, t, s, s, cr), generator=g, device=card,
                         dtype=torch.uint8)
    mask = (torch.rand((b, t, s, s, cm), generator=g, device=card) > 0.5
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


@pytest.mark.parametrize("channels", [(1, 1, 1), (1, 2, 1), (4, 3, 4),
                                      (3, 3, 3), (2, 5, 1)])
@pytest.mark.gpu
def test_augment_kernel_takes_other_channel_counts(card, channels):
    streams, _, src_x, src_y = _augment_inputs(card, 2, 5, 37, 33, 10.0,
                                               channels=channels)
    before = augment.augment_gather_cuda.launches
    got = augment.augment_gather(*streams, src_x, src_y)
    torch.cuda.synchronize()
    assert augment.augment_gather_cuda.launches == before + 1
    want = augment.augment_gather_plain(*streams, src_x, src_y)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)


@pytest.mark.gpu
def test_augment_kernel_fills_pixels_outside_the_source(card):
    """Every coordinate outside the source: the tables' entry 0 everywhere
    (-1 for video, 0 for the mask), and no read of the streams."""
    streams, _, src_x, src_y = _augment_inputs(card, 2, 4, 35, 32, 10.0)
    for shift in (1000.0, -1000.0):
        got = augment.augment_gather(*streams, src_x + shift, src_y)
        want = augment.augment_gather_plain(*streams, src_x + shift, src_y)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert (got[0] == -1).all() and (got[2] == 0).all()


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


# The bfloat16 form: the nine shapes of a clstm step, a ragged case for H, W
# and every channel count the kernel pads (Cin off 16 in both forms, Cout
# off 2: scalar stores), and one past a block's 64 output channels.
BF16_CONV_CASES = {k: CONV_CASES[k] for k in (
    "F1", "F2", "F3", "F4", "F5", "D1", "D2", "D3", "D4", "ragged",
    "ragged_hw", "ragged_packed", "one_channel", "two_slices")}


def _within_bf16_ulp(got, want, x, k, what):
    """At least 99% of the elements equal, every one within one bfloat16
    ulp beyond what two float32 sums of the K = 9 Cin products may differ
    by in any two orders, one truncating (``spatial_conv.conv_sum_slack``):
    float32 sums in another order may land on the other side of a rounding
    boundary, and a sum that cancels to near 0 is off by many ulps of
    itself."""
    ulps = spatial_conv.bf16_ulps(got, want,
                                  spatial_conv.conv_sum_slack(x, k))
    equal = (got.float() == want.float()).float().mean().item()
    assert equal >= 0.99 and ulps.max().item() <= 1.0, \
        (what, equal, ulps.max().item())


@pytest.mark.parametrize("case", list(BF16_CONV_CASES))
@pytest.mark.gpu
def test_conv3x3_bf16_kernel_matches_plain_on_card(card, case):
    """The bfloat16 kernel against its plain version, bf16 operands with
    float32 sums rounded once, forward and with ``flip``; it counts its
    launches apart from the float32 kernel's."""
    n, h, w, cin, cout = BF16_CONV_CASES[case]
    x, k, _ = _conv_inputs(card, n, h, w, cin, cout)
    x, k = x.bfloat16(), k.bfloat16()
    f32, bf16 = (spatial_conv.conv3x3_cuda.launches,
                 spatial_conv.conv3x3_cuda.launches_bf16)
    got = spatial_conv.conv3x3_cuda(x, k)
    assert got.dtype == torch.bfloat16
    _within_bf16_ulp(got, spatial_conv.conv3x3_plain(x, k), x, k, case)
    # dx's launch: dy (Cout channels) by the forward's weights, flipped
    g = torch.randn((n, h, w, cout), device=card).bfloat16()
    kf = k.flip(0, 1).transpose(2, 3).contiguous()     # (3, 3, Cout, Cin)
    _within_bf16_ulp(spatial_conv.conv3x3_cuda(g, k, flip=True),
                     spatial_conv.conv3x3_plain(g, kf), g, kf,
                     f"{case} flip")
    assert spatial_conv.conv3x3_cuda.launches == f32
    assert spatial_conv.conv3x3_cuda.launches_bf16 == bf16 + 2


@pytest.mark.parametrize("case", ["F4", "D2", "ragged", "ragged_packed"])
@pytest.mark.gpu
def test_conv3x3_bf16_vjp_against_float64_autograd(card, case):
    """Through ``conv3x3`` on a bfloat16 input and a float32 weight: dx
    bfloat16 within one ulp of float64 autograd on the same bf16 values
    (one rounding of float32 sums) beyond the sums' own spread, K 2^-22
    sum |dy w| (see ``_within_bf16_ulp``); dw float32 within 1e-4
    (products of bf16 operands are exact in float32; TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x, k, dy = _conv_inputs(card, *CONV_CASES[case])
    x, dy = x.bfloat16(), (dy * 100).bfloat16()
    xa, ka = x.clone().requires_grad_(), k.clone().requires_grad_()
    y = spatial_conv.conv3x3(xa, ka)
    assert y.dtype == torch.bfloat16
    y.backward(dy)
    assert xa.grad.dtype == torch.bfloat16 and ka.grad.dtype == torch.float32
    xb = x.double().requires_grad_()
    kb = k.bfloat16().double().requires_grad_()
    spatial_conv.conv3x3_plain(xb, kb).backward(dy.double())
    flipped = k.bfloat16().flip(0, 1).transpose(2, 3)
    slack = spatial_conv.conv_sum_slack(dy, flipped)
    assert spatial_conv.bf16_ulps(xa.grad, xb.grad, slack).max().item() <= 1.0
    torch.testing.assert_close(ka.grad, kb.grad.float(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.gpu
def test_conv3x3_bf16_kernel_refuses_what_it_does_not_take(card):
    x, k, _ = _conv_inputs(card, 2, 8, 8, 16, 8)
    x, k = x.bfloat16(), k.bfloat16()
    with pytest.raises(TypeError):           # one dtype for x and w
        spatial_conv.conv3x3_cuda(x, k.float())
    with pytest.raises(TypeError):
        spatial_conv.conv3x3_cuda(x.float(), k)
    with pytest.raises(ValueError):
        spatial_conv.conv3x3_cuda(x.transpose(1, 2), k)
    with pytest.raises(ValueError):
        spatial_conv.conv3x3_cuda(x, k.transpose(2, 3))


@pytest.mark.gpu
def test_clstm_bf16_train_step_on_card_matches_cpu(card, tmp_path):
    """One bfloat16 clstm step on the card against the CPU, from the same
    weights and augment draws: the loss within 1e-2 relative, updated
    parameters within Adam's first-step envelope of 2.5 lr, the gradient
    (Adam's first moment) within 3e-2 by its median parameter and as a
    whole, where the card's step on the clip reversed in time and mirrored
    misses it, as tests/test_torch_port_bf16_step.py holds the port to
    JAX; running means and variances within 2e-2 as a whole (relative L2); the gate convs ran
    on the bf16 kernel and never on the float32 one."""
    from vfd_gan_tpu_torch.config import Config
    from vfd_gan_tpu_torch.ops.augment import _src_coords, augment_gather
    from vfd_gan_tpu_torch.ops.augment import staging_size
    from vfd_gan_tpu_torch.train.state import relative_distances
    from vfd_gan_tpu_torch.train.supervised_engine import SupervisedEngine

    b, t, isize = 2, 8, 32
    cfg = Config(model="clstm", batchsize=b, nfr=t, isize=isize, ep=1,
                 tensorboard=False, result_root=str(tmp_path)).validate()
    assert cfg.compute_dtype == "bfloat16"
    s = staging_size(isize)
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, (b, t, s, s, 3), dtype=np.uint8)
    mask = np.zeros((b, t, s, s, 1), np.uint8)
    mask[:, :, 4:s - 4, 5:s - 6] = 255
    draws = (np.linspace(-0.17, 0.15, b).astype(np.float32),
             np.arange(b) % 2, np.ones(b, np.int64), np.arange(b) % 2 == 0)
    src = [c.contiguous() for c in _src_coords(
        *(torch.from_numpy(np.asarray(v)) for v in draws), s, isize)]
    out, nets = {}, {}
    for run, clip in (("cpu", data), ("cuda", data),
                      ("control", data[:, ::-1, :, ::-1].copy())):
        device = torch.device("cpu" if run == "cpu" else "cuda")
        eng = SupervisedEngine(cfg, None, None, device=device)
        batch = [torch.from_numpy(v).to(device) for v in (clip, clip, mask)]
        x, _, gt = augment_gather(*batch, *(c.to(device) for c in src))
        f32, bf16 = (spatial_conv.conv3x3_cuda.launches,
                     spatial_conv.conv3x3_cuda.launches_bf16)
        loss = float(eng._step(x, gt)["loss/err/train"])
        if run == "cuda":
            assert spatial_conv.conv3x3_cuda.launches == f32
            assert spatial_conv.conv3x3_cuda.launches_bf16 > bf16
        nets[run] = eng.net
        out[run] = (loss, {k: v.cpu() for k, v in
                           eng.model.state_dict().items()})
    (l_cpu, sd_cpu), (l_gpu, sd_gpu) = out["cpu"], out["cuda"]
    assert np.isfinite(l_gpu) and abs(l_gpu - l_cpu) <= 1e-2 * abs(l_cpu)
    for kind in ("running_mean", "running_var"):
        keys = [k for k in sd_cpu if k.endswith(kind)]
        assert relative_distances({k: sd_gpu[k] for k in keys},
                                  {k: sd_cpu[k] for k in keys})[1] <= 2e-2
    for k, v in sd_cpu.items():
        if "running" not in k and not k.endswith("num_batches_tracked"):
            assert (sd_gpu[k] - v).abs().max().item() <= 2.5 * cfg.lr, k
            assert sd_gpu[k].dtype == torch.float32, k
    want = nets["cpu"].first_moments()
    median, whole = relative_distances(nets["cuda"].first_moments(), want)
    control, _ = relative_distances(nets["control"].first_moments(), want)
    assert median <= 3e-2 and whole <= 3e-2 < control, (median, whole,
                                                        control)


# -- the training run loop on the card -----------------------------------------

def _host_batches(n, b=4, t=8, s=36, seed=0):
    rng = np.random.default_rng(seed)
    return [{"data": rng.integers(0, 256, (b, t, s, s, 3), dtype=np.uint8),
             "real": rng.integers(0, 256, (b, t, s, s, 3), dtype=np.uint8),
             "mask": rng.integers(0, 2, (b, t, s, s, 1), dtype=np.uint8) * 255,
             "label": rng.uniform(size=(b, t)).astype(np.float32),
             "index": np.arange(b, dtype=np.int32) + i * b}
            for i in range(n)]


@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.gpu
def test_pinned_prefetch_equals_the_host_batches(card, depth):
    """Order, count and every byte, with more batches than staging
    buffers (each pinned buffer is rewritten several times); ``index``
    stays on the host; the copies ran on a side stream, each before the
    event its batch was yielded behind."""
    from vfd_gan_tpu_torch.parallel.prefetch import device_prefetch

    batches = _host_batches(11)
    events: list = []
    out = []
    for got in device_prefetch(iter(batches), card, depth=depth,
                               h2d_events=events):
        # keep the card busy, so later copies overlap queued work
        torch.mm(torch.ones(2048, 2048, device=card),
                 torch.ones(2048, 2048, device=card))
        out.append(got)
    assert len(out) == len(batches) == len(events)
    for got, want in zip(out, batches):
        assert isinstance(got["index"], np.ndarray)
        np.testing.assert_array_equal(got["index"], want["index"])
        for k in ("data", "real", "mask", "label"):
            assert got[k].device.type == "cuda"
            np.testing.assert_array_equal(got[k].cpu().numpy(), want[k])
    torch.cuda.synchronize()
    assert all(s.elapsed_time(e) > 0 for s, e in events)


@pytest.mark.gpu
def test_prefetch_passes_device_batches_through_and_stops_early(card):
    import threading

    from vfd_gan_tpu_torch.data.device_synthetic import (
        DeviceSyntheticIterator,
    )
    from vfd_gan_tpu_torch.parallel.prefetch import device_prefetch

    it = DeviceSyntheticIterator(2, 8, 16, n_batches=3, seed=1, device=card)
    before = threading.active_count()
    got = list(device_prefetch(it, card))
    assert threading.active_count() == before      # no staging thread
    assert all(torch.equal(g["data"], it.batch(0, i)["data"])
               for i, g in enumerate(got))
    gen = device_prefetch(iter(_host_batches(50)), card, depth=2)
    first = next(gen)
    assert first["data"].device.type == "cuda"
    gen.close()                                    # the consumer leaves
    assert threading.active_count() == before


_STATE_NETS = {
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
    "anogan": ["--model", "anogan", "--batchsize", "2", "--nfr", "8",
               "--isize", "16"],
    "ganomaly": ["--model", "ganomaly", "--batchsize", "2", "--nfr", "8",
                 "--isize", "16"],
}
_STATE_COMMON = ["--compute_dtype", "float32", "--no-tensorboard",
                 "--synthetic_data", "4", "--synthetic_test_batches", "1",
                 "--synthetic_thick_masks", "--ep", "1", "--freq", "1000"]


def _tree_equal(a, b):
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
    if isinstance(a, dict):
        return list(a) == list(b) and all(_tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_tree_equal, a, b))
    return a == b


@pytest.mark.parametrize("net", list(_STATE_NETS))
@pytest.mark.gpu
def test_train_state_round_trip_on_the_card(card, tmp_path, net):
    """Two steps with an autosave, then a fresh engine with ``--resume``:
    every parameter, BN buffer, Adam moment and step, the CUDA generator's
    state, the cursor and the best scores equal what was saved, the tensors
    back on the card; ``latest.pt`` reads with ``weights_only``."""
    from vfd_gan_tpu_torch.cli import trainer

    argv = [*_STATE_NETS[net], *_STATE_COMMON, "--device", "cuda"]
    first = trainer.main([*argv, "--max_steps", "2", "--autosave_every", "2",
                          "--result_root", str(tmp_path / "a")])
    latest = f"{first.dirs.weights}/latest.pt"
    saved = torch.load(latest, map_location="cpu", weights_only=True)
    assert saved["step"] == 2 and saved["loop"]["device"] == "cuda"
    assert _tree_equal(saved, first._ckpt_tree())
    second = trainer.build_engine([*argv, "--resume", latest,
                                   "--result_root", str(tmp_path / "b")])
    assert _tree_equal(second._ckpt_tree(), saved)
    assert (second.global_step, second.epoch, second.batch_in_epoch) \
        == (2, 0, 2)
    for state in second._nets().values():
        assert all(p.is_cuda for p in state.module.parameters())
        moments = state.optimizer.state_dict()["state"]
        assert moments and all(m["exp_avg"].is_cuda
                               and float(m["step"]) == 2.0
                               for m in moments.values())
    second.train()                    # and it goes on from the cursor
    assert second.global_step == 4 and len(second.step_seconds) == 2
    second.close()


@pytest.mark.gpu
def test_resume_refuses_a_generator_state_across_devices(card, tmp_path):
    from vfd_gan_tpu_torch.cli import trainer

    argv = [*_STATE_NETS["clstm"], *_STATE_COMMON, "--max_steps", "1",
            "--autosave_every", "1"]
    on_card = trainer.main([*argv, "--device", "cuda", "--result_root",
                            str(tmp_path / "a")])
    on_cpu = trainer.main([*argv, "--device", "cpu", "--result_root",
                           str(tmp_path / "b")])
    # the two generators' states do not even have one size
    assert on_card.rng.get_state().shape != on_cpu.rng.get_state().shape
    for saved_on, run_on, engine in (("cuda", "cpu", on_card),
                                     ("cpu", "cuda", on_cpu)):
        with pytest.raises(SystemExit, match=f"saved on device '{saved_on}' "
                                             f"and cannot continue on "
                                             f"'{run_on}'"):
            trainer.build_engine([*argv, "--device", run_on, "--resume",
                                  f"{engine.dirs.weights}/latest.pt",
                                  "--result_root", str(tmp_path / "c")])


def _sd(module) -> dict:
    return {k: v.detach().cpu() for k, v in module.state_dict().items()}


def _steps_close(cpu, gpu, lr: float, d_rtol: float = 5e-4) -> None:
    """Updated parameters within Adam's first-step envelope of 2.5 lr; BN
    running statistics within 1e-5 relative plus ``d_rtol`` of each
    vector's largest value."""
    for k, v in cpu.items():
        if k.endswith("num_batches_tracked"):
            assert torch.equal(gpu[k], v), k
        elif "running" in k:
            bound = 1e-5 * v.abs() + 1e-5 + d_rtol * v.abs().max()
            assert ((gpu[k] - v).abs() <= bound).all(), k
        else:
            assert (gpu[k] - v).abs().max() <= 2.5 * lr, k


@pytest.mark.parametrize("train_mode", [True, False])
@pytest.mark.gpu
def test_anogan_step_on_card_matches_cpu(card, tmp_path, train_mode):
    """One float32 ``_ano_core`` on the card and on the CPU from the same
    seeded weights, z and dropout masks (a CPU generator for both), TF32
    off: losses 1e-5 + 5e-4 relative (D's train-mode BatchNorms), G's
    video 1e-5, parameters 2.5 lr, running statistics as ``_steps_close``;
    in train mode and in the ``--ref_mode_quirks`` latch."""
    from vfd_gan_tpu_torch.config import Config
    from vfd_gan_tpu_torch.train.anogan_engine import AnoGanEngine
    from vfd_gan_tpu_torch.utils.runtime import resolve_device

    resolve_device("cuda")
    cfg = Config(model="anogan", batchsize=2, nfr=16, isize=32, ep=1,
                 compute_dtype="float32", tensorboard=False,
                 result_root=str(tmp_path))
    rng = np.random.default_rng(3)
    real = torch.from_numpy(rng.uniform(-1, 1, (2, 16, 32, 32, 3)).astype(
        np.float32))
    z = torch.from_numpy(rng.standard_normal((2, 100)).astype(np.float32))
    out = {}
    for device in ("cpu", "cuda"):
        eng = AnoGanEngine(cfg, None, None, device=torch.device(device))
        metrics, fake = eng._ano_core(
            real.to(device), z.to(device),
            torch.Generator().manual_seed(7), train_mode)
        out[device] = ({k: float(v) for k, v in metrics.items()},
                       fake.cpu(), _sd(eng.netg), _sd(eng.netd))
        eng.close()
    (m_cpu, f_cpu, g_cpu, d_cpu), (m_gpu, f_gpu, g_gpu, d_gpu) = \
        out["cpu"], out["cuda"]
    for k, v in m_cpu.items():
        assert abs(m_gpu[k] - v) <= 1e-5 + 5e-4 * abs(v), k
    assert (f_gpu - f_cpu).abs().max() <= 1e-5
    _steps_close(g_cpu, g_gpu, 5 * cfg.lr, 0.0)
    _steps_close(d_cpu, d_gpu, cfg.lr)


@pytest.mark.gpu
def test_ganomaly_step_on_card_matches_cpu(card, tmp_path):
    """One float32 ``_ganomaly_core`` on the card and on the CPU from the
    same seeded weights and frames, TF32 off: losses 1e-6 + 1e-5 relative,
    parameters 2.5 lr, running statistics as ``_steps_close``."""
    from vfd_gan_tpu_torch.config import Config
    from vfd_gan_tpu_torch.train.ganomaly_engine import GanomalyEngine, fold
    from vfd_gan_tpu_torch.utils.runtime import resolve_device

    resolve_device("cuda")
    cfg = Config(model="ganomaly", batchsize=2, nfr=8, isize=32, ep=1,
                 compute_dtype="float32", tensorboard=False,
                 result_root=str(tmp_path))
    clip = torch.from_numpy(np.random.default_rng(4).uniform(
        -1, 1, (2, 8, 32, 32, 3)).astype(np.float32))
    out = {}
    for device in ("cpu", "cuda"):
        eng = GanomalyEngine(cfg, None, None, device=torch.device(device))
        metrics, _ = eng._ganomaly_core(fold(clip.to(device)))
        out[device] = ({k: float(v) for k, v in metrics.items()},
                       _sd(eng.netg), _sd(eng.netd))
        eng.close()
    (m_cpu, g_cpu, d_cpu), (m_gpu, g_gpu, d_gpu) = out["cpu"], out["cuda"]
    for k, v in m_cpu.items():
        assert abs(m_gpu[k] - v) <= 1e-6 + 1e-5 * abs(v), k
    _steps_close(g_cpu, g_gpu, cfg.lr)
    _steps_close(d_cpu, d_gpu, cfg.lr)


@pytest.mark.gpu
def test_score_sweep_on_card_matches_numpy(card):
    """``--device_scoring``'s metrics on the card against the host path's
    numpy ones on 4M pixels of ties and fractional gt: roc, eer and pr
    1e-5, f1 1e-6."""
    from vfd_gan_tpu_torch.eval import metrics as host
    from vfd_gan_tpu_torch.eval.device_metrics import score_sweep

    rng = np.random.default_rng(5)
    gts = (rng.uniform(0, 1, (2, 8, 16, 128, 128, 1)) > 0.97).astype(
        np.float32)
    gts[0, 0, 0, :8] = 0.5                        # truncated to 0
    preds = np.round(np.clip(rng.normal(0.2, 0.2, gts.shape) + 0.4 * gts,
                             0, 1) * 255).astype(np.float32) / 255
    got = [float(v) for v in score_sweep(torch.from_numpy(gts).cuda(),
                                         torch.from_numpy(preds).cuda())]
    labels = np.asarray(gts, dtype=np.int32).ravel()
    auc, eer, _, _ = host.roc_auc_with_eer(labels, preds.ravel())
    assert abs(got[0] - auc) < 1e-5 and abs(got[1] - eer) < 1e-5
    assert abs(got[2] - host.pr_auc(labels, preds.ravel())[0]) < 1e-5
    assert abs(got[3] - host.f1_at(labels, preds.ravel())) < 1e-6


def _spread_close(what: str, got: dict, want: dict, again: dict) -> None:
    """``got`` within 4 x the spread of two runs of the same thing
    (``tools/step_reference.within_spread``)."""
    from vfd_gan_tpu_torch.tools.step_reference import within_spread

    dist, spread, ok = within_spread(got, want, again)
    assert ok, (what, dist, spread)


@pytest.mark.gpu
def test_accum_step_on_card_matches_its_manual_reference(card, tmp_path):
    """One ``--accum 2`` MyGAN step on the card (the fused flow kernel per
    microbatch, dropout on) against the same step by hand from the same
    state, SGD(1.0) so that the update is the averaged gradient: the
    updates (but those of conv biases under a BatchNorm, float noise)
    within the spread of two hand-made steps; the running statistics'
    counters equal (G's moved twice, D's four times)."""
    from vfd_gan_tpu_torch.config import Config
    from vfd_gan_tpu_torch.tools.step_reference import manual_gan_accum
    from vfd_gan_tpu_torch.train.gan_engine import MyGanEngine
    from vfd_gan_tpu_torch.utils.runtime import resolve_device

    resolve_device("cuda")
    cfg = Config(model="mygan", isize=64, nfr=16, batchsize=4, ngf=8,
                 ndf=8, accum=2, ep=1, compute_dtype="float32",
                 tensorboard=False, result_root=str(tmp_path)).validate()
    rng = np.random.default_rng(4)
    data = torch.from_numpy(rng.uniform(-1, 1, (4, 16, 64, 64, 3)).astype(
        np.float32)).to(card)
    gt = torch.from_numpy((rng.uniform(size=(4, 16, 64, 64, 1)) > 0.85
                           ).astype(np.float32)).to(card)
    engines = [MyGanEngine(cfg, None, None, device=card) for _ in range(3)]
    before = {attr: {k: v.clone() for k, v in
                     _sd(getattr(engines[0], attr)).items()}
              for attr in ("netg", "netd")}
    for i, eng in enumerate(engines):
        for net in (eng.g, eng.d):
            net.optimizer = torch.optim.SGD(net.module.parameters(), lr=1.0)
        drop = torch.Generator(device=card).manual_seed(3)
        if i == 0:
            eng._gan_core(data, gt, drop)
        else:
            manual_gan_accum(eng, data, gt, 2, drop)
    for attr in ("netg", "netd"):
        sds = [_sd(getattr(e, attr)) for e in engines]
        params = [n for n, _ in getattr(engines[0], attr).named_parameters()]
        steps = [{n: sd[n] - before[attr][n] for n in params
                  if not n.endswith(("spatial_conv.bias",
                                     "temporal_conv.bias"))}
                 for sd in sds]
        # conv biases under a BatchNorm (a true gradient of 0) left out
        assert sum(float(v.abs().sum()) for v in steps[0].values()) > 0
        _spread_close(attr, *steps)
        for k, v in sds[1].items():
            if k.endswith("num_batches_tracked"):
                assert int(sds[0][k]) == int(v) == (2 if attr == "netg"
                                                    else 4), k


@pytest.mark.gpu
@pytest.mark.parametrize("blocks", [(), ("dconv1", "uconv1")],
                         ids=["all", "dconv1,uconv1"])
def test_remat_generator_on_card_keeps_plain_buffers(card, blocks):
    """The rematerialized Generator on the card: every buffer
    (``num_batches_tracked`` included) and every gradient as the plain
    Generator's, within the spread of two plain runs (bit for bit where
    those repeat)."""
    from vfd_gan_tpu_torch.models.mygan import Generator
    from vfd_gan_tpu_torch.utils.runtime import resolve_device

    resolve_device("cuda")
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        -1, 1, (2, 3, 16, 64, 64)).astype(np.float32)).to(card)
    runs = []
    for remat in (False, False, True):
        model = Generator(8, remat=remat, remat_blocks=blocks,
                          generator=torch.Generator().manual_seed(0))
        model.to(card).train()
        drop = torch.Generator(device=card).manual_seed(5)
        for _ in range(2):
            model(x, drop).square().mean().backward()
        runs.append(({k: p.grad.detach().cpu()
                      for k, p in model.named_parameters()}, _sd(model)))
    (g1, b1), (g2, b2), (gr, br) = runs
    _spread_close("gradients", gr, g1, g2)
    for k, v in b1.items():
        if k.endswith("num_batches_tracked"):
            assert int(br[k]) == int(v) == 2, k
        elif torch.equal(v, b2[k]):
            assert torch.equal(br[k], v), k
        else:
            assert (br[k] - v).abs().max() <= 4 * (b2[k] - v).abs().max(), k
