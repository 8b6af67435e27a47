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

from vfd_gan_tpu_torch.ops import corr, cuda, flow, flow_fused, flow_refine
from vfd_gan_tpu_torch.ops import morphology, warp


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.parametrize("edited", ["morphology_open.cu", "flow_fused.cu",
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
             "vfd_flow_workspace_bytes"}
    assert set(cuda.ENTRIES) == names
    text = "".join(src.read_text() for src in cuda.sources())
    for name in names:
        assert f"extern \"C\" int {name}(" in text \
            or f"extern \"C\" long long {name}(" in text, name


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


# the train step's levels at flow_scale 0.5 and 1.0, a ragged plane, and a
# flow far outside the TPU warp's |fy| <= 3 px band at 64 rows
FLOW_CASES = {"64": (16, 64, 64, 1.0), "32": (16, 32, 32, 1.0),
              "16": (16, 16, 16, 1.0), "128": (4, 128, 128, 1.0),
              "ragged": (3, 24, 40, 1.0), "large_flow": (4, 64, 64, 12.0)}


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


@pytest.mark.parametrize("case", list(FLOW_CASES))
@pytest.mark.gpu
def test_fused_kernel_matches_plain_on_card(card, case):
    n, h, w, scale = FLOW_CASES[case]
    p1, p2, _ = _flow_inputs(card, n, h, w, scale)
    f0 = torch.zeros(n, 2, h, w, device=card)
    before = flow_fused.flow_refine_fused_cuda.launches
    got = flow_fused.flow_refine_fused(p1, p2, f0, 15, 3)
    torch.cuda.synchronize()
    assert flow_fused.flow_refine_fused_cuda.launches == before + 1
    err = (got - flow_fused.flow_refine_fused_plain(p1, p2, f0, 15, 3)).abs()
    assert torch.quantile(err.flatten(), 0.99).item() <= 1e-3
    if h >= 32:
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
