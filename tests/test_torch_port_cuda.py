"""The port's CUDA kernel: how its library is built and, on a card, the
kernel against its plain version.

Tests marked ``gpu`` need an NVIDIA card and skip without one.  This file
imports no jax, so on a machine with a card and no jax it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

import shutil

import numpy as np
import pytest
import torch

from vfd_gan_tpu_torch.ops import cuda, morphology


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def test_library_name_follows_the_sources(tmp_path, monkeypatch):
    for src in cuda.sources():
        shutil.copy(src, tmp_path / src.name)
    monkeypatch.setattr(cuda, "SOURCE_DIR", tmp_path)
    first = cuda.library_path()
    assert first == cuda.library_path()
    src = tmp_path / "morphology_open.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert cuda.library_path() != first
    assert cuda.library_path().parent == cuda.BUILD_DIR


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
