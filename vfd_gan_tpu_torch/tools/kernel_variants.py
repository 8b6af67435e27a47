"""Price the design choices of the opening and the augment gather kernels
on the card.

Run from the root of a checkout, on a machine with one NVIDIA card::

    python -m vfd_gan_tpu_torch.tools.kernel_variants

It prints the card's name and power limit, then

* the opening kernel (``ops/cuda/morphology_open.cu``) on the serve
  batch's (8, 16, 128, 128, 1) video in both planes of ``video_open``, k =
  5, for the tile its entry point chooses and for a list of other tiles
  ``(tp, tq, tl)`` (outputs of one block along the two window axes and the
  lanes), each checked bit-equal to the plain version first;
* the augment gather kernel (``ops/cuda/augment_gather.cu``) at the train
  shape (b8, T16, 140^2 -> 128^2, C 3 + 3 + 1) as built, and rebuilt with
  its timing-only options: 1, 2 and 8 frames per block
  (``-DVFD_AUGMENT_FRAMES``) and streaming instead of plain stores
  (``-DVFD_AUGMENT_STREAM_STORES``), each checked bit-equal first.

Times are medians of 20 CUDA event pairs round 10 calls, each pair behind
~3 ms of other work so that it spans device time (as ``chip_smoke.py``
times a kernel).
"""

from __future__ import annotations

import ctypes
import subprocess
import tempfile
from pathlib import Path

import torch

from vfd_gan_tpu_torch.ops import augment, cuda
from vfd_gan_tpu_torch.ops.morphology import open_planes_cuda, video_open
from vfd_gan_tpu_torch.tools.flow_stages import event_ms

VIDEO = (8, 16, 128, 128, 1)
# (tp, tq, tl) per plane; (0, 0, 0) is the entry point's own choice
TILES = {
    "th": [(0, 0, 0), (16, 8, 32), (16, 16, 32), (16, 32, 32), (16, 8, 64),
           (16, 16, 64), (16, 8, 16), (16, 16, 16), (16, 32, 16),
           (16, 64, 16), (16, 16, 8), (16, 32, 8), (16, 64, 8), (8, 16, 16),
           (8, 32, 32)],
    "hw": [(0, 0, 0), (8, 128, 1), (16, 128, 1), (24, 128, 1), (32, 128, 1),
           (64, 128, 1), (16, 64, 1), (32, 64, 1)],
}
AXES = {"th": (1, 2), "hw": (2, 3)}
# label -> nvcc flags of an augment build
AUGMENT_BUILDS = {
    "frames 1": ["-DVFD_AUGMENT_FRAMES=1"],
    "frames 2": ["-DVFD_AUGMENT_FRAMES=2"],
    "frames 8": ["-DVFD_AUGMENT_FRAMES=8"],
    "streaming stores": ["-DVFD_AUGMENT_STREAM_STORES"],
}
ENTRY = "vfd_augment_gather_u8"


def opening(device, lead) -> None:
    g = torch.Generator(device=device).manual_seed(0)
    video = (torch.rand(VIDEO, generator=g, device=device) > 0.5).float()
    for plane, tiles in TILES.items():
        want = video_open(video.cpu(), plane).to(device)
        for tile in tiles:
            try:
                got = open_planes_cuda(video, 5, AXES[plane], tile)
            except RuntimeError as e:
                print(f"opening {plane} tile {tile}: refused ({e})")
                continue
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise SystemExit(f"opening {plane} tile {tile}: not equal to "
                                 "the plain version")
            ms = event_ms(lambda: open_planes_cuda(video, 5, AXES[plane],
                                                   tile), lead)
            print(f"opening {plane} {VIDEO} k=5 tile {tile}: {ms:.4f} ms",
                  flush=True)


def gather(lib, streams, src_x, src_y):
    """``lib``'s augment entry point on the train-shape inputs."""
    b, t, s = streams[0].shape[:3]
    isize = src_x.shape[-1]
    outs = [torch.empty((b, t, isize, isize, v.shape[-1]),
                        dtype=torch.float32, device=v.device)
            for v in streams]
    tables = augment._tables(streams[0].device)
    err = getattr(lib, ENTRY)(
        *(v.data_ptr() for v in streams), src_x.data_ptr(), src_y.data_ptr(),
        *(tb.data_ptr() for tb in tables), *(o.data_ptr() for o in outs), b,
        t, s, isize, *(v.shape[-1] for v in streams),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise SystemExit(f"kernel_variants: {ENTRY} returned cudaError {err}")
    return outs


def augment_builds(device, lead) -> None:
    g = torch.Generator(device=device).manual_seed(0)
    b, t, isize = 8, 16, 128
    s = augment.staging_size(isize)
    streams = [torch.randint(0, 256, (b, t, s, s, c), generator=g,
                             device=device, dtype=torch.uint8)
               for c in (3, 3, 1)]
    params = augment.sample_clip_params(g, b, s, isize)
    src_x, src_y = (c.contiguous() for c in augment._src_coords(
        *params, s, isize))
    want = augment.augment_gather_plain(*streams, src_x, src_y)
    source = cuda.SOURCE_DIR / "augment_gather.cu"
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {}
        for label, flags in AUGMENT_BUILDS.items():
            out = Path(tmp) / (label.replace(" ", "_") + ".so")
            cmd = [cuda._nvcc(), *cuda.NVCC_FLAGS, *flags, "-Xcompiler",
                   "-fno-gnu-unique", "-shared", "-o", str(out), str(source)]
            jobs[label] = (out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        libs = {"as built": cuda.library()}
        for label, (out, proc) in jobs.items():
            text, _ = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"kernel_variants: nvcc failed for {label}:"
                                 f"\n{text[-4000:]}")
            libs[label] = ctypes.CDLL(str(out))
            fn = getattr(libs[label], ENTRY)
            fn.argtypes, fn.restype = cuda.ENTRIES[ENTRY]
        for label, lib in libs.items():
            got = gather(lib, streams, src_x, src_y)
            torch.cuda.synchronize()
            if not all(torch.equal(a, w) for a, w in zip(got, want)):
                raise SystemExit(f"augment [{label}]: not equal to the plain "
                                 "version")
            ms = event_ms(lambda: gather(lib, streams, src_x, src_y), lead)
            print(f"augment b{b} T{t} {s}^2 -> {isize}^2 C 3+3+1 [{label}]: "
                  f"{ms:.4f} ms", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: needs an NVIDIA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    device = torch.device("cuda")
    lead = torch.ones((4096, 4096), device=device)
    for _ in range(200):                 # an idle card runs at a low clock
        torch.mm(lead, lead)
    opening(device, lead)
    augment_builds(device, lead)


if __name__ == "__main__":
    main()
