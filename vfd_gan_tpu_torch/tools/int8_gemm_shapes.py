"""Map the (K, N) shapes that cuBLASLt's int8 GEMM (``torch._int_mm``)
takes on the card, the reason ``ops/int8.int8_matmul`` pads N to a
multiple of 16.

Run from the root of a checkout, on a machine with one NVIDIA card::

    python -m vfd_gan_tpu_torch.tools.int8_gemm_shapes

It prints the card's name and power limit, then for M = 2^17 and 2^20
rows a grid of K (rows) by N (columns), 8 to 256 in steps of 8, of
``torch._int_mm(a (M, K) int8, b (K, N) int8 column-major)``: ``Y`` where
it runs, ``.`` where it raises (``CUBLAS_STATUS_NOT_SUPPORTED``); then
whether ``int8_matmul``, with its padding, runs every shape of the grid
and equals its plain version on one row block.
"""

from __future__ import annotations

import subprocess

import torch

from vfd_gan_tpu_torch.ops.int8 import int8_matmul, int8_matmul_plain

SIZES = range(8, 257, 8)


def _runs(a: torch.Tensor, b_t: torch.Tensor) -> bool:
    try:
        torch._int_mm(a, b_t.t())
        torch.cuda.synchronize()
        return True
    except RuntimeError:
        return False


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("int8_gemm_shapes needs an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], f"torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    a = torch.ones((2 ** 20, max(SIZES)), dtype=torch.int8, device="cuda")
    b = torch.ones((max(SIZES), max(SIZES)), dtype=torch.int8,
                   device="cuda")
    for m in (2 ** 17, 2 ** 20):
        print(f"M {m}: K rows, N columns {SIZES.start}..{max(SIZES)}",
              flush=True)
        for k in SIZES:
            row = "".join(
                "Y" if _runs(a[:m, :k].contiguous(), b[:n, :k].contiguous())
                else "." for n in SIZES)
            print(f"K {k:4d} {row}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randint(-127, 128, (2 ** 17, max(SIZES)), generator=g,
                      device="cuda", dtype=torch.int8)
    w = torch.randint(-127, 128, (max(SIZES), max(SIZES)), generator=g,
                      device="cuda", dtype=torch.int8)
    bad = [(k, n) for k in SIZES for n in SIZES if not torch.equal(
        int8_matmul(x[:, :k], w[:k, :n])[:4096],
        int8_matmul_plain(x[:4096, :k], w[:k, :n]))]
    print(f"int8_matmul (padded): {len(SIZES) ** 2 - len(bad)} of "
          f"{len(SIZES) ** 2} shapes at M {2 ** 17} equal the plain version"
          + (f"; not: {bad}" if bad else ""), flush=True)


if __name__ == "__main__":
    main()
