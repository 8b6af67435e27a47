"""The b8 train-step medians of the four ported models on the card, from
the trainer entry point, for comparing two versions of the port in one run.

    python -m vfd_gan_tpu_torch.tools.step_medians [--label change] \\
        [--models mygan,clstm]

trains ``mygan`` (12 steps), ``clstm`` (24), ``c2plus1d`` and ``xception
--xwidth 1.0`` (8 each) at b8, T16, 128^2, float32 on on-device synthetic
data, and prints the card's name and power limit and one JSON line with
each model's median step time in ms after three warm-up steps
(``EngineBase.step_seconds``: host clock, the device synchronised at each
step's end).

It measures the package in the current directory.  To hold a change
against its parent, unpack the parent (``git archive``) into a gitignored
directory and run this file by its path from there, in turns with the
change (parent, change, change, parent), all in one run on one card::

    (cd results/parent_tree && python ../../vfd_gan_tpu_torch/tools/step_medians.py --label parent)

It needs a card.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile

# model -> (steps, extra trainer flags)
RUNS = {"mygan": (12, ["--ngf", "32", "--ndf", "32", "--flow_scale", "0.5"]),
        "clstm": (24, []), "c2plus1d": (8, []),
        "xception": (8, ["--xwidth", "1.0"])}
WARMUP = 3


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--label", default="tree")
    parser.add_argument("--models", default=",".join(RUNS),
                        help="comma-separated, run in this order")
    ns = parser.parse_args(argv)
    sys.path.insert(0, os.getcwd())      # the tree in the current directory
    import torch

    from vfd_gan_tpu_torch.cli.trainer import main as train_main

    if not torch.cuda.is_available():
        raise SystemExit("step_medians: torch.cuda.is_available() is False: "
                         "this needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    medians = {}
    for model in ns.models.split(","):
        steps, extra = RUNS[model]
        with tempfile.TemporaryDirectory() as tmp:
            engine = train_main([
                "--model", model, "--batchsize", "8", "--nfr", "16",
                "--isize", "128", "--compute_dtype", "float32",
                "--synthetic_data", str(steps), "--synthetic_test_batches",
                "1", "--ep", "1", "--freq", str(steps), "--device", "cuda",
                "--no-tensorboard", "--result_root", tmp, *extra])
        medians[model] = 1e3 * statistics.median(
            engine.step_seconds[WARMUP:])
        # the next model starts from an empty allocator: what a run leaves
        # cached shifts a host-bound step (clstm) by a few ms
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    result = {"label": ns.label, "card": card, "step_ms": medians}
    print("STEP_MEDIANS " + json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
