"""Training entry point of the port (port of ``vfd_gan_tpu.cli.trainer``).

Takes the JAX trainer's flags (``vfd_gan_tpu_torch.config``, the JAX
package's ``vfd_gan_tpu.config`` restated) plus two of its own::

    python -m vfd_gan_tpu_torch.cli.trainer --model mygan \\
        --tr_plist train.txt --ts_plist test.txt \\
        [--autosave_every 500 [--autosave_async]] [--resume latest.pt] \\
        [--device cuda] [--flow_impl fused|two_kernel|warp]
    python -m vfd_gan_tpu_torch.cli.trainer --model clstm \\
        --synthetic_data 100 [--compute_dtype float32] [--device cuda]

What this port runs: ``--model mygan`` (the GAN engine; ``--ae`` for the
AutoEncoder as G) and ``--model c2plus1d|xception|clstm`` (the supervised
engine) in ``--compute_dtype`` bfloat16 (the default, as in the JAX
trainer) or float32 (TF32 off either way), on mp4 path lists
(``--tr_plist`` and ``--ts_plist``: decoded with cv2 on ``--workers``
threads, copied to the card ``--prefetch`` batches ahead) or on on-device
synthetic data
(``--synthetic_data N`` train batches per epoch,
``--synthetic_test_batches`` per sweep), with autosave, a parked checkpoint
on SIGTERM, exact ``--resume``, TensorBoard panels, ``--cache_gt_flow`` and
``--ref_mode_quirks`` as in the JAX trainer.  Every other choice exits with
the ``ROADMAP.md`` item that holds it.  ``--device`` defaults to ``cuda``
and raises without a card; ``--flow_impl`` applies to MyGAN only.
"""

from __future__ import annotations

import argparse
import sys

from vfd_gan_tpu_torch.config import parse_args
from vfd_gan_tpu_torch.data.dataset import ClipBatchIterator, MdfVideoDataset
from vfd_gan_tpu_torch.data.device_synthetic import DeviceSyntheticIterator
from vfd_gan_tpu_torch.models import SUPERVISED
from vfd_gan_tpu_torch.ops.augment import staging_size
from vfd_gan_tpu_torch.ops.flow import IMPLS
from vfd_gan_tpu_torch.train.gan_engine import MyGanEngine
from vfd_gan_tpu_torch.train.supervised_engine import SupervisedEngine
from vfd_gan_tpu_torch.utils.runtime import resolve_device


def build_iterators(cfg, device):
    """Train and test batch sources with the reference's loader semantics
    (both splits shuffled and drop-last during training, lib/data.py:142):
    batches made on the device under ``--synthetic_data``, else the mp4
    dataset, the train split staged at ``staging_size(isize)`` for the
    augment crop."""
    if cfg.synthetic_data:
        return (DeviceSyntheticIterator(
                    cfg.batchsize, cfg.nfr, staging_size(cfg.isize),
                    n_batches=cfg.synthetic_data, seed=cfg.seed,
                    thick_masks=cfg.synthetic_thick_masks, device=device),
                DeviceSyntheticIterator(
                    cfg.batchsize, cfg.nfr, cfg.isize,
                    n_batches=cfg.synthetic_test_batches, seed=cfg.seed + 1,
                    thick_masks=cfg.synthetic_thick_masks, device=device))
    train_ds = MdfVideoDataset(cfg.tr_plist, cfg.nfr,
                               staging=staging_size(cfg.isize))
    test_ds = MdfVideoDataset(cfg.ts_plist, cfg.nfr, staging=cfg.isize)
    return (ClipBatchIterator(train_ds, cfg.batchsize, shuffle=True,
                              seed=cfg.seed, prefetch=cfg.prefetch,
                              workers=cfg.workers),
            ClipBatchIterator(test_ds, cfg.batchsize, shuffle=True,
                              seed=cfg.seed, prefetch=cfg.prefetch,
                              workers=cfg.workers))


def parse(argv):
    """``(cfg, device name, flow impl)`` from the command line; exits on
    anything the port does not run yet."""
    own = argparse.ArgumentParser(add_help=False)
    own.add_argument("--device", default="cuda",
                     help="cuda (default; raises without a card) or cpu")
    own.add_argument("--flow_impl", choices=IMPLS, default="fused",
                     help="how the flow refinement runs on the card")
    ns, rest = own.parse_known_args(argv)
    cfg = parse_args(rest)
    if cfg.model not in ("mygan",) + SUPERVISED:
        raise SystemExit(f"--model {cfg.model}: not ported to "
                         "vfd_gan_tpu_torch yet (ROADMAP.md queue 1 item "
                         f"10); --model mygan and {'|'.join(SUPERVISED)} "
                         "are")
    if not cfg.synthetic_data and (not cfg.tr_plist or not cfg.ts_plist):
        print("error: --tr_plist and --ts_plist are required "
              "(no hardcoded dataset defaults; or use --synthetic_data N)",
              file=sys.stderr)
        sys.exit(2)
    return cfg, ns.device, ns.flow_impl


def build_engine(argv):
    """The engine for a command line, its iterators attached, not yet run."""
    cfg, device_name, flow_impl = parse(argv)
    device = resolve_device(device_name)
    train_iter, test_iter = build_iterators(cfg, device)
    if cfg.model == "mygan":
        return MyGanEngine(cfg, train_iter, test_iter, device=device,
                           flow_impl=flow_impl)
    return SupervisedEngine(cfg, train_iter, test_iter, device=device)


def main(argv=None):
    """Train; returns the engine (its step times and scores) when done."""
    engine = build_engine(sys.argv[1:] if argv is None else list(argv))
    try:
        engine.train()
    finally:
        engine.close()
    return engine


if __name__ == "__main__":
    main()
