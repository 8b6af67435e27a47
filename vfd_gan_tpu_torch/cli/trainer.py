"""Training entry point of the port (port of ``vfd_gan_tpu.cli.trainer``).

Takes the JAX trainer's flags (``vfd_gan_tpu_torch.config``, the JAX
package's ``vfd_gan_tpu.config`` restated) plus two of its own::

    python -m vfd_gan_tpu_torch.cli.trainer --model mygan \\
        --compute_dtype float32 --synthetic_data 100 [--device cuda] \\
        [--flow_impl fused|two_kernel|warp]
    python -m vfd_gan_tpu_torch.cli.trainer --model clstm \\
        --compute_dtype float32 --synthetic_data 100 [--device cuda]

What this port runs today: ``--model mygan`` (the GAN engine) and
``--model c2plus1d|xception|clstm`` (the supervised engine) in float32
(TF32 off) on on-device synthetic data (``--synthetic_data N`` train
batches per epoch, ``--synthetic_test_batches`` per sweep).  Every other
choice exits with the ``ROADMAP.md`` item that holds it.  ``--device``
defaults to ``cuda`` and raises without a card; ``--flow_impl`` applies to
MyGAN only.
"""

from __future__ import annotations

import argparse
import sys

from vfd_gan_tpu_torch.config import parse_args
from vfd_gan_tpu_torch.data.device_synthetic import DeviceSyntheticIterator
from vfd_gan_tpu_torch.models import SUPERVISED
from vfd_gan_tpu_torch.ops.augment import staging_size
from vfd_gan_tpu_torch.ops.flow import IMPLS
from vfd_gan_tpu_torch.train.gan_engine import MyGanEngine
from vfd_gan_tpu_torch.train.supervised_engine import SupervisedEngine
from vfd_gan_tpu_torch.utils.runtime import resolve_device


def build_iterators(cfg, device):
    """Train and test batch sources (synthetic data only, for now)."""
    return (DeviceSyntheticIterator(
                cfg.batchsize, cfg.nfr, staging_size(cfg.isize),
                n_batches=cfg.synthetic_data, seed=cfg.seed,
                thick_masks=cfg.synthetic_thick_masks, device=device),
            DeviceSyntheticIterator(
                cfg.batchsize, cfg.nfr, cfg.isize,
                n_batches=cfg.synthetic_test_batches, seed=cfg.seed + 1,
                thick_masks=cfg.synthetic_thick_masks, device=device))


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
    if cfg.compute_dtype != "float32":
        raise SystemExit(f"--compute_dtype {cfg.compute_dtype}: not ported "
                         "yet (ROADMAP.md queue 1 item 11); pass "
                         "--compute_dtype float32")
    if not cfg.synthetic_data:
        raise SystemExit("real mp4 data (--tr_plist/--ts_plist) is not "
                         "ported yet (ROADMAP.md queue 1 item 7); use "
                         "--synthetic_data N")
    return cfg, ns.device, ns.flow_impl


def main(argv=None):
    """Train; returns the engine (its step times and scores) when done."""
    cfg, device_name, flow_impl = parse(
        sys.argv[1:] if argv is None else list(argv))
    device = resolve_device(device_name)
    train_iter, test_iter = build_iterators(cfg, device)
    if cfg.model == "mygan":
        engine = MyGanEngine(cfg, train_iter, test_iter, device=device,
                             flow_impl=flow_impl)
    else:
        engine = SupervisedEngine(cfg, train_iter, test_iter, device=device)
    engine.train()
    return engine


if __name__ == "__main__":
    main()
