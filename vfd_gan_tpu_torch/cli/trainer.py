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
AutoEncoder as G), ``--model anogan`` and ``--model ganomaly`` (their own
engines) and ``--model c2plus1d|xception|clstm`` (the supervised engine) in
``--compute_dtype`` bfloat16 (the default, as in the JAX trainer) or
float32 (TF32 off either way), on mp4 path lists (``--tr_plist`` and
``--ts_plist``: decoded with cv2 on ``--workers`` threads, copied to the
card ``--prefetch`` batches ahead) or on on-device synthetic data
(``--synthetic_data N`` train batches per epoch,
``--synthetic_test_batches`` per sweep), with autosave, a parked checkpoint
on SIGTERM, exact ``--resume``, TensorBoard panels, ``--cache_gt_flow``,
``--ref_mode_quirks`` and ``--device_scoring`` as in the JAX trainer. Every
other choice exits with the ``ROADMAP.md`` item that holds it. ``--device``
defaults to ``cuda`` and raises without a card; ``--flow_impl`` applies to
MyGAN only.

``--dp N`` trains data-parallel, the same function as ``--dp 1`` over the
global batch (``parallel/mesh.py``): this command starts the N ranks
itself, one process each (``launch_ranks``: NCCL on ``cuda``, each rank
on its own card; gloo on ``--device cpu``) and exits non-zero if one
fails.  N is resolved as in the JAX trainer: on ``cuda`` capped at the
visible cards (``--dp 0``: all of them) and shrunk to a divisor of the
microbatch; on the CPU it is the number of processes.

``--pp N [--pp_micro M]`` (Xception) pipelines the eight middle blocks
over N stages (``parallel/pp_xception.py``, GPipe with M microbatches,
default N): the command starts ``dp x N`` ranks, each stage a process
(on ``cuda`` one card each: N must not pass the visible cards, and dp is
capped at the cards left per stage).
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from vfd_gan_tpu_torch.config import parse_args
from vfd_gan_tpu_torch.data.dataset import ClipBatchIterator, MdfVideoDataset
from vfd_gan_tpu_torch.data.device_synthetic import DeviceSyntheticIterator
from vfd_gan_tpu_torch.models import SUPERVISED
from vfd_gan_tpu_torch.ops.augment import staging_size
from vfd_gan_tpu_torch.ops.flow import IMPLS
from vfd_gan_tpu_torch.parallel.mesh import (
    launch,
    rank_device,
    rank_env,
    rank_group,
    resolve_dp,
)
from vfd_gan_tpu_torch.train.anogan_engine import AnoGanEngine
from vfd_gan_tpu_torch.train.engine_base import refuse_unported
from vfd_gan_tpu_torch.train.gan_engine import MyGanEngine
from vfd_gan_tpu_torch.train.ganomaly_engine import GanomalyEngine
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
    refuse_unported(cfg)
    if not cfg.synthetic_data and (not cfg.tr_plist or not cfg.ts_plist):
        print("error: --tr_plist and --ts_plist are required "
              "(no hardcoded dataset defaults; or use --synthetic_data N)",
              file=sys.stderr)
        sys.exit(2)
    return cfg, ns.device, ns.flow_impl


def build_engine(argv, rank: int | None = None):
    """The engine for a command line, its iterators attached, not yet run
    (on rank ``rank``'s card in a ``--dp`` group)."""
    cfg, device_name, flow_impl = parse(argv)
    device = resolve_device(device_name)
    if rank is not None:
        device = rank_device(device, rank)
    train_iter, test_iter = build_iterators(cfg, device)
    if cfg.model == "mygan":
        return MyGanEngine(cfg, train_iter, test_iter, device=device,
                           flow_impl=flow_impl)
    if cfg.model == "anogan":
        return AnoGanEngine(cfg, train_iter, test_iter, device=device)
    if cfg.model == "ganomaly":
        return GanomalyEngine(cfg, train_iter, test_iter, device=device)
    if cfg.model in SUPERVISED:
        return SupervisedEngine(cfg, train_iter, test_iter, device=device)
    raise ValueError(f"unknown model {cfg.model!r}")


def launch_ranks(argv, dp: int, backend: str,
                 timeout: float | None = None, pp: int = 1) -> None:
    """``argv``'s training as ``dp x pp`` ranks of one group over
    ``backend`` (``"nccl"`` or ``"gloo"``; gloo also runs several ranks
    on one card), each a ``python -m vfd_gan_tpu_torch.cli.trainer``
    process; raises if a rank fails or ``timeout`` seconds pass.  The
    command passes no timeout (a run lasts as long as it trains): a rank
    that hangs makes its peers' next collective fail after the group's
    timeout (``parallel/mesh.rank_group``), which stops every rank."""
    launch("vfd_gan_tpu_torch.cli.trainer", [*argv, "--dp", str(dp)],
           dp * pp, backend, timeout=timeout)


def _train(engine):
    try:
        engine.train()
    finally:
        engine.close()
    return engine


def main(argv=None):
    """Train; returns the engine (its step times and scores) when done,
    or None when ``--dp`` ran the training in ranks of their own."""
    argv = sys.argv[1:] if argv is None else list(argv)
    started = rank_env()
    if started is not None:
        # a rank that launch_ranks started
        rank, world, init_method, backend = started
        # the rank's card is set before its group forms: NCCL needs it
        device = rank_device(resolve_device(parse(argv)[1]), rank)
        if device.type == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        with rank_group(rank, world, init_method, backend):
            return _train(build_engine(argv, rank))
    cfg, device_name, _ = parse(argv)
    kind = resolve_device(device_name).type
    dp = resolve_dp(cfg, kind)
    if dp * cfg.pp > 1:
        try:
            launch_ranks(argv, dp, "nccl" if kind == "cuda" else "gloo",
                         pp=cfg.pp)
        except RuntimeError as e:
            what = f"--dp {dp}" + (f" --pp {cfg.pp}" if cfg.pp > 1 else "")
            raise SystemExit(f"{what}: {e}") from None
        return None
    return _train(build_engine(argv))


if __name__ == "__main__":
    main()
