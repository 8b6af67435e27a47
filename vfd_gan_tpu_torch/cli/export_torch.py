"""Export a port run's train state as reference-format ``.pth`` files
(port of ``vfd_gan_tpu.cli.export_torch``).

Reads a run's full train state (``weights/latest.pt``, written by
``train/checkpoints.save_checkpoint``: autosave or a SIGTERM park) and
writes what the JAX CLI writes from an Orbax directory: ``torch.save(
{'epoch', 'state_dict'})`` files (lib/train_gan.py:52-57) that the
reference's ``test.py``, the port's ``infer``/``serve``/``evaluate_models``
and the JAX package's ``.pth`` import load.

A GAN run (``netG``, ``netD``) gives ``<stem>_netG.pth`` and
``<stem>_netD.pth``, a supervised run (``state``) ``<stem>.pth``; ``<stem>``
is the file's name without its extension and the epoch is the loop's.  The
family is read from the state dict's structure (the JAX CLI's
``_g_kind``, ``_d_kind`` and ``_sup_kind``) and each net is loaded
``strict=True`` into its module before it is written.  GANomaly has no
loadable reference counterpart and is refused, as in JAX.

Usage::

    python -m vfd_gan_tpu_torch.cli.export_torch \\
        --ckpt <run>/weights/latest.pt [--out DIR]
"""

from __future__ import annotations

import argparse
import os

import torch

from vfd_gan_tpu_torch.cli.infer import build_model
from vfd_gan_tpu_torch.models.anogan import AnoDiscriminator, AnoGenerator
from vfd_gan_tpu_torch.models.mygan import DualDisc
from vfd_gan_tpu_torch.train.checkpoints import restore_checkpoint, save_pth
from vfd_gan_tpu_torch.utils.checkpoint import has_module


def _g_kind(sd: dict) -> str:
    if has_module(sd, "dconv1") and has_module(sd, "uconv1"):
        return "mygan_generator"
    if has_module(sd, "down_sep1"):
        return "c2plus1d"                       # --ae generator swap
    if has_module(sd, "layer3") and not has_module(sd, "fc"):
        return "anogan_generator"
    if has_module(sd, "enc1"):
        raise SystemExit(
            "GANomaly checkpoints have no reference .pth counterpart (the "
            "reference's GANomaly is dead code, models/ganomaly.py:18-20)")
    raise SystemExit("cannot infer generator type from checkpoint structure")


def _d_kind(sd: dict) -> str:
    if has_module(sd, "spatdisc"):
        return "mygan_dualdisc"
    if has_module(sd, "fc") and has_module(sd, "layer1"):
        return "anogan_discriminator"
    raise SystemExit(
        "cannot infer discriminator type from checkpoint structure")


def _sup_kind(sd: dict) -> str:
    for kind, module in (("c2plus1d", "down_sep1"), ("xception", "block1"),
                         ("clstm", "clstm1")):
        if has_module(sd, module):
            return kind
    raise SystemExit("cannot infer model type from checkpoint structure")


def _module(kind: str, sd: dict) -> torch.nn.Module:
    """The module of ``kind`` at the widths and clip geometry of ``sd``."""
    if kind in ("mygan_generator", "c2plus1d", "xception", "clstm"):
        return build_model(kind.split("_")[0], sd, torch.device("cpu"),
                           torch.float32)
    if kind == "mygan_dualdisc":
        # spatial linear: 32 ndf x (isize / 64)^2; temporal: 4 ndf x nfr / 8
        ndf = sd["tempdisc.dconv1.conv.temporal_conv.weight"].shape[0]
        side2 = sd["spatdisc.linear.weight"].shape[1] // (32 * ndf)
        nfr = 8 * sd["tempdisc.linear.weight"].shape[1] // (4 * ndf)
        return DualDisc(ndf, nfr, 64 * round(side2 ** 0.5))
    # AnoGAN, whose clips are 16 frames in the reference: its seed Linear
    # gives 512 x (nfr / 8) x (isize / 8)^2 features, D's classifier takes
    # 256 x (nfr / 8) x (isize / 8)^2
    nfr = 16
    if kind == "anogan_generator":
        per_t = sd["layer1.0.weight"].shape[0] // (512 * nfr // 8)
        return AnoGenerator(nfr, 8 * round(per_t ** 0.5))
    per_t = sd["fc.0.weight"].shape[1] // (256 * nfr // 8)
    return AnoDiscriminator(nfr, 8 * round(per_t ** 0.5))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ckpt", required=True,
                   help="a port run's train state (<run>/weights/latest.pt)")
    p.add_argument("--out", default=".",
                   help="output directory for the .pth file(s)")
    return p


def main(argv=None) -> list:
    """Write the files; returns ``[(path, kind), ...]``."""
    args = build_parser().parse_args(argv)
    if os.path.isdir(args.ckpt):
        raise SystemExit(
            f"{args.ckpt} is a directory: Orbax checkpoints need jax; "
            f"`python -m vfd_gan_tpu.cli.export_torch --ckpt {args.ckpt}` "
            "exports them")
    tree = restore_checkpoint(args.ckpt)
    loop = tree.get("loop") or {}
    epoch = int(loop.get("epoch", tree.get("step", 0)))
    stem = os.path.splitext(os.path.basename(args.ckpt))[0]
    os.makedirs(args.out, exist_ok=True)

    if "netG" in tree:
        nets = [(f"{stem}_{net}.pth", tree[net]["module"], kind_of)
                for net, kind_of in (("netG", _g_kind), ("netD", _d_kind))]
    elif "state" in tree:
        nets = [(f"{stem}.pth", tree["state"]["module"], _sup_kind)]
    else:
        raise SystemExit("unrecognised checkpoint tree "
                         f"(keys: {sorted(tree)})")
    written = []
    for name, sd, kind_of in nets:
        kind = kind_of(sd)
        module = _module(kind, sd)
        module.load_state_dict(sd, strict=True)
        path = os.path.join(args.out, name)
        save_pth(path, module, epoch)
        written.append((path, kind))
    for path, kind in written:
        print(f"wrote {path}  [{kind}]")
    return written


if __name__ == "__main__":
    main()
