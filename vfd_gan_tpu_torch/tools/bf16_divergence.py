"""Where a bfloat16 forward on the card parts from the CPU's, module by
module.

    python -m vfd_gan_tpu_torch.tools.bf16_divergence --model xception \
        [--xwidth 0.0625] [--batchsize 2] [--nfr 8] [--isize 32] [--eval]

builds the family's model (the trainer's, ``--dtype`` bfloat16) with
weights drawn from ``--seed``, runs one forward in train mode
(``--eval``: eval mode) on a uniform clip on the card and on the CPU from
the same weights, and prints, for every module without children in
the order they ran, the max-abs difference of its output and the share of
its elements beyond 2^-7 of the CPU's.  A train-mode BatchNorm over few
values per channel turns one ulp of a sum into a different output; this
shows where that starts and how it grows.  It needs a card.
"""

from __future__ import annotations

import argparse
import copy

import torch

from vfd_gan_tpu_torch.config import Config
from vfd_gan_tpu_torch.models import DTYPES, build_mask_model
from vfd_gan_tpu_torch.models.mygan import Generator
from vfd_gan_tpu_torch.utils.runtime import resolve_device


def _recorded_forward(model: torch.nn.Module, x: torch.Tensor,
                      train: bool) -> list:
    """(name, kind, output on the CPU in float32) of every leaf module,
    in the order they ran."""
    seen = []
    hooks = [m.register_forward_hook(
        lambda m, i, o, name=name: seen.append(
            (name, type(m).__name__, o.detach().float().cpu())))
        for name, m in model.named_modules() if not list(m.children())]
    model.train(train)
    with torch.no_grad():
        model(x)
    for hook in hooks:
        hook.remove()
    return seen


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="xception",
                   choices=("mygan", "clstm", "c2plus1d", "xception"))
    p.add_argument("--xwidth", type=float, default=1 / 16)
    p.add_argument("--ngf", type=int, default=8)
    p.add_argument("--batchsize", type=int, default=2)
    p.add_argument("--nfr", type=int, default=8)
    p.add_argument("--isize", type=int, default=32)
    p.add_argument("--dtype", default="bfloat16", choices=tuple(DTYPES))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval", action="store_true")
    args = p.parse_args(argv)
    device = resolve_device("cuda")
    g = torch.Generator().manual_seed(args.seed)
    kw = {"dtype": DTYPES[args.dtype], "generator": g}
    model = Generator(args.ngf, **kw) if args.model == "mygan" else \
        build_mask_model(args.model, Config(model=args.model,
                                            xwidth=args.xwidth), **kw)
    for m in model.modules():
        if hasattr(m, "drop_rate"):
            m.drop_rate = 0.0
    x = torch.rand((args.batchsize, 3, args.nfr, args.isize, args.isize),
                   generator=g) * 2 - 1
    cpu = _recorded_forward(model, x, not args.eval)
    card = _recorded_forward(copy.deepcopy(model).to(device), x.to(device),
                             not args.eval)
    rows = []
    for (name, kind, a), (_, _, b) in zip(cpu, card):
        d = (a - b).abs()
        share = float((d > 2.0 ** -7 * a.abs()).float().mean())
        rows.append((name, kind, float(d.max()), share))
        print(f"{name:32s} {kind:16s} max|d| {float(d.max()):.3g}  "
              f"beyond 2^-7 {share:.4f}")
    return rows


if __name__ == "__main__":
    main()
