"""What a ``--accum`` or ``--remat`` train step is held to: the accumulated
MyGAN step made by hand, and the spread of two runs of one step.

``tests/test_torch_port_accum.py`` holds ``MyGanEngine._gan_core`` under
``--accum`` to ``manual_gan_accum`` bit for bit on the CPU; on a card (its
card tests and ``chip_smoke.py``) the engine's step must lie
``within_spread`` of two hand-made ones, since cuDNN's weight gradients
and the trilinear backward sum with atomics and card steps need not
repeat bit for bit.
"""

from __future__ import annotations

import torch

from vfd_gan_tpu_torch.train.state import relative_distances


def manual_gan_accum(engine, data: torch.Tensor, gt: torch.Tensor, k: int,
                     drop: torch.Generator | None = None) -> dict:
    """One accumulated step of ``engine`` (a ``MyGanEngine``) by hand:
    ``_gan_grads`` on each of the k microbatches, each microbatch's
    ``.grad`` taken out, their sum times ``1 / k`` put back, one step of
    each optimizer; returns the microbatches' mean metrics."""
    nets = (engine.g, engine.d)
    total = [[None] * len(list(n.module.parameters())) for n in nets]
    metrics = []
    for d, g in zip(data.chunk(k), gt.chunk(k)):
        engine._zero_grads()
        metrics.append(engine._gan_grads(d, g, drop)[0])
        for acc, net in zip(total, nets):
            for i, p in enumerate(net.module.parameters()):
                if p.grad is not None:
                    acc[i] = p.grad.clone() if acc[i] is None \
                        else acc[i] + p.grad
    for acc, net in zip(total, nets):
        for a, p in zip(acc, net.module.parameters()):
            p.grad = None if a is None else a * (1.0 / k)
        net.optimizer.step()
    return {n: torch.stack([m[n] for m in metrics]).mean(0)
            for n in metrics[0]}


def within_spread(got: dict, want: dict, again: dict, factor: float = 4.0):
    """``got`` against ``want``, where ``again`` is a second run of what
    made ``want``: the relative L2 distances (median tensor, whole set) of
    ``got`` and of ``again`` from ``want``, and whether each of ``got``'s
    is at most ``factor`` x the spread plus 1e-5."""
    spread = relative_distances(again, want)
    dist = relative_distances(got, want)
    return dist, spread, all(d <= factor * s + 1e-5
                             for d, s in zip(dist, spread))
