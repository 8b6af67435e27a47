"""The frame-sharded MyGAN Generator (port of
``vfd_gan_tpu.parallel.sp_generator``).

``generator_forward_sp`` is the JAX function's counterpart: the eval-mode
forward of the trained Generator (BatchNorm from its running statistics,
dropout inert) with the clip's frame axis sharded over the ``sp`` peers of
a row, the temporal convs exact through halo exchanges
(``parallel/temporal.py``) and the decoder's align-corners upsample on the
global grid.  The test sweep of ``--sp`` runs its G forward through it.

The sharded forward itself is the Generator's own
(``models/mygan.Generator``, bound to a ``SeqParallel``), the one its
train-mode forward under ``--sp`` runs: where a level's shard count
cannot pool by 2 alone the frames are gathered and the coarser levels run
replicated, as GSPMD reshards there.  The JAX function asserts ``nfr %
(16 sp) == 0``; this one needs only ``nfr % sp == 0`` (the JAX trainer's
rule).
"""

from __future__ import annotations

import torch

from vfd_gan_tpu_torch.parallel.mesh import SeqParallel


def generator_forward_sp(netg, x: torch.Tensor,
                         sp: SeqParallel) -> torch.Tensor:
    """The eval-mode mask ``(B, 1, T/sp, H, W)`` of this rank's frames
    ``x`` ``(B, 3, T/sp, H, W)`` of a clip whose frames are sharded over
    ``sp``'s row (JAX ``generator_forward_sp``): ``netg`` is put in eval
    mode and bound to ``sp`` (its modules that shard frames; a trainer's
    Generator is bound already), and shards its frames for the call, also
    inside a ``DataParallel.local`` block."""
    netg.eval()
    if netg.sp is not sp:
        for m in netg.modules():
            if hasattr(m, "sp"):
                m.sp = sp
    with sp.sharding():
        return netg(x)
