"""The work of the data-parallel equivalence checks, run by each rank.

    python -m vfd_gan_tpu_torch.tools.dp_equivalence --cases cases.json \\
        --out DIR

    python -m vfd_gan_tpu_torch.tools.dp_equivalence --queue QDIR

Started as the ranks of one group by ``run`` (``parallel/mesh.launch``),
or alone: every rank runs the cases of ``cases.json`` (a list of dicts)
in order and writes ``DIR/{name}.rank{r}.pt``.  With ``--queue`` the
ranks stand (``Standing``): they run one batch of cases after another,
each as ``--cases`` runs its list, until told to stop, so that they start
and reach the card once for many batches.  A case is one of

* ``{"name", "kind": "train", "argv": [...], "steps": n, "float64": bool,
  "bn_stats": str, "flow": "standin" | "real", "sweep": bool, "dp": 1 or
  2, "ref": name}``: the trainer's engine for ``argv`` (``--device cpu``,
  on-device synthetic data) runs ``steps`` train steps, then with
  ``sweep`` one test sweep.  ``"dp": 1`` runs the case on one rank alone
  (rank ``index mod world``), outside the group: a dp-1 reference, whose
  whole state (parameters, buffers, Adam's two moments, each step's
  metrics, the sweep's scores and saved ``.pth`` names) goes to
  ``DIR/{name}.ref.pt``.  A case with ``"ref"`` (a reference listed
  before it) is measured against it on rank 0: for each of those kinds
  the relative L2 distance of the whole set of tensors and the largest
  of any one tensor (``distances``; a ``"ref"`` may be the path of
  another group's reference, without ``.ref.pt``: it is waited for);
  every rank writes a digest of its state, so the ranks' replicas can be
  held equal.  ``float64``: the
  nets, their optimizer state and the batch in float64
  (``EngineBase.to_float64``).  ``bn_stats``: ``"local"`` or
  ``"forward"``, the controls that must miss (``DataParallel``).  ``flow:
  "standin"`` (MyGAN): the flow replaced by a smooth function of the
  video and its synced stretch plus a fixed random field
  (``_standin_flow``), so float64 runs compare to round-off (the flow's
  bfloat16 operand contract does not); ``"own+field"``: the engine's own
  flow (``--host_flow``'s cv2 flow) plus the field.  ``local_ops``: the
  controls of ``--moe_experts``, ``--moe_shards``, ``--int8_disc`` and
  ``--host_flow`` (``DataParallel.local_ops``); ``moe_capacity``: the
  MoE layer's capacity factor (low enough, tokens drop; each step's
  dropped fraction is in the result); ``arith: "dp"``: the reference computes in the dp
  path's BatchNorm arithmetic (``OneProcess``).  Under ``--pp`` the ranks
  form the ``dp x pp`` grid of the whole group, and a reference runs the
  chain per microbatch in one process.  ``save``: the train state after
  the steps written there (rank 0), as ``latest.pt`` is; ``resume``: a
  saved train state restored before the steps, once the nets are in the
  case's precision (``--resume`` in ``argv`` restores it in float32),
  the steps taking the batches after its cursor.
  ``first_grads``: Adam's first moments after the first step
  (``first_exp_avg``: ``1 - beta1`` times the gradient of the first step,
  taken at the weights every run starts from), and the running
  statistics after it (``first_buffers``, read from the first step's
  forward).  ``sweep_at``: the steps after which a test sweep runs (each
  one's scores in ``sweeps``), its effects carried into the next steps;
  ``frame_scores``: each sweep's per-frame labels and scores, where the
  engine keeps them (GANomaly's), the sweeps between the steps first.
  ``sample: n``: each state kind's tensors sketched to ``n`` elements
  (``_sketch``; ``digest``, not in a reference: the whole state's);
  ``no_pth``: the sweeps' best checkpoints recorded by head (``saved``),
  not written (the card's full-width cases, to keep what a run writes
  small).  ``hold_kernels``: every call of the augment gather's, the
  opening's, the fused flow solver's and the 3x3 conv's kernels, in the
  steps and the sweeps, held against its plain version on the same
  inputs (``_held_kernels``; the result's ``kernel_vs_plain``).
* ``{"name", "kind": "gan_core", "argv", "state": path, "data": path,
  "gt": path, "flows": path, "float64": bool}``: one MyGAN ``_gan_core``
  step from the given state dicts on this rank's rows of the given global
  batch, with dropout off and this rank's rows of the given flows (both
  streams) in place of the flow (``float64``: nets, state and inputs);
  the state after it whole (under ``--tp`` the slices gathered).
* ``{"name", "kind": "flow", "video": path, "streams": s, "host":
  bool}``: this rank's rows of each stream of a global video through
  ``minmax_stretch`` and ``video_to_flow_rgb`` (``host``: through
  ``--host_flow``'s cv2 flow); also the whole video alone on rank 0.
  ``"plain_path": true`` (with ``"scale"``): the kernel path with each
  fused-kernel call held against its plain version, then the plain path
  (``_flow_paths``).
* ``{"name", "kind": "step_core", "argv", "state": path,
  "batch": path, "draws": path}``: one supervised or GANomaly step of a
  ``--pp`` or ``--sp`` command line from the given state dict, on this
  rank's part of the given global batch with the given augment draws and
  dropout off (``run_step_core``); AnoGAN's also with the given ``"z"``
  (npy) of the global batch.
* ``{"name", "kind": "handoff", "n_micro"}``: the GPipe schedule of a
  toy block a stage, whose outputs are channels-last (``run_handoff``).
* ``{"name", "kind": "temporal", "inputs": path}``: the frame-axis ops of
  ``parallel/temporal.py`` on this rank's frames, the group one sp row
  (``run_temporal``); ``{"name", "kind": "sp_generator", "ngf", "state",
  "x"}``: ``generator_forward_sp`` likewise (``run_sp_generator``);
  ``{"name", "kind": "sp_nets", "model": "anogan" | "clstm", "state",
  "x", "z"}``: AnoGAN's G and D, or the ConvLSTM, in eval mode on this
  rank's frames (``run_sp_nets``).
* ``{"name", "kind": "moe_layer", "channels", "experts", "shape",
  "capacity", "dtype", "local_ops"}``: the MoE block alone, its experts
  over the whole group as one ep group, forward and backward on seeded
  tokens, against the one-process block on rank 0 (``run_moe_layer``).
* ``{"name", "kind": "tp_block", "block", "cin", "cout", "shape",
  "dtype", "local_ops"}``: one module alone (MyGAN's ``GenConvBlock``,
  an Xception SepaConv, the MoE block, a GANomaly decoder stage),
  column-parallel over the whole group as one tp group, forward and
  backward on a seeded input, against the one-process module on rank 0
  (``run_tp_block``).

``--tp``: a train case's ``argv`` with ``--tp N`` runs on the group as a
``(dp, sp, tp)`` grid; its result holds the channel axis's exchanges per
step (``tp_counts``: the copy-ins' gradient sums and the gathers) and
the elements the rank holds (``tp_elements``: parameters and running
statistics, each Adam moment), and its ``local_ops`` may name the tp
controls (``"tp_bn"``, ``"tp_copy"``, ``"tp_gather"``, ``"tp_mean"``,
``"tp_dropout"``: Xception's decoder dropout drawn on the slice,
``"tp_deconv_dim0"``: GANomaly's transposed weights cut on dim 0);
its references are the same command line in one process
(``OneProcess``: tp 1, every tensor whole).

``--sp``: a train case's ``argv`` with ``--sp N`` runs on the group as a
``(dp, sp)`` grid (``dp`` 2 in the case: in the group), and its result
holds the frame axis's exchanges per step (``sp_counts``, kept beside
the distances); its ``local_ops`` may name the sp controls (``"halo"``,
``"bn_sp"``, ``"stretch_grid"``, ``"dropout_sp"``, ``"carry"``); a flow
case with ``"sp": N`` takes this rank's rows and frames; a gan_core case its
frames of the given batch and flows; an sp_generator case with
``"model": "ae"`` runs the AutoEncoder (``--ae``, c2plus1d) instead of
the Generator.  A train case's ``"ref"`` may be a list: the distances to
the first reference, and ``distances_to`` each of them; with
``"as_ref": true`` a case in the group is a reference too (rank 0's
whole state, ``DIR/{name}.ref.pt``), as the plain sp 2 run is the
``--remat`` runs'.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import hashlib
import json
import os
import signal
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from vfd_gan_tpu_torch.cli import trainer
from vfd_gan_tpu_torch.ops import launches
from vfd_gan_tpu_torch.ops.flow import (
    minmax_stretch,
    stretch_gray,
    video_to_flow_rgb,
)
from vfd_gan_tpu_torch.train.checkpoints import save_checkpoint
from vfd_gan_tpu_torch.parallel.mesh import (
    DataParallel,
    alone,
    launch,
    rank_device,
    rank_env,
    rank_group,
    sp_grid,
)

ENTRY = "vfd_gan_tpu_torch.tools.dp_equivalence"


KINDS = ("params", "buffers", "exp_avg", "exp_avg_sq", "losses")


def _frame_scores(engine) -> dict | None:
    """The last sweep's per-frame labels and scores as tensors, where the
    engine keeps them (``GanomalyEngine.frame_scores``), else None."""
    kept = getattr(engine, "frame_scores", None)
    return None if kept is None else {k: torch.as_tensor(v)
                                      for k, v in kept.items()}


def _state(engine, sample: int | None = None) -> dict:
    """Parameters, buffers and Adam moments of every net, on the CPU;
    with ``sample``, each tensor of more than ``sample`` elements
    sketched where it lies (``_sketch``)."""
    def take(t):
        t = t.detach()
        return (_sketch(t, sample) if sample else t).cpu().clone()

    out = {"params": {}, "buffers": {}, "exp_avg": {}, "exp_avg_sq": {}}
    for net_name, net in engine._nets().items():
        for k, p in net.module.named_parameters():
            out["params"][f"{net_name}.{k}"] = take(p)
            st = net.optimizer.state.get(p, {})
            for m in ("exp_avg", "exp_avg_sq"):
                if m in st:
                    out[m][f"{net_name}.{k}"] = take(st[m])
        for k, b in net.module.named_buffers():
            out["buffers"][f"{net_name}.{k}"] = take(b)
    return out


def _sketch(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t`` if it has at most ``n`` elements, else ``n`` of its elements
    at fixed random places (the same places for a tensor of the same size
    in every run): relative distances between runs read from the sketches
    estimate the whole tensors' while a 203M-parameter Xception's state
    shrinks from 0.8 GB a kind to ~0.1 MB a tensor."""
    if t.numel() <= n:
        return t
    where = torch.randint(t.numel(), (n,),
                          generator=torch.Generator().manual_seed(t.numel()))
    return t.flatten()[where.to(t.device)]


def _trunk_digest(engine) -> str:
    """A hash of every parameter but the rank's experts and channel
    slices (``engine.shards``), bit for bit."""
    own = {id(p) for p in engine.shards.params}
    h = hashlib.sha256()
    for name, net in engine._nets().items():
        for k, p in net.module.named_parameters():
            if id(p) not in own:
                h.update(f"{name}.{k}".encode())
                h.update(p.detach().cpu().contiguous().view(torch.uint8)
                         .numpy().tobytes())
    return h.hexdigest()


def _tp_elements(engine) -> dict:
    """The elements of every net's parameters and running statistics
    (``state``), parameters alone and each Adam moment that this rank
    holds (under ``--tp`` its channel slices)."""
    out = {"state": 0, "params": 0, "exp_avg": 0, "exp_avg_sq": 0}
    for net in engine._nets().values():
        for p in net.module.parameters():
            out["params"] += p.numel()
            state = net.optimizer.state.get(p, {})
            for k in ("exp_avg", "exp_avg_sq"):
                out[k] += state[k].numel() if k in state else 0
        out["state"] += sum(t.numel() for t in (*net.module.parameters(),
                                                *net.module.buffers())
                            if t.dim() >= 1)
    return out


def _expert_elements(engine, moe) -> dict:
    """The elements of the MoE block's expert leaves and of their Adam
    moments that this rank holds, by kind, and of its router."""
    state = engine.net.optimizer.state
    out = {"params": 0, "exp_avg": 0, "exp_avg_sq": 0,
           "router": moe.router.numel()}
    for p in moe.expert_params():
        out["params"] += p.numel()
        for k in ("exp_avg", "exp_avg_sq"):
            out[k] += state[p][k].numel() if k in state.get(p, {}) else 0
    return out


def _digest(result: dict) -> str:
    """A hash of a state's every tensor, bit for bit."""
    h = hashlib.sha256()
    for kind in KINDS[:4]:
        for k in sorted(result[kind]):
            h.update(k.encode())
            h.update(result[kind][k].numpy().tobytes())
    return h.hexdigest()


_INTS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _state_digest(engine) -> str:
    """A digest of the engine's whole state (``_state``'s tensors), bit
    for bit, computed where the tensors lie: each tensor's bit patterns
    summed twice in wrapping int64 arithmetic, plain and weighted by
    position, and only those sums hashed on the host (a full-width
    Xception's state is 2.4 GB a rank, slow to copy to the host and hash
    there)."""
    h = hashlib.sha256()
    for net_name, net in engine._nets().items():
        named = [*net.module.named_parameters(), *net.module.named_buffers()]
        for k, p in named:
            st = net.optimizer.state.get(p, {}) \
                if isinstance(p, torch.nn.Parameter) else {}
            for kind, t in (("", p), *((m, st[m]) for m in
                                       ("exp_avg", "exp_avg_sq")
                                       if m in st)):
                bits = t.detach().reshape(-1).contiguous().view(
                    _INTS[t.element_size()]).long()
                where = torch.arange(bits.numel(), device=bits.device)
                sums = torch.stack([bits.sum(), (bits * (where % 65521 + 1))
                                    .sum()]).cpu().tolist()
                h.update(f"{net_name}.{k}{kind}:{t.dtype}:{sums}".encode())
    return h.hexdigest()


def _losses(result: dict) -> dict:
    return {f"{i}/{k}": torch.tensor(v, dtype=torch.float64)
            for i, step in enumerate(result["losses"])
            for k, v in step.items()}


def distances(got: dict, want: dict) -> dict:
    """Per kind: ``(whole, worst)``, the relative L2 distance of all the
    kind's tensors as one vector, and the largest relative L2 distance of
    one of them (over a nonzero reference tensor)."""
    out = {}
    for kind in KINDS:
        g, w = (_losses(r) if kind == "losses" else r[kind]
                for r in (got, want))
        assert set(g) == set(w), (kind, set(g) ^ set(w))
        diffs = {k: (g[k].double() - w[k].double()).flatten() for k in w}
        refs = {k: w[k].double().flatten() for k in w}
        whole = torch.cat(list(diffs.values())).norm() / torch.cat(
            list(refs.values())).norm()
        worst = max((float(diffs[k].norm() / refs[k].norm())
                     for k in w if refs[k].norm() > 0), default=0.0)
        out[kind] = (float(whole), worst)
    return out


class OneProcess(DataParallel):
    """The dp code path's BatchNorm arithmetic in one process: an active
    group of one rank whose collectives are the identity, so its
    BatchNorms take the two-pass statistics of ``models/layers.py``; its
    other reductions (``local_ops``: the MoE routing, the int8 absmax, the
    flow stretch) are the plain one-process ones.  The reference of the
    cases whose nets amplify the round-off between torch's BatchNorm and
    the two-pass form past the bound in two steps: ``--pp`` with several
    microbatches (per-microbatch statistics over a few values; measured
    1.8e-8 relative in Adam's first moments) and ``--moe_experts``
    (3.2e-8), in one process with no group as much as between the ranks;
    so that what is held is the pipeline's schedule or the layer's global
    reduction, not the BatchNorm's arithmetic (the plain families' dp
    cases hold the two BatchNorm forms to each other, and ``--pp_micro
    1`` is held against the plain step as well)."""

    def __init__(self, device):
        super().__init__(0, 1, True, device)
        self.local_ops = frozenset({"moe", "absmax", "stretch"})

    def all_reduce_sum(self, x, group=None):
        return x

    def all_reduce_max_(self, x, group=None):
        return x

    def mean_grads(self, module, sharded=()) -> None:
        pass

    def mean_metrics(self, metrics: dict) -> dict:
        return metrics

    def any(self, flag: bool) -> bool:
        return bool(flag)


def _standin_flow(engine, smooth: bool = True):
    """The flow stand-in of a float64 MyGAN case: the synced stretch and
    the video, smooth (``smooth``; else the engine's own flow, the
    ``--host_flow`` cases'), plus a fixed random field of the global
    batch's shape (this rank's rows of it), which keeps the temporal D's
    inputs from being near-constant (binary masks, a G output near 0.5 at
    init, cv2's flows of them), where its BatchNorms would amplify
    round-off a millionfold."""
    own = engine._flow

    def flow(video, streams=1):
        dp = engine.dp
        sp = dp.sp if dp.sp is not None and dp.sp.on else None
        b = video.shape[0] // streams
        n = b * dp.world if dp.active else b
        t = video.shape[1] * (sp.size if sp is not None else 1)
        field = torch.rand((streams, n, t, *video.shape[2:]),
                           generator=torch.Generator().manual_seed(7),
                           dtype=video.dtype) * 2 - 1
        rows = dp.rows(n)
        if rows is not None:
            field = field[:, rows]
        if sp is not None:
            field = field[:, :, sp.frame_slice(t)]
        if not smooth:
            return own(video, streams) + field.reshape(video.shape) * 0.5
        gray = stretch_gray(video, streams, dp) / 255.0
        return (torch.tanh(video) + gray[..., None]) * 0.25 \
            + field.reshape(video.shape) * 0.5
    return flow


@contextlib.contextmanager
def _timed_collectives(device: torch.device, record: dict):
    """Every ``all_reduce`` and ``broadcast`` in the block timed (the
    device synchronised around it) and counted under the functions that
    called it."""
    plain = {name: getattr(dist, name) for name in ("all_reduce",
                                                     "broadcast")}

    def timing(fn):
        def timed(tensor, *args, **kwargs):
            caller = sys._getframe(1).f_code.co_name
            label = f"{sys._getframe(2).f_code.co_name}/{caller}"
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            out = fn(tensor, *args, **kwargs)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            ms, n = record.get(label, (0.0, 0))
            record[label] = (ms + 1e3 * (time.perf_counter() - t0), n + 1)
            return out
        return timed

    for name, fn in plain.items():
        setattr(dist, name, timing(fn))
    try:
        yield
    finally:
        for name, fn in plain.items():
            setattr(dist, name, fn)


def run_train(case: dict, root: Path, solo: bool) -> dict:
    device = case.get("device", "cpu")
    rank = DataParallel.current().rank if device == "cuda" else None
    # a dp-1 reference is built outside the group (under --pp: the chain
    # run per microbatch in this process)
    with alone() if solo else contextlib.nullcontext():
        engine = trainer.build_engine(
            [*case["argv"], "--device", device, "--no-tensorboard",
             "--result_root", str(root / case["name"])], rank)
    try:
        if solo and case.get("arith") == "dp":
            engine.dp = OneProcess(engine.device)
            engine._bind_dp()
        engine.dp.bn_stats = case.get("bn_stats", "global")
        if "local_ops" in case:
            engine.dp.local_ops = frozenset(case["local_ops"])
            for axis in (engine.dp.sp, engine.dp.tp):
                if axis is not None:
                    axis.local_ops = engine.dp.local_ops
            if "tp_deconv_dim0" in engine.dp.local_ops:
                # a control of the slicing itself: the slices cut again
                with engine._whole_state():
                    pass
        sp, ep, tp = engine.dp.sp, engine.dp.expert, engine.dp.tp
        for axis in (sp, ep, tp):
            if axis is not None:
                axis.timed = bool(case.get("time_collectives"))
        moe = getattr(getattr(engine, "model", None), "moe", None)
        if "moe_capacity" in case:
            moe.capacity_factor = case["moe_capacity"]
        if case.get("float64"):
            engine.to_float64()
        if "resume" in case:
            # a saved train state restored in the case's precision, as
            # --resume restores it (every expert of --moe_shards loaded,
            # the rank's kept)
            with engine._whole_state():
                engine.restore_into(case["resume"], engine._nets())
            # the loop's cursor: the steps take the batches after it
            engine.train_iter.epoch = engine.epoch
            engine.train_iter.skip_batches = engine.batch_in_epoch
        if case.get("flow") in ("standin", "own+field"):
            engine._flow = _standin_flow(engine, case["flow"] == "standin")
        losses, step_ms, collectives, dropped = [], [], {}, []
        launches.reset()
        if engine.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(engine.device)
        timing = _timed_collectives(engine.device, collectives) \
            if case.get("time_collectives") else contextlib.nullcontext()
        batches = engine._batches(engine.train_iter)
        sample = case.get("sample")
        if case.get("no_pth"):
            # the best checkpoints' names are recorded, not written
            saved_heads = []
            engine._save_weights = saved_heads.append
        held, sweeps, swept, frame_scores, trunk = {}, [], {}, [], []
        sweep_at = set(case.get("sweep_at", ()))
        holding = (lambda: _held_kernels(held)) \
            if case.get("hold_kernels") else contextlib.nullcontext
        with timing, holding():
            for _, batch in zip(range(case["steps"]), batches):
                t0 = time.perf_counter()
                engine.global_step += 1
                engine.batch_in_epoch += 1
                metrics = engine._train_step_impl(batch)
                engine._sync()
                step_ms.append(1e3 * (time.perf_counter() - t0))
                metrics = engine.dp.mean_metrics(metrics)
                losses.append({k: float(v) for k, v in metrics.items()})
                if engine.dp.expert is not None:
                    # the ep group's replicas: one trunk, bit for bit
                    trunk.append(_trunk_digest(engine))
                if case.get("first_grads") and len(losses) == 1:
                    # Adam's first moment after one step: (1 - beta1)
                    # times the first gradient, from the same weights; and
                    # the running statistics that step's forward moved
                    # (under --moe_shards every expert gathered)
                    with engine._whole_state():
                        first_state = _state(engine, sample)
                    first = first_state["exp_avg"]
                    first_buffers = first_state["buffers"]
                if moe is not None:
                    dropped.append(float(moe.aux["dropped_frac"].detach()))
                    if len(losses) == 1:
                        # the first step's routing: each token's slot and
                        # kept flag, this rank's (rows, frames, H, W)
                        first_routing = {k: v.cpu() for k, v in
                                         moe.routing.items()}
                if len(losses) in sweep_at:
                    # a periodic test sweep between the steps, as the
                    # loop runs it at --freq: what it changes (the train
                    # mode nets of --ref_mode_quirks, the --cache_gt_flow
                    # cache) carries into the next steps
                    before = launches.counts()
                    with engine.dp.local():
                        engine.test()
                    sweeps.append({k: float(v)
                                   for k, v in engine.scores.items()})
                    frame_scores.append(_frame_scores(engine))
                    # its launches apart from the steps'
                    for k, n in launches.counts().items():
                        swept[k] = swept.get(k, 0) + n - before.get(k, 0)
                if not solo and engine.dp.grouped:
                    # the ranks start the next step together: what one
                    # did between the steps (a state read, a sweep) is
                    # not timed in another's step
                    dist.barrier()
        if moe is not None:
            # the expert leaves' and their Adam moments' elements this
            # rank holds (under --moe_shards its experts alone)
            out_held = _expert_elements(engine, moe)
        # the state's elements this rank holds (under --tp its slices)
        tp_held = _tp_elements(engine)
        # under --pp every stage's blocks, gathered while read (under
        # --moe_shards every expert)
        with engine._whole_state():
            out = _state(engine, sample)
            if sample and not solo:
                # the whole state's digest (the ranks' replicas held equal)
                out["digest"] = _state_digest(engine)
            if "save" in case and engine.dp.writes:
                save_checkpoint(case["save"], engine._ckpt_tree())
        # the buffers that require grad after the state read (none: a
        # gathered running statistic that did would fail cuDNN's
        # eval-mode BatchNorm)
        out["grad_buffers"] = sorted(
            f"{name}.{k}" for name, net in engine._nets().items()
            for k, b in net.module.named_buffers() if b.requires_grad)
        for key, axis in (("sp_counts", sp), ("ep_counts", ep),
                          ("tp_counts", tp)):
            if axis is not None and step_ms:
                # the frame or expert axis's exchanges per step: [calls,
                # ms]
                out[key] = {k: [n / len(step_ms), ms / len(step_ms)]
                            for k, (n, ms) in axis.counts.items()}
                axis.counts.clear()
        counted = launches.counts()
        out.update(losses=losses, rng=engine.rng.get_state(), sweeps=sweeps,
                   frame_scores=frame_scores,
                   step_ms=step_ms, mid_sweep_launches=swept,
                   launches={k: n - swept.get(k, 0)
                             for k, n in counted.items()},
                   moe_dropped=dropped, collective_ms={
                       k: (ms / len(step_ms), n / len(step_ms))
                       for k, (ms, n) in collectives.items()})
        if engine.device.type == "cuda":
            out["peak_mib"] = torch.cuda.max_memory_allocated(
                engine.device) / 2 ** 20
        pipe = getattr(engine, "pipe", None)
        out["tp_elements"] = tp_held
        if moe is not None:
            out["expert_elements"] = out_held
        if trunk:
            out["trunk_digests"] = trunk
        if pipe is not None:
            out["hand_offs"] = pipe.gpipe.hand_offs
            # the parameter elements this rank holds between gathers
            out["held"] = sum(p.numel() for p in engine.model.parameters())
        if "save" in case and not solo:
            dist.barrier()              # written before any rank reads it
        if case.get("sweep"):
            launches.reset()
            t0 = time.perf_counter()
            with engine.dp.local(), holding():
                engine.test()
            engine._sync()
            out["sweep_ms"] = 1e3 * (time.perf_counter() - t0)
            out["sweep_launches"] = launches.counts()
            for key, axis in (("sweep_sp_counts", sp),
                              ("sweep_ep_counts", ep),
                              ("sweep_tp_counts", tp)):
                if axis is not None:
                    out[key] = {k: list(v) for k, v in axis.counts.items()}
            out["scores"] = {k: float(v) for k, v in engine.scores.items()}
            frame_scores.append(_frame_scores(engine))
            if moe is not None:
                # the eval forward's routing over the sweep's last batch
                out["sweep_moe_dropped"] = float(moe.aux["dropped_frac"])
            out["saved"] = sorted(
                p.name for p in Path(engine.dirs.weights).glob("*.pth")) \
                if engine._writes else None
            if case.get("no_pth"):
                out["saved"] = saved_heads
        if case.get("hold_kernels"):
            out["kernel_vs_plain"] = held
        if case.get("first_grads"):
            out["first_exp_avg"] = first
            out["first_buffers"] = first_buffers
        if moe is not None and losses:
            out["first_routing"] = first_routing
        return out
    finally:
        engine.close()


def _blobs(shape, device) -> torch.Tensor:
    """A binary channel-last ``(B, T, H, W, C)`` mask of blobs about 4
    frames by 8 pixels across: a coarse uniform field, seeded, upsampled
    and thresholded at 0.5."""
    b, t, h, w, c = shape
    g = torch.Generator(device=device).manual_seed(0)
    coarse = torch.rand((b * c, 1, max(1, t // 4), max(1, h // 8),
                         max(1, w // 8)), generator=g, device=device)
    field = F.interpolate(coarse, size=(t, h, w), mode="trilinear")
    return (field > 0.5).float().reshape(b, c, t, h, w).permute(
        0, 2, 3, 4, 1)


def conv3x3_reading(got: torch.Tensor, want: torch.Tensor,
                    x: torch.Tensor, w: torch.Tensor) -> tuple:
    """A 3x3 conv kernel's output against its plain version on the same
    ``x`` and ``w`` (the weights convolved by), by the conv3x3 phases'
    criteria: float32 ``|got - want| <= 1e-5 + 1e-5 |want|`` (the reading:
    the largest ratio of the two sides, <= 1 passes); bfloat16 at least
    99% of the elements equal and every one within one ulp beyond the
    float32 sums' spread (``spatial_conv.conv_sum_slack``; the reading:
    ulps beyond it, <= 1 passes).  Returns ``(reading, passes, equal
    share)``."""
    from vfd_gan_tpu_torch.ops import spatial_conv

    equal = float((got == want).float().mean())
    if got.dtype == torch.bfloat16:
        ulps = float(spatial_conv.bf16_ulps(
            got, want, spatial_conv.conv_sum_slack(x, w)).max())
        return ulps, ulps <= 1.0 and equal >= 0.99, equal
    g, wt = got.double(), want.double()
    ratio = float(((g - wt).abs() / (1e-5 + 1e-5 * wt.abs())).max())
    return ratio, ratio <= 1.0, equal


@contextlib.contextmanager
def _held_kernels(record: dict):
    """A block in which every call of the augment gather
    (``ops/augment.augment_gather``, on a CUDA batch its kernel), of the
    opening (``ops/morphology.morphology_open``, on a CUDA video its
    kernel), of the fused flow solver (``ops/flow.flow_refine_fused``, on
    CUDA fields its kernel; under ``--sp`` the rank's halo'd fields) and
    of the 3x3 conv (``ops/spatial_conv.conv3x3_forward``, forward and dx,
    on CUDA frames its kernel; the ConvLSTM's gates on the rank's frames)
    is also computed by the plain version on the same inputs:
    ``record[name]`` gets each call's largest absolute difference and
    input shape (for the opening its input's and output's fill; for the
    conv ``conv3x3_reading`` with its shape and dtype); each opening is
    also held on ``_blobs`` of its input's shape and layout
    (``morphology_open_blobs``).  The kernel's output on the path's input
    is the one returned, and only its launch is counted."""
    from vfd_gan_tpu_torch.ops import augment, morphology, spatial_conv
    from vfd_gan_tpu_torch.ops import flow as flow_mod
    from vfd_gan_tpu_torch.ops.flow_fused import flow_refine_fused_plain

    gather, opening = augment.augment_gather, morphology.morphology_open
    fused = flow_mod.flow_refine_fused
    conv = spatial_conv.conv3x3_forward

    def held_conv(x, w, flip=False):
        out = conv(x, w, flip)
        k = w.flip(0, 1).transpose(2, 3) if flip else w
        want = spatial_conv.conv3x3_plain(x, k)
        reading, ok, equal = conv3x3_reading(out, want, x, k)
        record.setdefault("conv3x3", []).append(
            (reading, ok, equal, tuple(x.shape), k.shape[-1],
             str(x.dtype).replace("torch.", "")))
        return out

    def held_fused(p1, p2, flow, winsize, iterations):
        out = fused(p1, p2, flow, winsize, iterations)
        want = flow_refine_fused_plain(p1, p2, flow, winsize, iterations)
        record.setdefault("flow_fused", []).append(
            (float((out - want).abs().max()), tuple(p1.shape)))
        return out

    def held_gather(*args):
        outs = gather(*args)
        want = augment.augment_gather_plain(*args)
        record.setdefault("augment_gather", []).append(
            (max(float((o - w).abs().max()) for o, w in zip(outs, want)),
             tuple(args[0].shape)))
        return outs

    def plain_opening(video, k, axes):
        moved = video.float().movedim(axes, (-2, -1))
        want = morphology.open_planes_plain(
            moved.reshape(-1, *moved.shape[-2:]), k)
        return want.reshape(moved.shape).movedim((-2, -1), axes)

    def held_opening(video, k=5, spatial_axes=(-3, -2)):
        out = opening(video, k, spatial_axes)
        axes = tuple(ax % video.dim() for ax in spatial_axes)
        want = plain_opening(video, k, axes)
        record.setdefault("morphology_open", []).append(
            (float((out.float() - want).abs().max()), tuple(video.shape),
             float(video.float().mean()), float(want.mean())))
        # a young G's masks may be empty: the same call on blobs of the
        # same shape and layout too, its launch not counted
        blobs = torch.empty_like(video).copy_(_blobs(video.shape,
                                                     video.device))
        kernel = morphology.open_planes_cuda
        n = kernel.launches
        got = opening(blobs, k, spatial_axes)
        kernel.launches = n
        want = plain_opening(blobs, k, axes)
        record.setdefault("morphology_open_blobs", []).append(
            (float((got.float() - want).abs().max()), tuple(video.shape),
             float(blobs.float().mean()), float(want.mean())))
        return out

    augment.augment_gather = held_gather
    morphology.morphology_open = held_opening
    flow_mod.flow_refine_fused = held_fused
    spatial_conv.conv3x3_forward = held_conv
    try:
        yield
    finally:
        augment.augment_gather = gather
        morphology.morphology_open = opening
        flow_mod.flow_refine_fused = fused
        spatial_conv.conv3x3_forward = conv


def run_gan_core(case: dict, root: Path) -> dict:
    engine = trainer.build_engine(
        [*case["argv"], "--device", "cpu", "--no-tensorboard",
         "--result_root", str(root / case["name"])])
    try:
        state = torch.load(case["state"])
        # (under --tp loaded whole, the rank's channel slices kept)
        with engine._whole_state():
            engine.netg.load_state_dict(state["netG"], strict=True)
            engine.netd.load_state_dict(state["netD"], strict=True)
        engine.netg.drop_rate = 0.0
        data, gt, flows = (torch.from_numpy(np.load(case[k]))
                           for k in ("data", "gt", "flows"))
        data, gt = engine.dp.take((data, gt))
        # this rank's rows of each stream of the injected flows
        local = torch.cat([engine.dp.take((f,))[0] for f in flows.chunk(2)])
        sp = engine.dp.sp
        if sp is not None:
            # and its frames
            data, gt, local = (x[:, sp.frame_slice(x.shape[1])]
                               for x in (data, gt, local))
        if case.get("float64"):
            engine.to_float64()
            data, gt, local = (x.double() for x in (data, gt, local))
        engine._flow = lambda video, streams=1: local
        metrics = engine.dp.mean_metrics(engine._gan_core(data, gt))
        with engine._whole_state():
            return {**_state(engine),
                    "metrics": {k: float(v) for k, v in metrics.items()}}
    finally:
        engine.close()


def run_handoff(case: dict) -> dict:
    """``parallel/pipeline.GPipe`` over one toy block a stage (``x -> (s +
    2) x``, its output channels-last, as a conv's may be on the card) on
    the whole group as a pipeline, ``n_micro`` microbatches of a fixed
    ``(4, 3, 2, 4, 4)`` input: the chain's output, and stage 0's input
    gradient of ``sum(out * w)``."""
    from vfd_gan_tpu_torch.parallel.pipeline import GPipe, stage_grid

    grid = stage_grid(dist.get_world_size())
    scale = grid.stage + 2.0

    def block(x):
        return (x * scale).contiguous(memory_format=torch.channels_last_3d)

    gen = torch.Generator().manual_seed(11)
    h = torch.rand((4, 3, 2, 4, 4), generator=gen, requires_grad=True)
    w = torch.rand((4, 3, 2, 4, 4), generator=gen)
    pipe = GPipe([block], grid, case["n_micro"])
    out = pipe.forward(h)
    (out * w).sum().backward()
    pipe.backward()
    return {"out": out.detach(), "grad": h.grad, "hand_offs": pipe.hand_offs}


def run_flow(case: dict, dp: DataParallel) -> dict:
    video = torch.from_numpy(np.load(case["video"])).to(
        case.get("device", "cpu"))
    s = case["streams"]
    if case.get("sp", 1) > 1:
        # the whole group one (dp, sp) grid: this rank's rows and frames
        dp = sp_grid(case["sp"]).data_parallel(video.device)
        video_t = video.shape[1]
    groups = video.chunk(s)
    mine = torch.cat([dp.take((g,))[0] for g in groups])
    if dp.sp is not None:
        mine = mine[:, dp.sp.frame_slice(video_t)]
    if case.get("host"):
        # --host_flow: cv2 on the host, the slabs' extrema over the ranks
        from vfd_gan_tpu_torch.train.host_flow import video_to_flow_rgb_host

        out = {"flow": video_to_flow_rgb_host(mine, s, dp)}
        if dp.rank == 0:
            out["flow_alone"] = video_to_flow_rgb_host(video, s)
        return out
    if case.get("plain_path"):
        return _flow_paths(mine, video, s, dp, case.get("scale", 1.0))
    out = {"norm": minmax_stretch(mine, s, dp),
           "flow": video_to_flow_rgb(mine, streams=s, dp=dp)}
    if dp.rank == 0:
        out["norm_alone"] = minmax_stretch(video, s)
        out["flow_alone"] = video_to_flow_rgb(video, streams=s)
    return out


def _flow_paths(mine, video, streams: int, dp, scale: float) -> dict:
    """This rank's flow on its kernel path, the fused kernel's every call
    held against its plain version on the same fields (under ``--sp`` the
    halo'd ones: max and q99 of the difference, px, and the call's
    fields); then the flow on the plain path (the fused solver's plain
    version), and on rank 0 the whole video's on the plain path."""
    from vfd_gan_tpu_torch.ops import flow as flow_mod
    from vfd_gan_tpu_torch.ops.flow_fused import flow_refine_fused_plain

    kernel = flow_mod.flow_refine_fused
    calls = []

    def held(p1, p2, flow, winsize, iterations):
        out = kernel(p1, p2, flow, winsize, iterations)
        err = (out - flow_refine_fused_plain(p1, p2, flow, winsize,
                                             iterations)).abs().flatten()
        q99 = float(err.float().kthvalue(max(1, int(0.99 * err.numel())))
                    .values)
        calls.append((float(err.max()), q99, tuple(p1.shape)))
        return out

    result = {}
    try:
        flow_mod.flow_refine_fused = held
        result["flow"] = video_to_flow_rgb(mine, scale, streams, dp=dp)
        flow_mod.flow_refine_fused = flow_refine_fused_plain
        result["flow_plain"] = video_to_flow_rgb(mine, scale, streams, dp=dp)
        if dp.rank == 0:
            result["flow_alone_plain"] = video_to_flow_rgb(video, scale,
                                                           streams)
    finally:
        flow_mod.flow_refine_fused = kernel
    result["kernel_vs_plain"] = calls
    return result


def _sp_row(device):
    """This rank's ``SeqParallel`` on a 1-D sp grid of the whole group."""
    return sp_grid(dist.get_world_size()).data_parallel(device).sp


def run_temporal(case: dict) -> dict:
    """``parallel/temporal.py``'s ops on this rank's frames (axis 1) of
    the channel-last float32 clip ``x`` of ``case["inputs"]`` (npz; the
    temporal kernel ``k`` ``(kt, Cin, Cout)`` as JAX lays it out), the
    whole group one sp row; then, in float64, each op's gradient of
    ``sum(op(x) * w)`` for the fixed weights ``w_<op>`` of the op's global
    output (this rank's part)."""
    from vfd_gan_tpu_torch.parallel import temporal as tp

    sp = _sp_row("cpu")
    inputs = dict(np.load(case["inputs"]))
    x = torch.from_numpy(inputs["x"])
    mine = x[:, sp.frame_slice(x.shape[1])]
    kernel = torch.from_numpy(inputs["k"]).permute(2, 1, 0)[..., None,
                                                            None]

    def conv(block):
        # NCDHW in and out, the rank's frames on axis 1 of channel-last
        y = tp.temporal_conv_sp(block.permute(0, 4, 1, 2, 3),
                                kernel.to(block.dtype), sp)
        return y.permute(0, 2, 3, 4, 1)

    ops = {"halo": lambda b: tp.halo_exchange(b, 1, sp, 1),
           "upsample": lambda b: tp.upsample2x_t_sp(b, sp, 1),
           "pool": lambda b: tp.avg_pool2x_t_sp(b, sp, 1),
           "conv": conv}
    out = {}
    for name, op in ops.items():
        out[name] = op(mine)
        block = mine.double().requires_grad_(True)
        y = op(block)
        w = torch.from_numpy(inputs[f"w_{name}"])
        per = w.shape[1] // sp.size
        (y * w[:, sp.index * per:(sp.index + 1) * per]).sum().backward()
        out[f"{name}_grad"] = block.grad
    out["counts"] = {k: v[0] for k, v in sp.counts.items()}
    return out


def run_sp_generator(case: dict) -> dict:
    """``generator_forward_sp`` of the Generator (``case["ngf"]``; the
    AutoEncoder with ``"model": "ae"``) loaded
    from ``case["state"]`` on this rank's frames of the clip ``case["x"]``
    (npy, ``(B, T, H, W, 3)``), in float32 and in float64 (``mask64``),
    the whole group one sp row; rank 0 also runs the unsharded eval
    Generator (``alone``, ``alone64``)."""
    from vfd_gan_tpu_torch.models.mygan import Generator
    from vfd_gan_tpu_torch.models.stcnn import AutoEncoder
    from vfd_gan_tpu_torch.parallel.sp_generator import generator_forward_sp

    sp = _sp_row("cpu")
    netg = AutoEncoder() if case.get("model") == "ae" \
        else Generator(case["ngf"])
    netg.load_state_dict(torch.load(case["state"]), strict=True)
    # the unsharded reference: a Generator that is never bound to sp
    whole = copy.deepcopy(netg).eval()
    x = torch.from_numpy(np.load(case["x"])).permute(0, 4, 1, 2, 3)
    out = {}
    with torch.no_grad():
        for tag, dtype in (("", torch.float32), ("64", torch.float64)):
            netg.to(dtype)
            whole.to(dtype)
            clip = x.to(dtype)
            mine = clip[:, :, sp.frame_slice(x.shape[2])]
            out[f"mask{tag}"] = generator_forward_sp(netg, mine, sp)
            if sp.index == 0:
                out[f"alone{tag}"] = whole(clip)
    return out


def run_sp_nets(case: dict) -> dict:
    """AnoGAN's G and D (``"model": "anogan"``, ``case["state"]`` a
    ``{"netG", "netD"}`` of state dicts, G fed the z ``case["z"]`` (npy,
    ``(B, 100)``), D the clip ``case["x"]`` (npy, ``(B, T, H, W, 3)``))
    or the ConvLSTM (``"clstm"``, on the clip) in eval mode on this
    rank's frames, the whole group one sp row, in float32 and in float64
    (``*64``): G's frames (``fake``), D's scores and features, the
    ConvLSTM's mask frames; rank 0 also the unsharded nets' (``alone*``).
    """
    from vfd_gan_tpu_torch.models.anogan import (
        AnoDiscriminator,
        AnoGenerator,
    )
    from vfd_gan_tpu_torch.models.convlstm import ConvLSTMModel

    dp = sp_grid(dist.get_world_size()).data_parallel("cpu")
    sp = dp.sp
    x = torch.from_numpy(np.load(case["x"])).permute(0, 4, 1, 2, 3)
    t, s = x.shape[2], x.shape[3]
    state = torch.load(case["state"])
    if case["model"] == "anogan":
        nets = {"netG": AnoGenerator(t, s), "netD": AnoDiscriminator(t, s)}
    else:
        nets = {"clstm": ConvLSTMModel()}
    for name, net in nets.items():
        net.load_state_dict(state if len(nets) == 1 else state[name],
                            strict=True)
    # the unsharded references: nets never bound to sp
    whole = {k: copy.deepcopy(v).eval() for k, v in nets.items()}
    for net in nets.values():
        dp.bind(net.eval())
    z = torch.from_numpy(np.load(case["z"])) if "z" in case else None

    def run(nets, clip, z):
        if "clstm" in nets:
            return {"mask": nets["clstm"](clip)}
        score, feat = nets["netD"](clip)
        return {"fake": nets["netG"](z), "score": score, "features": feat}

    out = {}
    with torch.no_grad():
        for tag, dtype in (("", torch.float32), ("64", torch.float64)):
            for net in (*nets.values(), *whole.values()):
                net.to(dtype)
            clip = x.to(dtype)
            zd = None if z is None else z.to(dtype)
            mine = run(nets, clip[:, :, sp.frame_slice(t)], zd)
            out.update({f"{k}{tag}": v for k, v in mine.items()})
            if sp.index == 0:
                out.update({f"alone_{k}{tag}": v
                            for k, v in run(whole, clip, zd).items()})
    out["counts"] = {k: v[0] for k, v in sp.counts.items()}
    return out


def run_moe_layer(case: dict) -> dict:
    """The MoE block alone (``models/moe_block.MoEMlp``: ``case["channels"]``
    C, ``case["experts"]`` E at capacity factor ``case["capacity"]``,
    ``case["dtype"]`` tokens; weights from ``torch.Generator(0)``) on a
    seeded ``(B, C, T, H, W)`` input (``case["shape"]``: B, T, H, W) with
    a seeded upstream gradient, forward and backward, its experts over the
    whole group as one ep group (``--moe_shards`` world; ``local_ops``:
    the ep controls): the block's part of the output and of the input's
    gradient (the residual's identity taken out), the router's and the
    (gathered) experts' gradients, and the kept set.  Rank 0 also runs
    the one-process block on the same tokens in the same dtype
    (``alone``) and in float64 with the one-process float32 routing
    (``alone64``: the layer's own rounding)."""
    from vfd_gan_tpu_torch.models.moe_block import MoEMlp
    from vfd_gan_tpu_torch.parallel.tensor import StateShards

    device = torch.device(case.get("device", "cpu"))
    dp = sp_grid(1, dist.get_world_size()).data_parallel(device)
    dp.local_ops = frozenset(case.get("local_ops", ()))
    c, e = case["channels"], case["experts"]
    b, t, h, w = case["shape"]
    dtype = getattr(torch, case.get("dtype", "float32"))
    x = torch.randn((b, c, t, h, w), generator=torch.Generator()
                    .manual_seed(1)).to(device)
    up = torch.randn((b, c, t, h, w), generator=torch.Generator()
                     .manual_seed(2)).to(device)

    def block(kind=dtype):
        return MoEMlp(c, e, capacity_factor=case["capacity"], dtype=kind,
                      generator=torch.Generator().manual_seed(0)).to(device)

    def run(moe, inputs, wrt, gather=None):
        inputs = inputs.detach().requires_grad_(True)
        y = moe(inputs)
        (y.to(wrt.dtype) * wrt).sum().backward()
        experts = [p.grad for p in moe.expert_params()]
        if gather is not None:
            experts = [_gathered(g, gather) for g in experts]
        # the block's own parts of its output and of its input's gradient
        # (the residual's identity taken out, in float64)
        return {"out": y.detach().double() - inputs.detach().double(),
                "x_grad": inputs.grad.double() - wrt.double(),
                "router_grad": moe.router.grad,
                "experts_grad": torch.cat([g.flatten() for g in experts]),
                "kept": moe.routing["kept"]}

    mine = block()
    StateShards([mine], ep=dp.expert).release()
    dp.bind(mine)
    out = {k: v.cpu() for k, v in run(mine, x, up, dp.expert).items()}
    out["ep_counts"] = {k: v[0] for k, v in dp.expert.counts.items()}
    if dp.rank == 0 and dp.expert.index == 0:
        whole = block()
        out["alone"] = {k: v.cpu() for k, v in run(whole, x, up).items()}
        tokens = x.permute(0, 2, 3, 4, 1).reshape(-1, c).to(dtype)
        logits = tokens.to(torch.float32) @ whole.router.detach()
        exact = block(torch.float64).double()
        exact.choice = torch.argmax(torch.softmax(logits, -1), -1)
        out["alone64"] = {k: v.cpu() for k, v in run(
            exact, x.double(), up.double()).items()}
    return out


def _tp_module(case: dict, dtype: torch.dtype):
    """The module of a ``tp_block`` case (weights from
    ``torch.Generator(0)``), its input's shape and its forward:
    ``"gen"`` MyGAN's ``GenConvBlock`` (cin -> cout, ``(B, T, H, W)``
    frames); ``"sepaconv"`` an Xception SepaConv and the BatchNorm after it
    in a middle block (``sepa(x, bn)``); ``"moe"`` the MoE block
    (``cin`` channels, ``experts`` at capacity factor ``capacity``);
    ``"deconv2d"`` a GANomaly decoder stage, a stride-2 4x4
    ``ConvTranspose2d`` + BatchNorm + ReLU on ``(B, H, W)`` frames.  In
    float64 the parameters too."""
    from vfd_gan_tpu_torch.models.ganomaly import ConvBlock2d
    from vfd_gan_tpu_torch.models.layers import (
        ConvTranspose2d,
        GenConvBlock,
        VideoBatchNorm,
    )
    from vfd_gan_tpu_torch.models.moe_block import MoEMlp
    from vfd_gan_tpu_torch.models.xception3d import SepaConv

    kind, cin, cout = case.get("block", "gen"), case["cin"], case["cout"]
    init = torch.Generator().manual_seed(0)
    if kind == "gen":
        module = forward = GenConvBlock(cin, cout, dtype=dtype,
                                        generator=init)
    elif kind == "sepaconv":
        module = torch.nn.ModuleDict({
            "sepa": SepaConv(cin, cout, generator=init),
            "bn": VideoBatchNorm(cout, dtype=dtype, generator=init)})

        def forward(x):
            return module["sepa"](x, module["bn"])
    elif kind == "moe":
        module = forward = MoEMlp(cin, case["experts"],
                                  capacity_factor=case["capacity"],
                                  dtype=dtype, generator=init)
    else:
        module = ConvBlock2d(ConvTranspose2d(cin, cout, 4, 2, 1, bias=False),
                             cout, dtype=dtype, generator=init)

        def forward(x):
            return module.activated(x, F.relu)
    if dtype == torch.float64:
        module.double()
    return module, (case["shape"][0], cin, *case["shape"][1:]), forward


def run_tp_block(case: dict) -> dict:
    """One module alone (``_tp_module``: ``case["block"]``, ``"gen"`` by
    default; ``case["dtype"]`` compute, train mode) on a seeded input with
    a seeded upstream gradient, forward and backward, its leaves split
    over the whole group as one tp group (``--tp`` world; ``local_ops``:
    the tp controls ``"tp_copy"``, ``"tp_gather"``): the module's output,
    its input's gradient and every parameter's gradient (the split ones
    gathered whole).  Rank 0 also runs the one-process module on the same
    input in the same dtype (``alone``) and in float64 (``alone64``: the
    module's own rounding), both in the grid's two-pass BatchNorm
    arithmetic (``OneProcess``).  The MoE block routes every run by the
    one-process float32 router's choice (each reads its gate from its own
    probabilities), so that what is held is the layer's arithmetic, not
    a near-tie's side."""
    from vfd_gan_tpu_torch.parallel.tensor import StateShards
    from vfd_gan_tpu_torch.utils.runtime import resolve_device

    # (TF32 off, as the trainer's engines run)
    device = resolve_device(case.get("device", "cpu"))
    dp = sp_grid(1, tp=dist.get_world_size()).data_parallel(device)
    dp.tp.local_ops = dp.local_ops = frozenset(case.get("local_ops", ()))
    dtype = getattr(torch, case.get("dtype", "float32"))
    module0, in_shape, _ = _tp_module(case, dtype)
    # the module's input in its compute dtype, as the net's BatchNorms
    # hand it on; the upstream gradient in float64, rounded by the cast
    x = torch.randn(in_shape, generator=torch.Generator()
                    .manual_seed(1)).to(device, dtype)
    kind = case.get("block", "gen")
    out_shape = list(in_shape)
    if kind != "moe":
        out_shape[1] = case["cout"]
    if kind == "deconv2d":
        out_shape[2:] = [2 * n for n in in_shape[2:]]
    up = torch.randn(out_shape, dtype=torch.float64,
                     generator=torch.Generator().manual_seed(2)).to(device)
    choice = None
    if kind == "moe":
        tokens = x.permute(0, *range(2, x.dim()), 1).reshape(-1, in_shape[1])
        logits = tokens.float() @ module0.router.detach().float().to(device)
        choice = torch.argmax(torch.softmax(logits, -1), -1)

    def run(module, forward, inputs, grid, shards=None):
        module = grid.bind(module.to(device))
        if choice is not None:
            module.choice = choice
        inputs = inputs.detach().requires_grad_(True)
        y = forward(inputs)
        (y.double() * up).sum().backward()
        split = {id(getattr(m, name)): (channels, dim) for m, name,
                 channels, dim, _ in (shards.tensors if shards else ())}

        def whole(g, channels, dim):
            # a split parameter's gradient whole: each rank's in its
            # channels of a zero buffer, summed over the group
            shape = list(g.shape)
            shape[dim] = channels
            full = g.new_zeros(shape)
            n = g.shape[dim]
            full.narrow(dim, grid.tp.index * n, n).copy_(g)
            dist.all_reduce(full, group=grid.tp.group)
            return full

        grads = [whole(p.grad, *split[id(p)]) if id(p) in split else p.grad
                 for p in module.parameters()]
        return {"out": y.detach().double().cpu(),
                "x_grad": inputs.grad.double().cpu(),
                "grads": torch.cat([g.double().flatten().cpu()
                                    for g in grads])}

    mine, _, forward = _tp_module(case, dtype)
    shards = StateShards([mine], dp.tp)
    shards.release()
    out = run(mine, forward, x, dp, shards)
    out["tp_counts"] = {k: v[0] for k, v in dp.tp.counts.items()}
    out["split"] = len(shards.params)
    if dp.rank == 0:
        alone, _, forward = _tp_module(case, dtype)
        out["alone"] = run(alone, forward, x, OneProcess(device))
        exact, _, forward = _tp_module(case, dtype)
        exact.double()
        for m in exact.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.dtype = torch.float64
            if hasattr(m, "n_experts"):
                m.dtype = torch.float64
        out["alone64"] = run(exact, forward, x.double(), OneProcess(device))
    return out


def _gathered(grad: torch.Tensor, ep) -> torch.Tensor:
    """Every expert's gradient from the ranks of the ep group ``ep``,
    each in its rows of a zero buffer, summed."""
    full = grad.new_zeros((grad.shape[0] * ep.size, *grad.shape[1:]))
    full[ep.experts(full.shape[0])] = grad
    dist.all_reduce(full, group=ep.group)
    return full


def run_step_core(case: dict, root: Path) -> dict:
    """One train step of a supervised or GANomaly command line (``--pp``,
    ``--sp``) from the given state dict (a net's, or ``{net: state
    dict}``), on this rank's rows (and under ``--sp`` frames) of the given
    global batch with the given augment draws (the global batch's) and
    dropout off; every rank's state whole after it (``state``: the
    model's, or each net's keys prefixed ``{net}.``), the step's
    ``metrics``, and with an MoE block its ``routing`` (each token's slot
    and kept flag, this rank's ``(rows, frames, H, W)``)."""
    import sys as _sys

    engine = trainer.build_engine(
        [*case["argv"], "--device", "cpu", "--no-tensorboard",
         "--result_root", str(root / case["name"])])
    module = _sys.modules[type(engine).__module__]
    drawn = module.sample_clip_params
    nets = engine._nets()
    try:
        state = torch.load(case["state"])
        with engine._whole_state():
            if set(state) == set(nets):
                for name, net in nets.items():
                    net.module.load_state_dict(state[name], strict=True)
            else:
                engine.model.load_state_dict(state, strict=True)
        for net in nets.values():
            for m in net.module.modules():
                if hasattr(m, "drop_rate"):
                    m.drop_rate = 0.0
        if "moe_capacity" in case:
            engine.model.moe.capacity_factor = case["moe_capacity"]
        batch = {k: torch.from_numpy(v)
                 for k, v in np.load(case["batch"]).items()}
        draws = np.load(case["draws"])
        given = (torch.from_numpy(draws["angle"]),
                 torch.from_numpy(draws["flip"]).long(),
                 torch.from_numpy(draws["crop"]).long(),
                 torch.from_numpy(draws["pick"]))
        module.sample_clip_params = lambda *a, **k: given
        if "z" in case:
            z = torch.from_numpy(np.load(case["z"]))
            engine._draw_z = lambda b: z
        dp = engine.dp
        if dp.active:
            batch = {k: v[dp.rows(v.shape[0], engine.micro)]
                     for k, v in batch.items()}
        if dp.sp is not None:
            batch = {k: v[:, dp.sp.frame_slice(v.shape[1])]
                     for k, v in batch.items()}
        engine.global_step = 1
        metrics = dp.mean_metrics(engine._train_step_impl(batch))
        with engine._whole_state():
            if len(nets) == 1:
                state = {k: v.detach().clone() for k, v in
                         engine.model.state_dict().items()}
            else:
                state = {f"{name}.{k}": v.detach().clone()
                         for name, net in nets.items()
                         for k, v in net.module.state_dict().items()}
        out = {"state": state,
               "metrics": {k: float(v) for k, v in metrics.items()}}
        if "loss/err/train" in metrics:
            out["loss"] = out["metrics"]["loss/err/train"]
        pipe = getattr(engine, "pipe", None)
        if pipe is not None:
            out["hand_offs"] = pipe.gpipe.hand_offs
        moe = getattr(getattr(engine, "model", None), "moe", None)
        if moe is not None:
            out["routing"] = dict(moe.routing)
        return out
    finally:
        module.sample_clip_params = drawn
        engine.close()


def _save_reference(result: dict, path: Path) -> None:
    """A reference written whole before its name appears (another
    group's ranks may be waiting for it, ``_reference``)."""
    part = path.with_suffix(".part")
    torch.save(result, part)
    os.replace(part, path)


def _reference(path: Path, timeout: float = 300.0) -> dict:
    """The reference at ``path``: one of this group's, written before the
    case began, or another group's (a ``"ref"`` given as the path of a
    reference in that group's directory, without ``.ref.pt``), waited for
    up to ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while not path.exists():
        if time.monotonic() > deadline:
            raise FileNotFoundError(f"no reference {path} after "
                                    f"{timeout:g} s")
        time.sleep(0.1)
    return torch.load(path)


def run_cases(cases: list[dict], out: Path) -> None:
    dp = DataParallel.current()
    for i, case in enumerate(cases):
        kind = case.get("kind", "train")
        solo = kind == "train" and case.get("dp", 2) == 1
        if solo and dp.grouped and i % dp.world != dp.rank:
            continue                       # another rank's reference
        start = time.perf_counter()
        if dp.grouped and not solo:
            # what a rank alone wrote before (a reference, a checkpoint
            # this case resumes) is there when the case starts
            dist.barrier()
        if kind == "train":
            result = run_train(case, out, solo)
        elif kind == "gan_core":
            result = run_gan_core(case, out)
        elif kind == "step_core":
            result = run_step_core(case, out)
        elif kind == "handoff":
            result = run_handoff(case)
        elif kind == "temporal":
            result = run_temporal(case)
        elif kind == "sp_generator":
            result = run_sp_generator(case)
        elif kind == "sp_nets":
            result = run_sp_nets(case)
        elif kind == "moe_layer":
            result = run_moe_layer(case)
        elif kind == "tp_block":
            result = run_tp_block(case)
        else:
            result = run_flow(case, dp)
        if solo:
            _save_reference(result, out / f"{case['name']}.ref.pt")
            print(f"[dp_equivalence] rank {dp.rank}: {case['name']} "
                  f"{time.perf_counter() - start:.1f} s", flush=True)
            continue
        if case.get("as_ref") and dp.rank == 0:
            _save_reference(result, out / f"{case['name']}.ref.pt")
        if "ref" in case:
            short = {"digest": _digest(result),
                     **{k: result[k] for k in ("scores", "saved", "held",
                                               "hand_offs", "sweeps",
                                               "frame_scores",
                                               "moe_dropped", "sp_counts",
                                               "ep_counts", "tp_counts",
                                               "sweep_tp_counts",
                                               "tp_elements",
                                               "grad_buffers",
                                               "expert_elements",
                                               "trunk_digests",
                                               "first_routing")
                        if k in result}}
            if dp.rank == 0:
                # the reference was written before this case began: every
                # rank finished it before it joined this case's first
                # collective (an "as_ref" case of the group: before the
                # barrier that starts this one)
                refs = case["ref"] if isinstance(case["ref"], list) \
                    else [case["ref"]]
                short["distances_to"] = {
                    ref: distances(result, _reference(out / f"{ref}.ref.pt"))
                    for ref in refs}
                short["distances"] = short["distances_to"][refs[0]]
            result = short
        torch.save(result, out / f"{case['name']}.rank{dp.rank}.pt")
        print(f"[dp_equivalence] rank {dp.rank}: {case['name']} "
              f"{time.perf_counter() - start:.1f} s", flush=True)


def run(cases: list[dict], out: str | os.PathLike, world: int = 2,
        backend: str = "gloo", timeout: float = 120.0, *,
        log: str | os.PathLike | None = None, on_spawn=None) -> None:
    """``cases`` run by ``world`` ranks over ``backend``, their results in
    ``out``; raises if a rank fails or the join ``timeout`` passes.
    ``log`` and ``on_spawn``: ``parallel/mesh.launch``'s (the ranks'
    output to a file; called with their pids once they are started)."""
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    spec = out / "cases.json"
    spec.write_text(json.dumps(cases))
    launch(ENTRY, ["--cases", str(spec), "--out", str(out)], world, backend,
           timeout=timeout, log=log, on_spawn=on_spawn)


class Standing:
    """Two gloo ranks that start once and run batches of cases, one after
    another, each as ``run`` runs its list: the ranks import, join their
    group and reach the card once for all the batches.  They wait in
    ``root/queue`` for the next batch and leave at ``close`` (or the
    block's end, as a context manager).  A rank that fails stops the
    other and the batch raises; so does a batch past its join timeout,
    which kills the ranks."""

    world = 2

    def __init__(self, root: str | os.PathLike) -> None:
        self.queue = Path(root) / "queue"
        self.queue.mkdir(parents=True, exist_ok=True)
        self.batches = 0
        self.pids: list[int] = []
        self.error: BaseException | None = None

        def ranks():
            try:
                launch(ENTRY, ["--queue", str(self.queue)], self.world,
                       "gloo", on_spawn=self.pids.extend)
            except BaseException as e:       # read by the waiting batch
                self.error = e

        self.thread = threading.Thread(target=ranks, daemon=True)
        self.thread.start()

    def run(self, cases: list[dict], out: str | os.PathLike,
            timeout: float = 120.0) -> None:
        """``cases`` run by the ranks, their results in ``out``, as
        ``run`` gives them; raises if a rank fails or ``timeout`` seconds
        pass before every rank has run them."""
        out = Path(out)
        out.mkdir(parents=True, exist_ok=True)
        self.batches += 1
        batch = self.queue / f"batch{self.batches}.json"
        spec = batch.with_suffix(".part")
        spec.write_text(json.dumps({"cases": cases, "out": str(out)}))
        spec.rename(batch)                   # whole when a rank sees it
        done = [self.queue / f"batch{self.batches}.rank{r}.done"
                for r in range(self.world)]
        start = time.monotonic()
        while not all(d.exists() for d in done):
            if not self.thread.is_alive():
                raise RuntimeError(f"the standing ranks stopped in batch "
                                   f"{self.batches}: {self.error}")
            if time.monotonic() - start > timeout:
                self._kill()
                raise RuntimeError(f"batch {self.batches} of the standing "
                                   f"ranks passed its {timeout:g} s join "
                                   f"timeout; the ranks were killed")
            time.sleep(0.05)

    def close(self) -> None:
        """The ranks told to leave, and waited for (killed after 60 s)."""
        (self.queue / "stop").write_text("")
        self.thread.join(60.0)
        if self.thread.is_alive():
            self._kill()
            self.thread.join()

    def _kill(self) -> None:
        for pid in self.pids:
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass

    def __enter__(self) -> "Standing":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _stand(queue: Path, rank: int) -> None:
    """A standing rank: each batch of ``queue`` in turn through
    ``run_cases``, a mark that this rank ran it, until ``queue/stop`` (or
    until the process that started the ranks is gone)."""
    parent, n = os.getppid(), 0
    while True:
        n += 1
        batch = queue / f"batch{n}.json"
        while not batch.exists():
            if (queue / "stop").exists() or os.getppid() != parent:
                return
            time.sleep(0.05)
        spec = json.loads(batch.read_text())
        run_cases(spec["cases"], Path(spec["out"]))
        if torch.cuda.is_available():
            torch.cuda.empty_cache()         # the next batch's models
        (queue / f"batch{n}.rank{rank}.done").write_text("")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cases")
    p.add_argument("--out")
    p.add_argument("--queue")
    args = p.parse_args(argv)
    if (args.queue is None) == (args.cases is None or args.out is None):
        p.error("give --cases and --out, or --queue")
    torch.set_num_threads(1)
    started = rank_env()
    if started is None:
        if args.queue is not None:
            p.error("--queue: for ranks that Standing starts")
        run_cases(json.loads(Path(args.cases).read_text()), Path(args.out))
        return
    rank, world, init_method, backend = started
    if backend == "nccl":
        rank_device(torch.device("cuda"), rank)   # before the group forms
    with rank_group(rank, world, init_method, backend, timeout_s=90.0):
        if args.queue is not None:
            _stand(Path(args.queue), rank)
        else:
            run_cases(json.loads(Path(args.cases).read_text()),
                      Path(args.out))


if __name__ == "__main__":
    main()
