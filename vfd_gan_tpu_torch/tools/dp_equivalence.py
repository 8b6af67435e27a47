"""The work of the data-parallel equivalence checks, run by each rank.

    python -m vfd_gan_tpu_torch.tools.dp_equivalence --cases cases.json \\
        --out DIR

Started as the ranks of one group by ``run`` (``parallel/mesh.launch``),
or alone: every rank runs the cases of ``cases.json`` (a list of dicts)
in order and writes ``DIR/{name}.rank{r}.pt``.  A case is one of

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
  of any one tensor (``distances``); every rank writes a digest of its
  state, so the ranks' replicas can be held equal.  ``float64``: the
  nets, their optimizer state and the batch in float64
  (``EngineBase.to_float64``).  ``bn_stats``: ``"local"`` or
  ``"forward"``, the controls that must miss (``DataParallel``).  ``flow:
  "standin"`` (MyGAN): the flow replaced by a smooth function of the
  video and its synced stretch plus a fixed random field
  (``_standin_flow``), so float64 runs compare to round-off (the flow's
  bfloat16 operand contract does not); ``"own+field"``: the engine's own
  flow (``--host_flow``'s cv2 flow) plus the field.  ``local_ops``: the
  controls of ``--moe_experts``, ``--int8_disc`` and ``--host_flow``
  (``DataParallel.local_ops``); ``moe_capacity``: the MoE layer's
  capacity factor (low enough, tokens drop; each step's dropped fraction
  is in the result); ``arith: "dp"``: the reference computes in the dp
  path's BatchNorm arithmetic (``OneProcess``).  Under ``--pp`` the ranks
  form the ``dp x pp`` grid of the whole group, and a reference runs the
  chain per microbatch in one process.  ``save``: the train state after
  the steps written there (rank 0), as ``latest.pt`` is.
* ``{"name", "kind": "gan_core", "argv", "state": path, "data": path,
  "gt": path, "flows": path}``: one MyGAN ``_gan_core`` step from the
  given state dicts on this rank's rows of the given global batch, with
  dropout off and this rank's rows of the given flows (both streams) in
  place of the flow.
* ``{"name", "kind": "flow", "video": path, "streams": s, "host":
  bool}``: this rank's rows of each stream of a global video through
  ``minmax_stretch`` and ``video_to_flow_rgb`` (``host``: through
  ``--host_flow``'s cv2 flow); also the whole video alone on rank 0.
* ``{"name", "kind": "pp_core", "argv", "state": path, "batch": path,
  "draws": path}``: one supervised step of a ``--pp`` command line from
  the given state dict, on the given global batch with the given augment
  draws and dropout off (``run_pp_core``).
* ``{"name", "kind": "handoff", "n_micro"}``: the GPipe schedule of a
  toy block a stage, whose outputs are channels-last (``run_handoff``).
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

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
)

ENTRY = "vfd_gan_tpu_torch.tools.dp_equivalence"


KINDS = ("params", "buffers", "exp_avg", "exp_avg_sq", "losses")


def _state(engine) -> dict:
    """Parameters, buffers and Adam moments of every net, on the CPU."""
    out = {"params": {}, "buffers": {}, "exp_avg": {}, "exp_avg_sq": {}}
    for net_name, net in engine._nets().items():
        for k, p in net.module.named_parameters():
            out["params"][f"{net_name}.{k}"] = p.detach().cpu().clone()
            st = net.optimizer.state.get(p, {})
            for m in ("exp_avg", "exp_avg_sq"):
                if m in st:
                    out[m][f"{net_name}.{k}"] = st[m].detach().cpu().clone()
        for k, b in net.module.named_buffers():
            out["buffers"][f"{net_name}.{k}"] = b.detach().cpu().clone()
    return out


def _digest(result: dict) -> str:
    """A hash of a state's every tensor, bit for bit."""
    h = hashlib.sha256()
    for kind in KINDS[:4]:
        for k in sorted(result[kind]):
            h.update(k.encode())
            h.update(result[kind][k].numpy().tobytes())
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

    def all_reduce_sum(self, x):
        return x

    def all_reduce_max_(self, x):
        return x

    def mean_grads(self, module) -> None:
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
        b = video.shape[0] // streams
        n = b * dp.world if dp.active else b
        field = torch.rand((streams, n, *video.shape[1:]),
                           generator=torch.Generator().manual_seed(7),
                           dtype=video.dtype) * 2 - 1
        rows = dp.rows(n)
        if rows is not None:
            field = field[:, rows]
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
        moe = getattr(getattr(engine, "model", None), "moe", None)
        if "moe_capacity" in case:
            moe.capacity_factor = case["moe_capacity"]
        if case.get("float64"):
            engine.to_float64()
        if case.get("flow") in ("standin", "own+field"):
            engine._flow = _standin_flow(engine, case["flow"] == "standin")
        losses, step_ms, collectives, dropped = [], [], {}, []
        launches.reset()
        if engine.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(engine.device)
        timing = _timed_collectives(engine.device, collectives) \
            if case.get("time_collectives") else contextlib.nullcontext()
        batches = engine._batches(engine.train_iter)
        with timing:
            for _, batch in zip(range(case["steps"]), batches):
                t0 = time.perf_counter()
                engine.global_step += 1
                metrics = engine._train_step_impl(batch)
                engine._sync()
                step_ms.append(1e3 * (time.perf_counter() - t0))
                metrics = engine.dp.mean_metrics(metrics)
                losses.append({k: float(v) for k, v in metrics.items()})
                if moe is not None:
                    dropped.append(float(moe.aux["dropped_frac"].detach()))
        # under --pp every stage's blocks, gathered while read
        with engine._whole_state():
            out = _state(engine)
            if "save" in case and engine.dp.writes:
                save_checkpoint(case["save"], engine._ckpt_tree())
        out.update(losses=losses, rng=engine.rng.get_state(),
                   step_ms=step_ms, launches=launches.counts(),
                   moe_dropped=dropped, collective_ms={
                       k: (ms / len(step_ms), n / len(step_ms))
                       for k, (ms, n) in collectives.items()})
        if engine.device.type == "cuda":
            out["peak_mib"] = torch.cuda.max_memory_allocated(
                engine.device) / 2 ** 20
        pipe = getattr(engine, "pipe", None)
        if pipe is not None:
            out["hand_offs"] = pipe.gpipe.hand_offs
            # the parameter elements this rank holds between gathers
            out["held"] = sum(p.numel() for p in engine.model.parameters())
        if "save" in case and not solo:
            dist.barrier()              # written before any rank reads it
        if case.get("sweep"):
            with engine.dp.local():
                engine.test()
            out["scores"] = {k: float(v) for k, v in engine.scores.items()}
            out["saved"] = sorted(
                p.name for p in Path(engine.dirs.weights).glob("*.pth")) \
                if engine._writes else None
        return out
    finally:
        engine.close()


def run_gan_core(case: dict, root: Path) -> dict:
    engine = trainer.build_engine(
        [*case["argv"], "--device", "cpu", "--no-tensorboard",
         "--result_root", str(root / case["name"])])
    try:
        state = torch.load(case["state"])
        engine.netg.load_state_dict(state["netG"], strict=True)
        engine.netd.load_state_dict(state["netD"], strict=True)
        engine.netg.drop_rate = 0.0
        data, gt, flows = (torch.from_numpy(np.load(case[k]))
                           for k in ("data", "gt", "flows"))
        data, gt = engine.dp.take((data, gt))
        # this rank's rows of each stream of the injected flows
        local = torch.cat([engine.dp.take((f,))[0] for f in flows.chunk(2)])
        engine._flow = lambda video, streams=1: local
        metrics = engine.dp.mean_metrics(engine._gan_core(data, gt))
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
    groups = video.chunk(s)
    mine = torch.cat([dp.take((g,))[0] for g in groups])
    if case.get("host"):
        # --host_flow: cv2 on the host, the slabs' extrema over the ranks
        from vfd_gan_tpu_torch.train.host_flow import video_to_flow_rgb_host

        out = {"flow": video_to_flow_rgb_host(mine, s, dp)}
        if dp.rank == 0:
            out["flow_alone"] = video_to_flow_rgb_host(video, s)
        return out
    out = {"norm": minmax_stretch(mine, s, dp),
           "flow": video_to_flow_rgb(mine, streams=s, dp=dp)}
    if dp.rank == 0:
        out["norm_alone"] = minmax_stretch(video, s)
        out["flow_alone"] = video_to_flow_rgb(video, streams=s)
    return out


def run_pp_core(case: dict, root: Path) -> dict:
    """One supervised train step of ``argv`` (``--pp``) from the given
    state dict on the given batch, with the augment draws given (the
    global batch's) and dropout off; every rank's state whole after it."""
    from vfd_gan_tpu_torch.train import supervised_engine

    engine = trainer.build_engine(
        [*case["argv"], "--device", "cpu", "--no-tensorboard",
         "--result_root", str(root / case["name"])])
    drawn = supervised_engine.sample_clip_params
    try:
        with engine._whole_state():
            engine.model.load_state_dict(torch.load(case["state"]),
                                         strict=True)
        for m in engine.model.modules():
            if hasattr(m, "drop_rate"):
                m.drop_rate = 0.0
        batch = {k: torch.from_numpy(v)
                 for k, v in np.load(case["batch"]).items()}
        draws = np.load(case["draws"])
        given = (torch.from_numpy(draws["angle"]),
                 torch.from_numpy(draws["flip"]).long(),
                 torch.from_numpy(draws["crop"]).long(),
                 torch.from_numpy(draws["pick"]))
        supervised_engine.sample_clip_params = lambda *a, **k: given
        engine.global_step = 1
        metrics = engine.dp.mean_metrics(engine._train_step_impl(
            {k: v[engine.dp.rows(v.shape[0], engine.micro)]
             if engine.dp.active else v for k, v in batch.items()}))
        with engine._whole_state():
            state = {k: v.detach().clone() for k, v in
                     engine.model.state_dict().items()}
        return {"state": state, "loss": float(metrics["loss/err/train"]),
                "hand_offs": engine.pipe.gpipe.hand_offs}
    finally:
        supervised_engine.sample_clip_params = drawn
        engine.close()


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
        elif kind == "pp_core":
            result = run_pp_core(case, out)
        elif kind == "handoff":
            result = run_handoff(case)
        else:
            result = run_flow(case, dp)
        if solo:
            torch.save(result, out / f"{case['name']}.ref.pt")
            print(f"[dp_equivalence] rank {dp.rank}: {case['name']} "
                  f"{time.perf_counter() - start:.1f} s", flush=True)
            continue
        if "ref" in case:
            short = {"digest": _digest(result),
                     **{k: result[k] for k in ("scores", "saved", "held",
                                               "hand_offs") if k in result}}
            if dp.rank == 0:
                # the reference was written before this case began: every
                # rank finished it before it joined this case's first
                # collective
                short["distances"] = distances(
                    result, torch.load(out / f"{case['ref']}.ref.pt"))
            result = short
        torch.save(result, out / f"{case['name']}.rank{dp.rank}.pt")
        print(f"[dp_equivalence] rank {dp.rank}: {case['name']} "
              f"{time.perf_counter() - start:.1f} s", flush=True)


def run(cases: list[dict], out: str | os.PathLike, world: int = 2,
        backend: str = "gloo", timeout: float = 120.0) -> None:
    """``cases`` run by ``world`` ranks over ``backend``, their results in
    ``out``; raises if a rank fails or the join ``timeout`` passes."""
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    spec = out / "cases.json"
    spec.write_text(json.dumps(cases))
    launch(ENTRY, ["--cases", str(spec), "--out", str(out)], world, backend,
           timeout=timeout)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cases", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    cases = json.loads(Path(args.cases).read_text())
    torch.set_num_threads(1)
    started = rank_env()
    if started is None:
        run_cases(cases, Path(args.out))
        return
    rank, world, init_method, backend = started
    if backend == "nccl":
        rank_device(torch.device("cuda"), rank)   # before the group forms
    with rank_group(rank, world, init_method, backend, timeout_s=90.0):
        run_cases(cases, Path(args.out))


if __name__ == "__main__":
    main()
