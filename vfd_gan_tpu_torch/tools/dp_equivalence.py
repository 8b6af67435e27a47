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
  bfloat16 operand contract does not).
* ``{"name", "kind": "gan_core", "argv", "state": path, "data": path,
  "gt": path, "flows": path}``: one MyGAN ``_gan_core`` step from the
  given state dicts on this rank's rows of the given global batch, with
  dropout off and this rank's rows of the given flows (both streams) in
  place of the flow.
* ``{"name", "kind": "flow", "video": path, "streams": s}``: this rank's
  rows of each stream of a global video through ``minmax_stretch`` and
  ``video_to_flow_rgb``; also the whole video alone on rank 0.
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
from vfd_gan_tpu_torch.parallel.mesh import (
    DataParallel,
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


def _standin_flow(engine):
    """The flow stand-in of a float64 MyGAN case: the synced stretch and
    the video, smooth, plus a fixed random field of the global batch's
    shape (this rank's rows of it), which keeps the temporal D's inputs
    from being near-constant (binary masks, a G output near 0.5 at init),
    where its BatchNorms would amplify round-off a millionfold."""
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
        gray = stretch_gray(video, streams, dp) / 255.0
        return (torch.tanh(video) + gray[..., None]) * 0.25 \
            + field.reshape(video.shape) * 0.5
    return flow


def _solo(engine) -> None:
    """Take the engine out of the group: the dp-1 reference."""
    engine.dp = DataParallel(device=engine.device)
    engine._bind_dp()
    engine.train_iter.rows = None
    for d in (engine.dirs.root, engine.dirs.weights):
        os.makedirs(d, exist_ok=True)


@contextlib.contextmanager
def _timed_collectives(device: torch.device, record: dict):
    """Every ``all_reduce`` in the block timed (the device synchronised
    around it) and counted under the functions that called it."""
    plain = dist.all_reduce

    def timed(tensor, *args, **kwargs):
        caller = sys._getframe(1).f_code.co_name
        label = f"{sys._getframe(2).f_code.co_name}/{caller}"
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = plain(tensor, *args, **kwargs)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms, n = record.get(label, (0.0, 0))
        record[label] = (ms + 1e3 * (time.perf_counter() - t0), n + 1)
        return out

    dist.all_reduce = timed
    try:
        yield
    finally:
        dist.all_reduce = plain


def run_train(case: dict, root: Path, solo: bool) -> dict:
    device = case.get("device", "cpu")
    rank = DataParallel.current().rank if device == "cuda" else None
    engine = trainer.build_engine(
        [*case["argv"], "--device", device, "--no-tensorboard",
         "--result_root", str(root / case["name"])], rank)
    try:
        if solo:
            _solo(engine)
        engine.dp.bn_stats = case.get("bn_stats", "global")
        if case.get("float64"):
            engine.to_float64()
        if case.get("flow") == "standin":
            engine._flow = _standin_flow(engine)
        losses, step_ms, collectives = [], [], {}
        launches.reset()
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
        out = {**_state(engine), "losses": losses,
               "rng": engine.rng.get_state(), "step_ms": step_ms,
               "launches": launches.counts(),
               "collective_ms": {k: (ms / len(step_ms), n / len(step_ms))
                                 for k, (ms, n) in collectives.items()}}
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


def run_flow(case: dict, dp: DataParallel) -> dict:
    video = torch.from_numpy(np.load(case["video"]))
    s = case["streams"]
    groups = video.chunk(s)
    mine = torch.cat([dp.take((g,))[0] for g in groups])
    out = {"norm": minmax_stretch(mine, s, dp),
           "flow": video_to_flow_rgb(mine, streams=s, dp=dp)}
    if dp.rank == 0:
        out["norm_alone"] = minmax_stretch(video, s)
        out["flow_alone"] = video_to_flow_rgb(video, streams=s)
    return out


def run_cases(cases: list[dict], out: Path) -> None:
    dp = DataParallel.current()
    for i, case in enumerate(cases):
        kind = case.get("kind", "train")
        solo = kind == "train" and case.get("dp", 2) == 1
        if solo and dp.grouped and i % dp.world != dp.rank:
            continue                       # another rank's reference
        start = time.perf_counter()
        if kind == "train":
            result = run_train(case, out, solo)
        elif kind == "gan_core":
            result = run_gan_core(case, out)
        else:
            result = run_flow(case, dp)
        if solo:
            torch.save(result, out / f"{case['name']}.ref.pt")
            print(f"[dp_equivalence] rank {dp.rank}: {case['name']} "
                  f"{time.perf_counter() - start:.1f} s", flush=True)
            continue
        if "ref" in case:
            short = {"digest": _digest(result),
                     **{k: result[k] for k in ("scores", "saved")
                        if k in result}}
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
