"""Compare trained checkpoints on one test set (port of
``vfd_gan_tpu.cli.evaluate_models``, the reference's ``test.py``).

Usage::

    python -m vfd_gan_tpu_torch.cli.evaluate_models \\
        --test_data_path test.txt --test_model_list_path models.txt \\
        [--metric roc|pr] [--result_path results/test] [--device cuda]

The reference's semantics (test.py:146-206), as the JAX CLI keeps them:

* ``--test_data_path`` is a path list of mp4 clips (decoded with cv2 at
  ``--isize``), read in order (**shuffle=False**, test.py:159) in drop-last
  batches of ``--batchsize``; ``--test_model_list_path`` lists one
  checkpoint per line.
* A ``.pth`` picks its model by a substring of its path, in the
  reference's if/elif order: "ganbase" or "mygan" the MyGAN Generator,
  "c2plus1d" the AutoEncoder, "xception" Xception-3D, "clstm" the ConvLSTM
  (test.py:115-144); no match exits with the reference's "Weight path not
  found.".  Unlike ``cli/infer.py`` this table has no "netG", so an
  ``--ae`` run's ``..._c2plus1d_..._netG.pth`` loads as the AutoEncoder.
* A port run's full train state (``weights/latest.pt``) picks its model by
  the structure of its ``state_dict`` (G's of a GAN run), the Generator at
  the width its weights have; an Orbax directory of the JAX trainer needs
  jax and exits with the conversion command.
* Scores are the **raw sigmoid masks** (no threshold, no opening:
  test.py:181-186), scored against the gt masks by ROC AUC with its EER
  (or PR AUC) and F1 at 0.20 (``eval/metrics.py``).
* Per model: ``<ckpt> / <metric> == <auc>`` and ``<ckpt> / f1 == <f1>``
  are printed and the curve is written as ``<metric>_curve_<i>_<name>.csv``
  in ``--result_path``; all curves are overlaid in ``<metric>_curve.png``
  when matplotlib imports (where it does not, that is said once).  The
  return value is ``{display name: {"auc", "f1", "eer"}}``.

``evaluate_checkpoints`` is the loop over any iterable of batches (clips
held in memory, for one); ``main`` builds the mp4 loader.  ``--device``
defaults to ``cuda`` and raises without a card.
"""

from __future__ import annotations

import argparse
import csv
import os

import numpy as np
import torch

from vfd_gan_tpu_torch.cli.infer import build_model
from vfd_gan_tpu_torch.eval.metrics import evaluate, pr_auc, roc_auc_with_eer
from vfd_gan_tpu_torch.ops.augment import normalize_clips
from vfd_gan_tpu_torch.ops.image import to_channel_first, to_channel_last
from vfd_gan_tpu_torch.train.checkpoints import restore_checkpoint
from vfd_gan_tpu_torch.utils.checkpoint import has_module, load_state_dict
from vfd_gan_tpu_torch.utils.runtime import resolve_device


def build_parser():
    p = argparse.ArgumentParser(description="multi-checkpoint comparison eval")
    p.add_argument("--gpu", type=str, default="0")  # compat, unused
    p.add_argument("--isize", type=int, default=128)
    p.add_argument("--nfr", type=int, default=16)
    p.add_argument("--batchsize", type=int, default=4)
    p.add_argument("--metric", type=str, default="roc", choices=["roc", "pr"])
    p.add_argument("--test_data_path", type=str, required=True)
    p.add_argument("--test_model_list_path", type=str, required=True)
    p.add_argument("--result_path", type=str, default="results/test")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


# The reference's path-substring dispatch (test.py:115-144) in its if/elif
# order, "mygan" a synonym of "ganbase" as in the JAX CLI: (substring,
# family, display name)
_SUBSTRING_DISPATCH = (
    ("ganbase", "mygan", "Propose model[GAN]"),
    ("mygan", "mygan", "Propose model[GAN]"),
    ("c2plus1d", "c2plus1d", "(2+1)DCNN"),
    ("xception", "xception", "XceptionNet"),
    ("clstm", "clstm", "ConvLSTM"),
)
_NAMES = {family: name for _, family, name in _SUBSTRING_DISPATCH}


def _family_of(sd: dict) -> str:
    """The family of a ``state_dict`` by its structure (the counterpart of
    the JAX CLI's ``_model_from_params``)."""
    if has_module(sd, "dconv1") and has_module(sd, "uconv1"):
        return "mygan"
    for family, module in (("c2plus1d", "down_sep1"), ("xception", "block1"),
                           ("clstm", "clstm1")):
        if has_module(sd, module):
            return family
    raise SystemExit("cannot infer model type from checkpoint structure")


def load_model(ckpt: str, device: torch.device):
    """The model of one listed checkpoint, loaded ``strict=True``, in eval
    mode on ``device``, and its display name."""
    if os.path.isdir(ckpt):
        raise SystemExit(
            f"{ckpt} is a directory: Orbax checkpoints need jax; convert it "
            f"with `python -m vfd_gan_tpu.cli.export_torch --ckpt {ckpt}` "
            "and pass the .pth it writes")
    if ckpt.endswith(".pth"):
        family = next((f for sub, f, _ in _SUBSTRING_DISPATCH
                       if sub in ckpt), None)
        if family is None:
            raise SystemExit("Weight path not found.")   # test.py:134
        sd = load_state_dict(ckpt)
    else:
        # a port run's full train state: G of a GAN run, else the model
        tree = restore_checkpoint(ckpt)
        net = tree.get("netG", tree.get("state"))
        if not isinstance(net, dict) or "module" not in net:
            raise SystemExit(f"{ckpt}: neither a .pth nor a port run's "
                             "train state (weights/latest.pt)")
        sd = net["module"]
        family = _family_of(sd)
    model = build_model(family, sd, device, torch.float32)
    model.load_state_dict(sd, strict=True)
    return model.eval(), _NAMES[family]


@torch.inference_mode()
def predict_batches(model: torch.nn.Module, batches):
    """Pixel labels and raw sigmoid scores of a model over batches of
    uint8 ``data``/``real``/``mask`` clips, both flat numpy arrays."""
    device = next(model.parameters()).device
    gts, preds = [], []
    for batch in batches:
        data, _, gt = normalize_clips(
            *(torch.as_tensor(batch[k]).to(device)
              for k in ("data", "real", "mask")))
        pred = to_channel_last(model(to_channel_first(data)))
        gts.append(gt.cpu().numpy())
        preds.append(pred.float().cpu().numpy())
    labels = np.asarray(np.stack(gts), dtype=np.int32).ravel()
    return labels, np.stack(preds).ravel()


def _write_curve(path: str, header, xs, ys) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(zip(xs, ys))


def _draw(curves: list, metric: str, path: str) -> bool:
    """All models' curves on one figure at ``path``, as the JAX CLI draws
    it; False where matplotlib does not import."""
    try:
        import matplotlib
    except ImportError:
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure()
    for name, area, eer, xs, ys in curves:
        if metric == "roc":
            plt.plot(xs, ys, lw=2, label="%s: (AUC = %0.2f, EER = %0.2f)"
                     % (name, area, eer))
            plt.plot([eer], [1 - eer], marker="o", markersize=5,
                     color="navy")
        else:
            plt.plot(xs, ys, lw=2, label="%s: (AUC = %0.2f)" % (name, area))
    plt.plot([0, 1], [1, 0], color="navy", lw=1, linestyle=":")
    plt.xlim([0.0, 1.0])
    plt.ylim([0.0, 1.05])
    if metric == "roc":
        plt.xlabel("False Positive Rate")
        plt.ylabel("True Positive Rate")
        plt.title("Receiver operating characteristic")
    else:
        plt.xlabel("Recall")
        plt.ylabel("Precision")
        plt.title("Precision-Recall Curve")
    plt.legend(loc="lower right")
    plt.savefig(path)
    plt.close(fig)
    return True


def evaluate_checkpoints(ckpts, batches, metric: str, result_path: str,
                         device: torch.device) -> dict:
    """Score each checkpoint of ``ckpts`` over ``batches`` (iterated once
    per checkpoint); returns ``{display name: {"auc", "f1", "eer"}}``."""
    os.makedirs(result_path, exist_ok=True)
    results, curves = {}, []
    for i, ckpt in enumerate(ckpts):
        print(f"\n {ckpt}")
        model, name = load_model(ckpt, device)
        labels, scores = predict_batches(model, batches)
        del model
        stem = os.path.splitext(os.path.basename(ckpt))[0]
        csv_path = os.path.join(result_path,
                                f"{metric}_curve_{i}_{stem}.csv")
        eer = None
        if metric == "roc":
            area, eer, xs, ys = roc_auc_with_eer(labels, scores)
            _write_curve(csv_path, ("fpr", "tpr"), xs, ys)
        else:
            area, ys, xs = pr_auc(labels, scores)
            _write_curve(csv_path, ("recall", "precision"), xs, ys)
        curves.append((name, area, eer, xs, ys))
        f1 = evaluate(labels, scores, metric="f1_score")
        results[name] = {"auc": area, "f1": f1, "eer": eer}
        print("%s / %s == %f" % (ckpt, metric, area))
        print("%s / f1 == %f" % (ckpt, f1))
    out = os.path.join(result_path, f"{metric}_curve.png")
    if _draw(curves, metric, out):
        print(f"saved {out}")
    else:
        print(f"matplotlib is not installed: {out} not drawn (the curves "
              f"are in the {metric}_curve_*.csv files beside it)")
    return results


def main(argv=None):
    args = build_parser().parse_args(argv)
    from vfd_gan_tpu_torch.data.dataset import (
        ClipBatchIterator,
        MdfVideoDataset,
    )

    device = resolve_device(args.device)
    ds = MdfVideoDataset(args.test_data_path, args.nfr, staging=args.isize)
    loader = ClipBatchIterator(ds, args.batchsize, shuffle=False)
    with open(args.test_model_list_path) as f:
        ckpts = [ln.rstrip() for ln in f if ln.strip()]
    return evaluate_checkpoints(ckpts, loader, args.metric, args.result_path,
                                device)


if __name__ == "__main__":
    main()
