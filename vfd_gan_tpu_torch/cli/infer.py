"""Stream a video through a mask model (port of ``vfd_gan_tpu.cli.infer``).

Windows the video into ``nfr``-frame clips, runs the model over them (the
MyGAN generator, the "c2plus1d" AutoEncoder, Xception-3D or the ConvLSTM,
picked by the checkpoint's file name as the reference does), and writes

* ``<out>/mask.mp4``    -- the predicted per-pixel forgery-mask video
* ``<out>/overlay.mp4`` -- the input with the thresholded and opened mask
  burned in red (threshold 0.5 + 5x5 opening, the reference's
  post-processing, lib/utils.py:139-152)
* ``<out>/scores.csv``  -- per-frame mean mask score

Usage::

    python -m vfd_gan_tpu_torch.cli.infer --video clip.mp4 \\
        --ckpt run_netG.pth --out out/ [--dtype bfloat16] [--device cuda] \\
        [--quant int8 [--calib_plist videos.txt | --calib_clips 8]]

``--dtype bfloat16`` builds the model computing in bfloat16 from the
checkpoint's float32 parameters, as the JAX ``infer`` does
(``models/layers.py``); the clips in and the mask out stay float32.
``--quant int8`` serves the int8 post-training-quantised forward of the
family (``quant/``: BN folded, per-output-channel int8 weights, activation
scales calibrated on one leading clip of each video in ``--calib_plist``,
or on ``--calib_clips`` uniform [-1, 1] clips), its name tagged
`` [int8]``; ``--dtype`` is then ignored, as in JAX.  The post-processing
runs on the opening kernel either way.

The checkpoint is a reference-format ``.pth``, picked by its file name,
or a port run's full train state (``weights/latest.pt``: G of a GAN run,
else the model), picked by the structure of its ``state_dict`` as
``cli.evaluate_models`` does; an Orbax run directory of the JAX package
converts to a ``.pth`` with ``python -m vfd_gan_tpu.cli.export_torch
--ckpt <dir>``.  Video decode and encode use cv2 through
``vfd_gan_tpu_torch.data.video_io``, which imports it on use.
"""

from __future__ import annotations

import argparse
import csv
import os

import numpy as np
import torch

from vfd_gan_tpu_torch.models import DTYPES
from vfd_gan_tpu_torch.models.convlstm import ConvLSTMModel
from vfd_gan_tpu_torch.models.mygan import Generator
from vfd_gan_tpu_torch.models.stcnn import AutoEncoder
from vfd_gan_tpu_torch.models.xception3d import Xception3D
from vfd_gan_tpu_torch.ops.image import (
    threshold,
    to_channel_first,
    to_channel_last,
)
from vfd_gan_tpu_torch.ops.morphology import video_open
from vfd_gan_tpu_torch.train.checkpoints import restore_checkpoint
from vfd_gan_tpu_torch.utils.checkpoint import has_module, load_state_dict
from vfd_gan_tpu_torch.utils.runtime import module_device, resolve_device


def build_parser():
    p = argparse.ArgumentParser(description="stream a video into mask output")
    p.add_argument("--video", required=True)
    p.add_argument("--ckpt", required=True,
                   help="reference-format .pth whose name holds netG, "
                        "ganbase, mygan, c2plus1d, xception or clstm, or "
                        "a port run's weights/latest.pt")
    p.add_argument("--out", required=True)
    p.add_argument("--isize", type=int, default=128)
    p.add_argument("--morph_plane", choices=("th", "hw"), default="th",
                   help="opening plane: th = reference cv2 quirk "
                        "(PARITY.md), hw = per-frame")
    p.add_argument("--nfr", type=int, default=16)
    p.add_argument("--dtype", choices=tuple(DTYPES), default="float32",
                   help="compute dtype (parameters stay float32; ignored "
                        "with --quant int8)")
    add_quant_args(p)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def add_quant_args(p) -> None:
    """``--quant``, ``--calib_plist`` and ``--calib_clips`` (the JAX
    CLIs')."""
    p.add_argument("--quant", choices=("none", "int8"), default="none",
                   help="int8: BN-fold + post-training-quantise the "
                        "family's convs (quant/)")
    p.add_argument("--calib_plist", default="",
                   help="videos for int8 activation calibration (one "
                        "leading clip each); default synthetic")
    p.add_argument("--calib_clips", type=int, default=8,
                   help="synthetic calibration clips when no "
                        "--calib_plist")


# The reference's path-substring dispatch (test.py:115-144) in its if/elif
# order, with "netG" and "mygan" as synonyms of "ganbase" as in the JAX
# package: (substrings, family, display name).
DISPATCH = (
    (("netG", "ganbase", "mygan"), "mygan", "Propose model[GAN]"),
    (("c2plus1d",), "c2plus1d", "(2+1)DCNN"),
    (("xception",), "xception", "XceptionNet"),
    (("clstm",), "clstm", "ConvLSTM"),
)


def build_model(family: str, sd: dict, device: torch.device,
                dtype: torch.dtype) -> torch.nn.Module:
    """The family's model at the checkpoint's width (the reference's is
    ngf = 32 and Xception's full width), computing in ``dtype``."""
    kw = {"dtype": dtype, "device": device}
    if family == "mygan":
        return Generator(ngf=sd["conv_last.weight"].shape[1], **kw)
    if family == "c2plus1d":
        return AutoEncoder(**kw)
    if family == "xception":
        # bn4 normalises the trunk's widest layer, 2048 x width_mult; an
        # MoE model's router is (C, E)
        moe = sd.get("moe.router")
        return Xception3D(sd["conv1.weight"].shape[1],
                          sd["bn4.weight"].shape[0] / 2048,
                          moe_experts=0 if moe is None else moe.shape[1],
                          **kw)
    return ConvLSTMModel(**kw)


NAMES = {family: name for _, family, name in DISPATCH}


def family_of(sd: dict) -> str:
    """The family of a ``state_dict`` by its structure (the counterpart of
    the JAX CLI's ``_model_from_params``)."""
    if has_module(sd, "dconv1") and has_module(sd, "uconv1"):
        return "mygan"
    for family, module in (("c2plus1d", "down_sep1"), ("xception", "block1"),
                           ("clstm", "clstm1")):
        if has_module(sd, module):
            return family
    raise SystemExit("cannot infer model type from checkpoint structure")


def refuse_directory(ckpt: str) -> None:
    if os.path.isdir(ckpt):
        raise SystemExit(
            f"{ckpt} is a directory: Orbax checkpoints need jax; convert it "
            f"with `python -m vfd_gan_tpu.cli.export_torch --ckpt {ckpt}` "
            "and pass the .pth it writes")


def load_run_model(ckpt: str, device: torch.device,
                   dtype: torch.dtype = torch.float32):
    """The model of a port run's full train state (``weights/latest.pt``:
    G of a GAN run, else the model), its family read from the structure
    of its ``state_dict``, loaded ``strict=True`` in eval mode on
    ``device``, computing in ``dtype``; and the family."""
    tree = restore_checkpoint(ckpt)
    net = tree.get("netG", tree.get("state"))
    if not isinstance(net, dict) or "module" not in net:
        raise SystemExit(f"{ckpt}: neither a .pth nor a port run's "
                         "train state (weights/latest.pt)")
    sd = net["module"]
    family = family_of(sd)
    model = build_model(family, sd, device, dtype)
    model.load_state_dict(sd, strict=True)
    return model.eval(), family


def _load(ckpt: str, device: torch.device,
          dtype: torch.dtype = torch.float32):
    """Model for a ``.pth`` by the reference's filename rule
    (test.py:115-144), or for any other file by the structure of a port
    run's train state (``load_run_model``), loaded ``strict=True``, in
    eval mode on ``device``, computing in ``dtype`` (its parameters
    float32), and its display name (`` [bf16]`` appended in bfloat16, as
    the JAX CLIs do)."""
    refuse_directory(ckpt)
    tag = " [bf16]" if dtype == torch.bfloat16 else ""
    if not ckpt.endswith(".pth"):
        model, family = load_run_model(ckpt, device, dtype)
        return model, NAMES[family] + tag
    for substrings, family, name in DISPATCH:
        if any(sub in ckpt for sub in substrings):
            sd = load_state_dict(ckpt)
            model = build_model(family, sd, device, dtype)
            model.load_state_dict(sd, strict=True)
            return model.eval(), name + tag
    raise SystemExit(f"cannot infer model type from path: {ckpt}")


def load_for_serving(args, device: torch.device):
    """``_load`` under the serving flags: ``--dtype``, or with ``--quant
    int8`` the float32 model quantised (``quant.build_int8_serving``),
    `` [int8]`` in its name."""
    if args.quant != "int8":
        return _load(args.ckpt, device, DTYPES[args.dtype])
    from vfd_gan_tpu_torch.quant import build_int8_serving

    model, name = _load(args.ckpt, device)
    return build_int8_serving(
        model, isize=args.isize, nfr=args.nfr, calib_plist=args.calib_plist,
        calib_clips=args.calib_clips), name + " [int8]"


def postprocess(pred: torch.Tensor, plane: str = "th") -> torch.Tensor:
    """The reference's mask post-processing: threshold 0.5, then the 5x5
    opening, of a channel-last ``(B, T, H, W, 1)`` prediction."""
    return video_open(threshold(pred), plane)


@torch.inference_mode()
def predict_clips(model: torch.nn.Module, clips_uint8: np.ndarray,
                  plane: str = "th"):
    """Decode-free core of :func:`main`.

    ``clips_uint8``: ``(k, T, H, W, 3)`` uint8 frames.  Returns, on the
    model's device, ``pred`` ``(k, T, H, W, 1)`` float32, ``opened`` (its
    post-processed mask, same shape) and ``frame_scores`` ``(k, T)``, the
    mean mask score of each frame."""
    device = module_device(model)
    x = torch.from_numpy(np.ascontiguousarray(clips_uint8)).to(device)
    x = x.to(torch.float32) / 255.0 * 2.0 - 1.0
    pred = to_channel_last(model(to_channel_first(x)))
    opened = postprocess(pred, plane)
    frame_scores = pred[..., 0].flatten(2).mean(dim=2)
    return pred, opened, frame_scores


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    from vfd_gan_tpu_torch.data.video_io import (
        count_frames,
        read_clip,
        write_video,
    )

    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    model, name = load_for_serving(args, device)
    print(f"model: {name} on {device}")

    n_frames = count_frames(args.video)
    n_clips = n_frames // args.nfr
    if n_clips == 0:
        raise SystemExit(f"video too short: {n_frames} < {args.nfr} frames")

    masks, overlays, scores = [], [], []
    for c in range(n_clips):
        frames = read_clip(args.video, c * args.nfr, args.nfr,
                           resize_to=(args.isize, args.isize))
        pred, opened, frame_scores = predict_clips(model, frames[None],
                                                   args.morph_plane)
        p = pred[0, ..., 0].cpu().numpy()                   # (T, H, W)
        m = opened[0, ..., 0].cpu().numpy()
        masks.append((p * 255).astype(np.uint8))
        overlay = frames.copy()
        overlay[..., 0] = np.where(m > 0.5, 255, overlay[..., 0])
        overlays.append(overlay)
        scores.extend(frame_scores[0].cpu().tolist())

    mask_video = np.concatenate(masks)[..., None].repeat(3, axis=-1)
    write_video(os.path.join(args.out, "mask.mp4"), mask_video)
    write_video(os.path.join(args.out, "overlay.mp4"),
                np.concatenate(overlays))
    with open(os.path.join(args.out, "scores.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["frame", "mean_mask_score"])
        for i, s in enumerate(scores):
            w.writerow([i, f"{s:.6f}"])
    print(f"wrote {args.out}/mask.mp4, overlay.mp4, scores.csv "
          f"({n_clips} clips, {len(scores)} frames)")


if __name__ == "__main__":
    main()
