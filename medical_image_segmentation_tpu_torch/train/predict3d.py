"""Volumetric mask inference CLI (``mis-predict3d-torch``).

Port of ``train/predict3d.py:30-185``: loads a checkpoint of
``mis-train-segmentation3d-torch`` (or an orbax checkpoint of the JAX
package, or an exported window artifact) and writes a binary mask for every
NIfTI volume of a directory, at its native size, through overlapped
sliding-window blending: the fused predictor of ``eval/sliding_window.py``,
built once per volume shape (on the card, one captured CUDA graph), kept
for the most recent shapes and replayed per volume.

  mis-predict3d-torch --checkpoint ckpt/seg3d --features 32 64 128 256 \\
      --images_dir volumes/ --output_dir masks/ --window 32 64 64
  mis-predict3d-torch --exported model.misx --images_dir volumes/ --output_dir masks/

Each volume is min-max scaled to 0..1, turned from the file's (X, Y, Z) to
(D=Z, H=X, W=Y), windowed (``--hu_windows``) and normalized; the mask is
sigmoid > ``--threshold``, written as uint8 0/1 ``<stem>_mask.nii.gz`` back
in (X, Y, Z): the input's voxel grid and axis order under an identity
header (unit spacing, no affine of the input's), as the JAX CLI writes it.
With ``--exported`` (``mis-export3d-torch``) the window shape, the window
batch, the display windows and the normalization come from the artifact,
which takes raw 0..1 windows (a volume smaller than the window is then
zero-padded before it is normalized, and after on the checkpoint path, as
in the JAX CLI). The last line of standard output is a JSON
throughput summary (megavoxels a second through read → predict → write).

With ``--checkpoint``, one process uses every local device of
``--device`` (``parallel/replicas.py``; JAX ``:104-105,146-157``): the
loop in place of the fused predictor, each window batch split over one
eval-mode copy of the network a device. ``--exported`` serves on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from medical_image_segmentation_tpu_torch.core.checkpoint import restore_model
from medical_image_segmentation_tpu_torch.data.nifti import write_nifti
from medical_image_segmentation_tpu_torch.data.volumes import minmax_unit, nifti_names, read_volume
from medical_image_segmentation_tpu_torch.eval.sliding_window import (
    FusedCache, count_windows_3d, make_fused_predictor_3d, sliding_window_predict_3d,
)
from medical_image_segmentation_tpu_torch.ops.augment import parse_hu_windows
from medical_image_segmentation_tpu_torch.ops.dice import post_process_masks
from medical_image_segmentation_tpu_torch.parallel.replicas import local_devices
from medical_image_segmentation_tpu_torch.serve import load_window_predictor, normalize_unit
from medical_image_segmentation_tpu_torch.train.loop import resolve_device
from medical_image_segmentation_tpu_torch.train.seg3d_task import Segmentation3DTask


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Volumetric 3D U-Net mask inference (PyTorch/CUDA port)")
    ap.add_argument("--checkpoint", default=None,
                    help="seg3d checkpoint directory (latest step), a specific <step>.pt, or an orbax "
                         "checkpoint of the JAX package")
    ap.add_argument("--exported", default=None,
                    help="serve from a window .misx artifact (mis-export3d-torch) instead of "
                         "a checkpoint: window shape, normalization and hu_windows come from "
                         "the artifact; no model code or restore")
    ap.add_argument("--features", type=int, nargs="+", default=(32, 64, 128, 256))
    ap.add_argument("--norm", default="group", choices=["group", "batch"])
    ap.add_argument("--window", type=int, nargs=3, default=(32, 64, 64), metavar=("D", "H", "W"),
                    help="sliding-window shape (matches the training crop)")
    ap.add_argument("--mean", type=float, default=0.2089, help="normalization mean (0-1 scale)")
    ap.add_argument("--std", type=float, default=0.2109)
    ap.add_argument("--images_dir", required=True, help="directory of .nii/.nii.gz volumes")
    ap.add_argument("--output_dir", required=True, help="masks written here as 0/1 uint8 NIfTI")
    ap.add_argument("--threshold", type=float, default=0.5, help="sigmoid cut for the binary mask")
    ap.add_argument("--hu_windows", default=None, metavar="L:W,L:W,…",
                    help="fixed display windows (0-1 scale) stacked as input channels — must match the "
                         "--hu_windows the checkpoint trained with")
    ap.add_argument("--batch_windows", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="torch device; cuda raises if absent")
    ap.add_argument("--bf16", action="store_true", default=True)
    ap.add_argument("--fp32", dest="bf16", action="store_false")
    return ap.parse_args(argv)


def run(argv: Optional[Sequence[str]] = None, fused: bool = True,
        devices: Optional[Sequence] = None) -> Dict[str, object]:
    """Serve every volume; returns the JSON summary it prints. ``fused``
    False serves through the loop instead of the fused predictor (what the
    fused variant is measured against). ``devices``: where a
    ``--checkpoint`` run computes (default: every local device of
    ``--device``); more than one splits each window batch over them."""
    args = parse_args(argv)
    if (args.checkpoint is None) == (args.exported is None):
        raise SystemExit("exactly one of --checkpoint / --exported is required")
    device = resolve_device(args.device)
    devices = [device] if args.exported is not None else [
        torch.device(d) for d in (local_devices(args.device) if devices is None else devices)]
    multi = len(devices) > 1
    if multi:
        device = devices[0]
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True

    if args.exported is not None:
        # weights, hu_windows and normalize are inside the artifact: it is
        # fed RAW 0..1 windows
        meta, window_fn = load_window_predictor(args.exported, device=device)
        args.window = tuple(meta["window"])
        args.batch_windows = int(meta["batch_windows"])
        print(f"loaded {args.exported} (step {meta.get('checkpoint_step')}, "
              f"window {args.window} x{args.batch_windows})", file=sys.stderr)

        def prepare(x01: torch.Tensor) -> torch.Tensor:
            return x01
    else:
        hu_windows = parse_hu_windows(args.hu_windows, value_max=1.0) if args.hu_windows else ()
        task = Segmentation3DTask(in_channels=len(hu_windows) or 1, features=tuple(args.features), norm=args.norm,
                                  dtype=torch.bfloat16 if args.bf16 else torch.float32, device=device)
        restore_model(task, args.checkpoint)
        window_fn = task.replicas(devices) if multi else task.logits

        def prepare(x01: torch.Tensor) -> torch.Tensor:
            return normalize_unit(x01, args.mean, args.std, hu_windows)

    names = nifti_names(args.images_dir)
    if not names:
        raise SystemExit(f"no NIfTI volumes under {args.images_dir}")
    os.makedirs(args.output_dir, exist_ok=True)
    window = tuple(args.window)
    fused = fused and not multi  # several devices: the loop, each window batch split over them
    if fused:  # one predictor per volume shape, the most recent shapes kept
        predict = FusedCache(lambda shape: make_fused_predictor_3d(
            window_fn, shape, window=window, batch_windows=args.batch_windows, device=device))
    else:
        def predict(x):
            return sliding_window_predict_3d(window_fn, x, window=window, batch_windows=args.batch_windows,
                                             devices=devices)

    t0 = time.time()
    n_vox, n_win, per_volume = 0, 0, []
    for name in names:
        t_vol = time.time()
        x = prepare(torch.from_numpy(minmax_unit(read_volume(os.path.join(args.images_dir, name)))[..., None])
                    .to(device))
        logits = predict(x)
        mask = post_process_masks(logits, threshold=args.threshold)[..., 0].to(torch.uint8).cpu().numpy()
        mask = np.moveaxis(mask, 0, -1)  # back to (X, Y, Z)
        out = os.path.join(args.output_dir, f"{name.split('.nii')[0]}_mask.nii.gz")
        write_nifti(out, mask)
        n_vox += mask.size
        n_win += count_windows_3d(x.shape[:3], window)
        per_volume.append(time.time() - t_vol)
        print(f"{name}: {mask.shape} mask → {out} ({float(mask.mean()):.4f} foreground)", file=sys.stderr)
    dt = time.time() - t0
    summary = {"metric": "predict3d_megavoxels_per_sec", "value": round(n_vox / dt / 1e6, 3), "unit": "Mvox/s",
               "volumes": len(names), "window": list(window), "windows": n_win, "seconds": dt,
               "seconds_per_volume": per_volume, "exported": args.exported is not None, "devices": len(devices)}
    if fused:
        summary.update(fused_shapes=predict.built, capture_seconds=predict.capture_seconds)
    print(json.dumps(summary))
    return summary


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
