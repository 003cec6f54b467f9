"""``mis-export3d-torch``: package a trained volumetric (3D U-Net)
checkpoint as a window-function artifact (``.misx``, kind ``window3d``).
Port of ``train/export3d.py:22-95``.

The artifact is the sliding-window ``apply_fn``: raw 0..1 windows
(batch_windows, d, h, w, 1) f32 → f32 logits, with multi-window channel
stacking, normalization and the trained weights captured by
``torch.export``. ``mis-predict3d-torch --exported model.misx`` serves
whole NIfTI volumes from it: window extraction and the Hann blend stay
outside, every FLOP goes through the artifact, and the serving host needs
no model code and no checkpoint.

The flags of the JAX CLI, with ``--device`` (default ``cuda``, raises
without a card) in place of ``--platforms``. ``--checkpoint`` takes a
``.pt``, its directory, or an orbax checkpoint of the JAX package. The
last line of standard output is a JSON summary.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional, Sequence

import torch

from medical_image_segmentation_tpu_torch.core.checkpoint import restore_model
from medical_image_segmentation_tpu_torch.ops.augment import parse_hu_windows
from medical_image_segmentation_tpu_torch.serve import export_window_predictor, save_predictor
from medical_image_segmentation_tpu_torch.train.loop import resolve_device
from medical_image_segmentation_tpu_torch.train.seg3d_task import Segmentation3DTask


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Export a seg3d checkpoint as a .misx window artifact "
                                             "(PyTorch/CUDA port)")
    ap.add_argument("--checkpoint", required=True,
                    help="seg3d checkpoint directory (latest step), a specific <step>.pt, or an orbax "
                         "checkpoint of the JAX package")
    ap.add_argument("--output", required=True, help="output .misx path")
    ap.add_argument("--features", type=int, nargs="+", default=(32, 64, 128, 256))
    ap.add_argument("--norm", default="group", choices=["group", "batch"])
    ap.add_argument("--window", type=int, nargs=3, default=(32, 64, 64), metavar=("D", "H", "W"),
                    help="window shape (matches the training crop)")
    ap.add_argument("--mean", type=float, default=0.2089, help="normalization mean (0-1 scale)")
    ap.add_argument("--std", type=float, default=0.2109)
    ap.add_argument("--hu_windows", default=None, metavar="L:W,L:W,…",
                    help="fixed display windows (0-1 scale) the checkpoint trained with; baked in")
    ap.add_argument("--batch_windows", type=int, default=4,
                    help="static window batch baked into the artifact")
    ap.add_argument("--device", default="cuda",
                    help="torch device to export on and for; cuda raises if absent. The artifact serves on "
                         "this device type only")
    ap.add_argument("--bf16", action="store_true", default=True)
    ap.add_argument("--fp32", dest="bf16", action="store_false")
    return ap.parse_args(argv)


def run(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Export and write the artifact; returns the JSON summary it prints."""
    args = parse_args(argv)
    device = resolve_device(args.device)

    hu_windows = parse_hu_windows(args.hu_windows, value_max=1.0) if args.hu_windows else ()
    task = Segmentation3DTask(in_channels=len(hu_windows) or 1, features=tuple(args.features), norm=args.norm,
                              dtype=torch.bfloat16 if args.bf16 else torch.float32, device=device)
    step = restore_model(task, args.checkpoint)

    exported = export_window_predictor(task, window=args.window, mean=args.mean, std=args.std,
                                       batch_windows=args.batch_windows, hu_windows=hu_windows)
    meta = {
        "kind": "window3d",
        "window": [int(v) for v in args.window],
        "batch_windows": args.batch_windows,
        "features": list(args.features),
        "norm": args.norm,
        "mean": args.mean,
        "std": args.std,
        "hu_windows": [list(w) for w in hu_windows],
        "platforms": [device.type],
        "checkpoint_step": step,
        "torch_version": torch.__version__,
        "dtype": "bfloat16" if args.bf16 else "float32",
    }
    save_predictor(args.output, exported, meta)
    summary = {"artifact": args.output, "bytes": os.path.getsize(args.output),
               **{k: meta[k] for k in ("window", "batch_windows", "platforms", "checkpoint_step")}}
    print(json.dumps(summary))
    return summary


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
