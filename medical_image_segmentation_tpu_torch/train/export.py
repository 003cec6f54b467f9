"""``mis-export-torch``: package a trained segmentation checkpoint as a
deployable serving artifact (``.misx``, see ``serve.py``). Port of
``train/export.py:24-113``.

The artifact holds the EXACT function ``mis-predict-torch`` serves — uint8
batch → normalize → U-Net eval forward → sigmoid-threshold mask — captured
with ``torch.export`` once per batch bucket, the trained weights inside.
Serving hosts load it with ``mis-predict-torch --exported model.misx`` (or
``serve.load_predictor``): no model code, no checkpoint.

  mis-export-torch --checkpoint ckpt/seg --dataset DECATHLON_LIVER \\
      --output model.misx [--batch_sizes 1,8,64] [--device cuda]

The flags of the JAX CLI, with ``--device`` (default ``cuda``, raises
without a card) in place of ``--platforms``: a captured program holds its
device, so the artifact serves on the device type it was exported on.
``--checkpoint`` takes a ``.pt``, its directory, or an orbax checkpoint of
the JAX package. The last line of standard output is a JSON summary.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional, Sequence

import torch

from medical_image_segmentation_tpu_torch.core.checkpoint import restore_model
from medical_image_segmentation_tpu_torch.ops.augment import parse_hu_windows
from medical_image_segmentation_tpu_torch.serve import export_predictor, save_predictor
from medical_image_segmentation_tpu_torch.train.predict import resolve_stats
from medical_image_segmentation_tpu_torch.train.segmentation_task import SegmentationTask
from medical_image_segmentation_tpu_torch.train.train_ssl import resolve_device


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Export a segmentation checkpoint as a .misx serving artifact "
                                             "(PyTorch/CUDA port)")
    ap.add_argument("--checkpoint", required=True,
                    help="segmentation checkpoint directory (latest step), a specific <step>.pt, or an orbax "
                         "checkpoint of the JAX package")
    ap.add_argument("--output", required=True, help="output .misx path")
    ap.add_argument("--arch", default="resnet18")
    ap.add_argument("--image_size", type=int, default=224)
    ap.add_argument("--dataset", default=None,
                    help="datamodule name to pull normalization stats from (e.g. DECATHLON_LIVER)")
    ap.add_argument("--mean", type=float, default=None, help="override normalization mean (0-1 scale)")
    ap.add_argument("--std", type=float, default=None, help="override normalization std (0-1 scale)")
    ap.add_argument("--threshold", type=float, default=0.5, help="sigmoid cut baked into the artifact")
    ap.add_argument("--hu_windows", default=None, metavar="L:W,L:W,…",
                    help="fixed display windows stacked as input channels — must match "
                         "the --hu_windows the checkpoint trained with; baked into the artifact")
    ap.add_argument("--batch_sizes", default="1,8,64",
                    help="comma-separated static batch buckets to export (requests "
                         "greedily decompose over the largest buckets that fit; only a "
                         "remainder smaller than every bucket pads)")
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
    mean, std = resolve_stats(args)
    hu_windows = parse_hu_windows(args.hu_windows) if args.hu_windows else ()
    task = SegmentationTask(arch=args.arch, n_classes=1, in_channels=len(hu_windows) or 1,
                            dtype=torch.bfloat16 if args.bf16 else torch.float32, device=device)
    step = restore_model(task, args.checkpoint)

    exported = export_predictor(task, image_size=args.image_size, mean=mean, std=std, threshold=args.threshold,
                                batch_sizes=[int(b) for b in args.batch_sizes.split(",") if b],
                                hu_windows=hu_windows)
    meta = {
        "kind": "batched2d",
        "arch": args.arch,
        "image_size": args.image_size,
        "mean": mean,
        "std": std,
        "threshold": args.threshold,
        "hu_windows": [list(w) for w in hu_windows],
        "batch_sizes": sorted(exported),
        "platforms": [device.type],
        "checkpoint_step": step,
        "torch_version": torch.__version__,
        "dtype": "bfloat16" if args.bf16 else "float32",
    }
    save_predictor(args.output, exported, meta)
    summary = {"artifact": args.output, "bytes": os.path.getsize(args.output),
               **{k: meta[k] for k in ("batch_sizes", "platforms", "checkpoint_step")}}
    print(json.dumps(summary))
    return summary


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
