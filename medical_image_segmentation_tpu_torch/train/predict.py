"""Batched segmentation inference CLI (``mis-predict-torch``).

Port of ``train/predict.py:41-321``: loads a checkpoint of
``mis-train-segmentation-torch`` and writes a binary mask for every slice
of a PNG/DICOM directory or an MIS store.

  mis-predict-torch --checkpoint ckpt/seg --dataset DECATHLON_LIVER \\
      --images_dir slices/ --output_dir masks/ [--overlay_dir overlays/] \\
      [--sliding_window 224] [--threshold 0.5] [--batch_size 64]

- **batched** (default): nearest-resize each slice on the host to
  ``--image_size``, forward batches of ``--batch_size`` (a short last batch
  keeps the full shape; its stale rows are dropped), then nearest-resize
  each mask back to its slice's size;
- **--sliding_window N**: full-resolution inference through overlapping
  blended windows (``eval/sliding_window.py``), one loop path for every
  window count.

Masks are 0/255 PNGs named after their inputs; ``--overlay_dir`` adds
red overlays. The last line of standard output is a JSON throughput
summary (images/s through load → predict → write). ``--exported`` (the
AOT artifact) is not ported yet and raises.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from medical_image_segmentation_tpu.data.loader import SEQUENTIAL, Loader
from medical_image_segmentation_tpu_torch.core.checkpoint import resolve_checkpoint_path
from medical_image_segmentation_tpu_torch.data.datamodules import get_datamodule
from medical_image_segmentation_tpu_torch.eval.sliding_window import make_unet_window_fn, sliding_window_predict
from medical_image_segmentation_tpu_torch.ops.augment import parse_hu_windows
from medical_image_segmentation_tpu_torch.ops.dice import post_process_masks
from medical_image_segmentation_tpu_torch.serve import make_predict_fn, normalize_u8
from medical_image_segmentation_tpu_torch.train.segmentation_task import SegmentationTask
from medical_image_segmentation_tpu_torch.train.train_ssl import resolve_device
from medical_image_segmentation_tpu_torch.utils.png import write_png


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Batched U-Net mask inference (PyTorch/CUDA port)")
    ap.add_argument("--checkpoint", default=None,
                    help="segmentation checkpoint directory (latest step) or a specific <step>.pt")
    ap.add_argument("--exported", default=None, help="not ported yet")
    ap.add_argument("--arch", default="resnet18")
    ap.add_argument("--image_size", type=int, default=224,
                    help="network input size in batched mode (matches training)")
    ap.add_argument("--dataset", default=None,
                    help="datamodule name to pull normalization stats from (e.g. DECATHLON_LIVER)")
    ap.add_argument("--mean", type=float, default=None, help="override normalization mean (0-1 scale)")
    ap.add_argument("--std", type=float, default=None, help="override normalization std (0-1 scale)")
    ap.add_argument("--images_dir", default=None, help="directory of PNG or DICOM slices")
    ap.add_argument("--image_store", default=None, help="MIS store of slices")
    ap.add_argument("--output_dir", required=True, help="masks are written here as 0/255 PNGs")
    ap.add_argument("--overlay_dir", default=None, help="also write red-overlay PNGs here")
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--threshold", type=float, default=0.5, help="sigmoid cut for the binary mask")
    ap.add_argument("--hu_windows", default=None, metavar="L:W,L:W,…",
                    help="fixed display windows stacked as input channels — must match "
                         "the --hu_windows the checkpoint trained with")
    ap.add_argument("--sliding_window", type=int, default=0,
                    help=">0: full-resolution inference with blended windows of this size")
    ap.add_argument("--num_workers", type=int,
                    default=int(os.environ.get("SLURM_CPUS_PER_TASK", os.cpu_count() or 4)))
    ap.add_argument("--device", default="cuda", help="torch device; cuda raises if absent")
    ap.add_argument("--bf16", action="store_true", default=True)
    ap.add_argument("--fp32", dest="bf16", action="store_false")
    return ap.parse_args(argv)


def _load_slice(path: str) -> np.ndarray:
    """One grayscale slice as uint8 (H, W): PNG via OpenCV, DICOM via the
    native reader with min-max scaling (``train/predict.py:73-95``)."""
    if path.lower().endswith(".dcm"):
        from medical_image_segmentation_tpu.data.dicom import read_dicom

        arr = read_dicom(path).pixel_array
        if arr.ndim == 3:  # multi-frame: serve the first frame
            arr = arr[0]
        arr = arr.astype(np.float64)
        lo, hi = arr.min(), arr.max()
        return (((arr - lo) / (hi - lo) if hi > lo else arr * 0) * 255).astype(np.uint8)
    import cv2

    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise ValueError(f"unreadable image {path}")
    if img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    if img.dtype == np.uint16:  # 16-bit radiology PNGs
        img = (img / 256).astype(np.uint8)
    return img.astype(np.uint8)


def _resize_nearest(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    ys = np.arange(hw[0]) * img.shape[0] // hw[0]
    xs = np.arange(hw[1]) * img.shape[1] // hw[1]
    return img[ys][:, xs]


def _write_mask(path: str, mask01: np.ndarray) -> None:
    write_png(path, (mask01 * 255).astype(np.uint8))


def _write_overlay(path: str, gray: np.ndarray, mask01: np.ndarray) -> None:
    """The slice in gray, the mask blended half into red."""
    rgb = np.stack([gray, gray, gray], axis=-1)
    red = rgb.copy()
    red[..., 0] = np.maximum(red[..., 0], (mask01 * 255).astype(np.uint8))
    write_png(path, np.where(mask01[..., None] > 0, (0.5 * rgb + 0.5 * red), rgb).astype(np.uint8))


def _sources(args) -> Iterator[Tuple[str, np.ndarray]]:
    """(name, uint8 (H, W) slice) pairs of ``--images_dir`` or ``--image_store``."""
    if args.images_dir is not None:
        names = sorted(f for f in os.listdir(args.images_dir) if f.lower().endswith((".png", ".jpg", ".jpeg", ".dcm")))
        if not names:
            raise SystemExit(f"no PNG/JPEG/DICOM slices in {args.images_dir}")
        for f in names:
            yield f, _load_slice(os.path.join(args.images_dir, f))
        return
    with contextlib.closing(Loader(args.image_store, args.batch_size, order=SEQUENTIAL,
                                   num_threads=args.num_workers, drop_last=False, prefetch=2)) as loader:
        i = 0
        for imgs, _ in loader:
            for img in imgs:
                yield f"{i:08d}.png", img[..., 0]
                i += 1


def run(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Serve every slice; returns the JSON summary it prints."""
    args = parse_args(argv)
    if (args.images_dir is None) == (args.image_store is None):
        raise SystemExit("exactly one of --images_dir / --image_store is required")
    if args.exported is not None:
        raise SystemExit("--exported: the AOT artifact is not ported to the PyTorch package yet "
                         "(see ROADMAP.md); run medical_image_segmentation_tpu for it")
    if args.checkpoint is None:
        raise SystemExit("--checkpoint is required")
    device = resolve_device(args.device)

    mean, std = args.mean, args.std
    if mean is None or std is None:
        if args.dataset is None:
            raise SystemExit("pass --dataset (registry stats) or --mean/--std")
        dm = get_datamodule(args.dataset)()
        mean = mean if mean is not None else float(dm.mean[0])
        std = std if std is not None else float(dm.std[0])
    hu_windows = parse_hu_windows(args.hu_windows) if args.hu_windows else ()
    task = SegmentationTask(arch=args.arch, n_classes=1, in_channels=len(hu_windows) or 1,
                            dtype=torch.bfloat16 if args.bf16 else torch.float32, device=device)
    ckpt = resolve_checkpoint_path(args.checkpoint)
    state = torch.load(ckpt, map_location=device, weights_only=True)
    task.model.load_state_dict(state["model"])
    print(f"restored {ckpt} (step {state['step']})", file=sys.stderr)
    os.makedirs(args.output_dir, exist_ok=True)
    if args.overlay_dir:
        os.makedirs(args.overlay_dir, exist_ok=True)

    def write(name: str, img: np.ndarray, mask: np.ndarray) -> None:
        base = os.path.splitext(name)[0] + "_mask.png"
        _write_mask(os.path.join(args.output_dir, base), mask)
        if args.overlay_dir:
            _write_overlay(os.path.join(args.overlay_dir, base), img, mask)

    t0 = time.time()
    n_done = 0
    if args.sliding_window:
        window_fn = make_unet_window_fn(task)
        for name, img in _sources(args):
            x = normalize_u8(torch.from_numpy(img[..., None]).to(device), mean, std, hu_windows)
            logits = sliding_window_predict(window_fn, x, window=args.sliding_window)
            write(name, img, post_process_masks(logits, threshold=args.threshold)[..., 0].cpu().numpy())
            n_done += 1
    else:
        predict = make_predict_fn(task, mean, std, threshold=args.threshold, hu_windows=hu_windows)
        size = args.image_size
        buf = np.zeros((args.batch_size, size, size, 1), np.uint8)
        pending = []  # (name, slice) of the rows of buf in use

        def flush() -> int:
            masks = predict(torch.from_numpy(buf).to(device)).cpu().numpy()[..., 0]
            for (name, img), mask in zip(pending, masks):
                write(name, img, mask if mask.shape == img.shape else _resize_nearest(mask, img.shape))
            done = len(pending)
            pending.clear()
            return done

        for name, img in _sources(args):
            buf[len(pending), ..., 0] = img if img.shape == (size, size) else _resize_nearest(img, (size, size))
            pending.append((name, img))
            if len(pending) == args.batch_size:
                n_done += flush()
        if pending:
            n_done += flush()

    dt = time.time() - t0
    summary = {"metric": "predict_images_per_sec", "value": round(n_done / dt, 2), "unit": "images/sec",
               "images": n_done, "mode": "sliding_window" if args.sliding_window else "batched",
               "exported": False, "seconds": dt}
    print(json.dumps(summary))
    return summary


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
