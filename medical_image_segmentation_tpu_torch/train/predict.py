"""Batched segmentation inference CLI (``mis-predict-torch``).

Port of ``train/predict.py:41-321``: loads a checkpoint of
``mis-train-segmentation-torch`` (or an orbax checkpoint of the JAX
package, or an exported artifact) and writes a binary mask for every slice
of a PNG/DICOM directory or an MIS store.

  mis-predict-torch --checkpoint ckpt/seg --dataset DECATHLON_LIVER \\
      --images_dir slices/ --output_dir masks/ [--overlay_dir overlays/] \\
      [--sliding_window 224] [--threshold 0.5] [--batch_size 64]
  mis-predict-torch --exported model.misx --images_dir slices/ --output_dir masks/

- **batched** (default): nearest-resize each slice on the host to
  ``--image_size``, forward batches of ``--batch_size`` (a short last batch
  keeps the full shape; its stale rows are dropped), then nearest-resize
  each mask back to its slice's size;
- **--sliding_window N**: full-resolution inference through overlapping
  blended windows (``eval/sliding_window.py``) through the fused
  predictor: built once per slice shape (on the card, one captured CUDA
  graph), kept for the most recent shapes, replayed per slice;
- **--exported model.misx**: the batched mode served from an artifact of
  ``mis-export-torch`` (``serve.py``); image size, batch buckets,
  normalization, windows and threshold come from the artifact, so passing
  any of them beside it is refused. It serves on one card, as the JAX
  artifact route does.

With ``--checkpoint``, one process uses every local device of
``--device`` (``parallel/replicas.py``; JAX ``:189-209,249,260-265``):
each batch, and each sliding-window batch through the loop in place of the
fused predictor, is split over one eval-mode copy of the network a device.

Masks are 0/255 PNGs named after their inputs; ``--overlay_dir`` adds
red overlays. The last line of standard output is a JSON throughput
summary (images/s through load → predict → write). PNG slices are read
with OpenCV where it is installed and with ``utils/png.py`` where it is not.
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

from medical_image_segmentation_tpu_torch.core.checkpoint import restore_model
from medical_image_segmentation_tpu_torch.data.datamodules import get_datamodule
from medical_image_segmentation_tpu_torch.data.loader import SEQUENTIAL, Loader
from medical_image_segmentation_tpu_torch.eval.sliding_window import (
    FusedCache, make_fused_predictor_2d, make_unet_window_fn, sliding_window_predict,
)
from medical_image_segmentation_tpu_torch.ops.augment import parse_hu_windows
from medical_image_segmentation_tpu_torch.ops.dice import post_process_masks
from medical_image_segmentation_tpu_torch.parallel.replicas import local_devices
from medical_image_segmentation_tpu_torch.serve import load_predictor, make_predict_fn, normalize_u8
from medical_image_segmentation_tpu_torch.train.loop import resolve_device
from medical_image_segmentation_tpu_torch.train.segmentation_task import SegmentationTask
from medical_image_segmentation_tpu_torch.utils.png import decode_png, to_gray, write_png


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Batched U-Net mask inference (PyTorch/CUDA port)")
    ap.add_argument("--checkpoint", default=None,
                    help="segmentation checkpoint directory (latest step), a specific <step>.pt, or an orbax "
                         "checkpoint of the JAX package")
    ap.add_argument("--exported", default=None,
                    help="serve from a .misx artifact (mis-export-torch) instead of a "
                         "checkpoint: no model code or restore, batched mode only")
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
    """One grayscale slice as uint8 (H, W): DICOM via the native reader
    with min-max scaling, PNG/JPEG via OpenCV (``train/predict.py:73-95``).
    Without OpenCV a PNG goes through ``utils/png.py`` to the same pixels
    (OpenCV's fixed-point BT.601 gray, 16 bit / 256) and a JPEG raises."""
    if path.lower().endswith(".dcm"):
        from medical_image_segmentation_tpu_torch.data.dicom import read_dicom

        arr = read_dicom(path).pixel_array
        if arr.ndim == 3:  # multi-frame: serve the first frame
            arr = arr[0]
        arr = arr.astype(np.float64)
        lo, hi = arr.min(), arr.max()
        return (((arr - lo) / (hi - lo) if hi > lo else arr * 0) * 255).astype(np.uint8)
    try:
        import cv2
    except ImportError:
        if not path.lower().endswith(".png"):
            raise ValueError(f"{path}: reading JPEG slices needs OpenCV (cv2), which is not installed; "
                             "convert the slices to PNG or DICOM") from None
        with open(path, "rb") as f:
            img = to_gray(decode_png(f.read()))
    else:
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


def resolve_stats(args) -> Tuple[float, float]:
    """Normalization stats: explicit ``--mean`` / ``--std`` win, else the
    ``--dataset`` registry's."""
    mean, std = args.mean, args.std
    if mean is None or std is None:
        if args.dataset is None:
            raise SystemExit("pass --dataset (registry stats) or --mean/--std")
        dm = get_datamodule(args.dataset)()
        mean = mean if mean is not None else float(dm.mean[0])
        std = std if std is not None else float(dm.std[0])
    return mean, std


def run(argv: Optional[Sequence[str]] = None, fused: bool = True,
        devices: Optional[Sequence] = None) -> Dict[str, object]:
    """Serve every slice; returns the JSON summary it prints. ``fused``
    False serves ``--sliding_window`` through the loop instead of the fused
    predictor (what the fused variant is measured against). ``devices``:
    where a ``--checkpoint`` run computes (default: every local device of
    ``--device``); more than one splits each batch over them."""
    args = parse_args(argv)
    if (args.images_dir is None) == (args.image_store is None):
        raise SystemExit("exactly one of --images_dir / --image_store is required")
    if (args.checkpoint is None) == (args.exported is None):
        raise SystemExit("exactly one of --checkpoint / --exported is required")
    if args.exported is not None and args.sliding_window:
        raise SystemExit("--exported serves the batched function; --sliding_window needs --checkpoint")
    if args.exported is not None:
        # these are baked into the artifact at export time — accepting them
        # here would silently serve with different values than requested
        baked = {"threshold": 0.5, "hu_windows": None, "mean": None, "std": None, "dataset": None}
        bad = [f"--{k}" for k, dv in baked.items() if getattr(args, k) != dv]
        if bad:
            raise SystemExit(f"{', '.join(bad)}: baked into the artifact at export time — "
                             f"re-run mis-export-torch with the desired values instead")
    device = resolve_device(args.device)
    devices = [device] if args.exported is not None else [
        torch.device(d) for d in (local_devices(args.device) if devices is None else devices)]
    multi = len(devices) > 1
    if multi:
        device = devices[0]

    if args.exported is not None:
        predictor = load_predictor(args.exported, device=device)
        args.image_size = predictor.image_size
        args.batch_size = max(predictor.batch_sizes)
        print(f"loaded {args.exported} (step {predictor.meta.get('checkpoint_step')}, "
              f"buckets {predictor.batch_sizes})", file=sys.stderr)

        def predict_batch(buf: np.ndarray, n: int) -> np.ndarray:  # the artifact buckets and pads by itself
            return predictor(buf[:n])
    else:
        mean, std = resolve_stats(args)
        hu_windows = parse_hu_windows(args.hu_windows) if args.hu_windows else ()
        task = SegmentationTask(arch=args.arch, n_classes=1, in_channels=len(hu_windows) or 1,
                                dtype=torch.bfloat16 if args.bf16 else torch.float32, device=device)
        restore_model(task, args.checkpoint)
        window_fn = task.replicas(devices) if multi else make_unet_window_fn(task)
        predict = make_predict_fn(task, mean, std, threshold=args.threshold, hu_windows=hu_windows,
                                  logits=window_fn if multi else None)

        def predict_batch(buf: np.ndarray, n: int) -> np.ndarray:  # a short last batch keeps the full shape
            return predict(torch.from_numpy(buf).to(device)).cpu().numpy()[:n]

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
    extra: Dict[str, object] = {}
    if args.sliding_window:
        fused = fused and not multi  # several devices: the loop, each window batch split over them
        if fused:  # one predictor per slice shape, the most recent shapes kept
            window_predict = FusedCache(lambda shape: make_fused_predictor_2d(
                window_fn, shape, window=args.sliding_window, device=device))
        else:
            def window_predict(x):
                return sliding_window_predict(window_fn, x, window=args.sliding_window, devices=devices)
        for name, img in _sources(args):
            x = normalize_u8(torch.from_numpy(img[..., None]).to(device), mean, std, hu_windows)
            logits = window_predict(x)
            write(name, img, post_process_masks(logits, threshold=args.threshold)[..., 0].cpu().numpy())
            n_done += 1
        if fused:
            extra = {"fused_shapes": window_predict.built, "capture_seconds": window_predict.capture_seconds}
    else:
        size = args.image_size
        buf = np.zeros((args.batch_size, size, size, 1), np.uint8)
        pending = []  # (name, slice) of the rows of buf in use

        def flush() -> int:
            masks = predict_batch(buf, len(pending))[..., 0]
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
        if args.exported is not None:  # deserializing the buckets, inside "seconds" as it is lazy
            extra = {"load_seconds": predictor.load_seconds}

    dt = time.time() - t0
    summary = {"metric": "predict_images_per_sec", "value": round(n_done / dt, 2), "unit": "images/sec",
               "images": n_done, "mode": "sliding_window" if args.sliding_window else "batched",
               "exported": args.exported is not None, "devices": len(devices), "seconds": dt, **extra}
    print(json.dumps(summary))
    return summary


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
