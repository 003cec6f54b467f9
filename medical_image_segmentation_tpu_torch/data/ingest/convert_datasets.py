"""Convert standard datasets to MIS stores.

Parity with `medical_image_segmentation/analyze_data/
convert_pytorch_loader_to_ffcv_dataset.py` (dataset dispatch :37-46, writes
``{name}_{res}_{train,test}`` files :105-115): cifar10 / cifar100 (from a
torchvision data root, no download), nih_chest_x_ray (CSV manifest),
radiology_1M (curated PNG dir).

The port's copy writes through the port's store writer, which encodes with
OpenCV where it imports and otherwise with ``utils/{png,jpeg}.py`` (gray
JPEG only); ``imagefolder`` reads colour images with OpenCV, or without it
PNGs through ``utils/imageio.py``.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

import numpy as np

from medical_image_segmentation_tpu_torch.data.store import CODEC_JPEG, CODEC_RAW
from medical_image_segmentation_tpu_torch.data.store.writer import write_store_from_dataset
from medical_image_segmentation_tpu_torch.utils.imageio import read_image
from medical_image_segmentation_tpu_torch.utils.resize import cv2_or_none


class _CifarArrays:
    """Adapter over torchvision CIFAR (already-downloaded root)."""

    def __init__(self, root: str, name: str, train: bool):
        import torchvision.datasets as tvd

        cls = {"cifar10": tvd.CIFAR10, "cifar100": tvd.CIFAR100}[name]
        ds = cls(root=root, train=train, download=False)
        self.data = ds.data  # (N, 32, 32, 3) uint8
        self.targets = ds.targets

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        return self.data[i], int(self.targets[i])


def read_rgb(path: str) -> np.ndarray:
    """``cvtColor(imread(path, IMREAD_COLOR), COLOR_BGR2RGB)``; without OpenCV
    an 8-bit PNG (gray repeated, alpha dropped) through ``utils/imageio.py``."""
    cv2 = cv2_or_none()
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise IOError(path)
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    img = read_image(path)
    if img is None:
        raise IOError(path)
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: without OpenCV (cv2) the imagefolder route reads 8-bit images, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[2] < 3:
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., 2::-1])


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="Convert datasets to MIS stores")
    ap.add_argument("--dataset", required=True,
                    choices=["cifar10", "cifar100", "nih_chest_x_ray", "radiology_1M", "imagefolder"])
    ap.add_argument("--data_root", required=True, help="dataset root (torchvision root / image dir)")
    ap.add_argument("--csv_path", default=None, help="NIH manifest CSV")
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--max_resolution", type=int, default=None)
    ap.add_argument("--raw", action="store_true")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--num_workers", type=int,
                    default=int(os.environ.get("SLURM_CPUS_PER_TASK", os.cpu_count() or 1)),
                    help="parallel encode workers (DatasetWriter num_workers parity)")
    args = ap.parse_args(argv)

    os.makedirs(args.output_dir, exist_ok=True)
    codec = CODEC_RAW if args.raw else CODEC_JPEG
    res = args.max_resolution or 0

    if args.dataset in ("cifar10", "cifar100"):
        # CIFAR is tiny — always store raw (reference stores raw at 32px too)
        for split, train in (("train", True), ("test", False)):
            ds = _CifarArrays(args.data_root, args.dataset, train)
            out = os.path.join(args.output_dir, f"{args.dataset}_{res or 32}_{split}.mis")
            n = write_store_from_dataset(out, ds, channels=3, codec=CODEC_RAW,
                                         max_resolution=args.max_resolution,
                                         num_processes=args.num_workers)
            print(f"{split}: {n} → {out}", file=sys.stderr)
    elif args.dataset == "nih_chest_x_ray":
        from medical_image_segmentation_tpu_torch.data.datasets import ChestXRayDataset

        if not args.csv_path:
            ap.error("--csv_path required for nih_chest_x_ray")
        ds = ChestXRayDataset(args.data_root, args.csv_path, limit=args.limit)
        out = os.path.join(args.output_dir, f"nih_chest_x_ray_{res}_test.mis")
        n = write_store_from_dataset(out, ds, channels=1, codec=codec,
                                     max_resolution=args.max_resolution,
                                     num_processes=args.num_workers)
        print(f"{n} → {out} ({ds.num_classes} classes)", file=sys.stderr)
    elif args.dataset == "imagefolder":
        # torchvision-ImageFolder layout: <root>/<class_name>/*.png|jpg —
        # the reference's IMAGENET datamodule source (lightning_module.py:379-449)
        classes = sorted(d for d in os.listdir(args.data_root)
                         if os.path.isdir(os.path.join(args.data_root, d)))
        index = {c: i for i, c in enumerate(classes)}

        class FolderDS:
            def __init__(self):
                self.items = []
                for c in classes:
                    d = os.path.join(args.data_root, c)
                    for f in sorted(os.listdir(d)):
                        if f.lower().endswith((".png", ".jpg", ".jpeg")):
                            self.items.append((os.path.join(d, f), index[c]))
                if args.limit:
                    self.items = self.items[: args.limit]

            def __len__(self):
                return len(self.items)

            def __getitem__(self, i):
                path, label = self.items[i]
                return read_rgb(path), label

        ds = FolderDS()
        out = os.path.join(args.output_dir, f"imagefolder_{res}_train.mis")
        n = write_store_from_dataset(out, ds, channels=3, codec=codec,
                                     max_resolution=args.max_resolution,
                                     num_processes=args.num_workers)
        print(f"{n} → {out} ({len(classes)} classes)", file=sys.stderr)
    else:  # radiology_1M
        from medical_image_segmentation_tpu_torch.data.datasets import Radiology1MDataset

        ds = Radiology1MDataset(args.data_root, limit=args.limit)
        out = os.path.join(args.output_dir, f"radiology_1M_{res}_train.mis")
        n = write_store_from_dataset(out, ds, channels=1, codec=codec,
                                     max_resolution=args.max_resolution,
                                     num_processes=args.num_workers)
        print(f"{n} → {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
