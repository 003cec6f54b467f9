"""Indexed datasets over raw image directories / CSV manifests.

Parity with `medical_image_segmentation/analyze_data/pytorch_datasets.py`:

- ``Radiology1MDataset`` (:87-149): recursive PNG-dir dataset over the
  curated subset; 16-bit PNGs converted ``uint16 → uint8`` via
  ``image / 256`` exactly as the reference does (:120-144). The reference
  then stacks gray→RGB for torchvision; we keep 1 channel (datamodules.py
  docstring documents the deviation).
- ``ChestXRayDataset`` (:19-84): NIH chest-x-ray CSV manifest
  (``Image Index``/``Finding Labels`` columns), single-label encoding from
  the sorted label vocabulary.

Both plug into ``write_store_from_dataset`` to build MIS stores (the role
of `convert_pytorch_loader_to_ffcv_dataset.py`). The port's copies read with
OpenCV where it imports and otherwise through ``utils/imageio.py``, to the
same pixels.
"""

from __future__ import annotations

import csv
import os
from typing import List, Optional, Tuple

import numpy as np

from medical_image_segmentation_tpu_torch.utils.imageio import read_image


class Radiology1MDataset:
    def __init__(self, image_dir: str, limit: Optional[int] = None):
        paths: List[str] = []
        for root, _d, files in os.walk(image_dir):
            for f in sorted(files):
                if f.endswith(".png"):
                    paths.append(os.path.join(root, f))
        if limit:
            paths = paths[:limit]
        if not paths:
            raise FileNotFoundError(f"no PNGs under {image_dir}")
        self.paths = paths

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, i: int) -> np.ndarray:
        img = read_image(self.paths[i])
        if img is None:
            raise IOError(f"unreadable {self.paths[i]}")
        if img.dtype == np.uint16:
            img = (img / 256).astype(np.uint8)  # reference pytorch_datasets.py:120-144
        if img.ndim == 3:
            img = img[..., 0]
        return img[..., None]


class ChestXRayDataset:
    """NIH ChestX-ray14-style CSV dataset: one image file + first finding
    label per row (reference `pytorch_datasets.py:19-84`)."""

    def __init__(self, image_dir: str, csv_path: str, limit: Optional[int] = None):
        self.image_dir = image_dir
        rows: List[Tuple[str, str]] = []
        with open(csv_path) as f:
            for row in csv.DictReader(f):
                name = row.get("Image Index") or row.get("image")
                labels = row.get("Finding Labels") or row.get("label", "")
                if name:
                    rows.append((name, labels.split("|")[0].strip()))
        if limit:
            rows = rows[:limit]
        vocab = sorted({lab for _n, lab in rows})
        self.label_index = {lab: i for i, lab in enumerate(vocab)}
        self.rows = rows

    @property
    def num_classes(self) -> int:
        return len(self.label_index)

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, int]:
        name, label = self.rows[i]
        img = read_image(os.path.join(self.image_dir, name), gray=True)
        if img is None:
            raise IOError(f"unreadable {name}")
        return img[..., None], self.label_index[label]
