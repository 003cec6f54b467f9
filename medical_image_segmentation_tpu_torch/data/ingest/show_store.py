"""Dump a grid of store samples to a PNG.

Parity with `medical_image_segmentation/analyze_data/show_ffcv_subset.py:13-44`
(load N images sequentially, save a grid image for eyeballing the dataset).
The port's grid goes through ``utils/viz.py`` (OpenCV or ``utils/png.py``);
the default output lies in the temporary directory.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional, Sequence

import numpy as np

from medical_image_segmentation_tpu_torch.data.store.reader import StoreReader
from medical_image_segmentation_tpu_torch.utils.viz import save_image_grid


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="Save a grid of store images")
    ap.add_argument("--store", required=True)
    ap.add_argument("--num_images", type=int, default=64)
    ap.add_argument("--output", default=os.path.join(tempfile.gettempdir(), "image_grid.png"))
    args = ap.parse_args(argv)
    r = StoreReader(args.store)
    n = min(args.num_images, len(r))
    h, w = r.header.height, r.header.width
    batch = np.zeros((n, h, w, r.header.channels), np.uint8)
    for i in range(n):
        img = r.image(i)
        batch[i, : img.shape[0], : img.shape[1]] = img
    save_image_grid(batch, args.output)
    print(f"{n} images → {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
