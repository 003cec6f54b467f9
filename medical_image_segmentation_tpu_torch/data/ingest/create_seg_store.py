"""Sliced PNG pairs → per-split paired MIS stores (images + masks).

The Decathlon PNG-dir loader decodes and resizes every slice with OpenCV on
each epoch; for production-scale segmentation training this converts the
sliced dataset once into aligned raw-uint8 stores per split
(`<prefix>_<split>_images.mis` / `<prefix>_<split>_masks.mis`, identical
sample order) that the C++ loader serves at memory-bandwidth speed.
Masks are stored 0/1 and resized NEAREST; images bilinear — the same
convention as the on-line path (`lightning_module.py:694-699`).

The port's copy reads and resizes with OpenCV where it imports and otherwise
through ``utils/imageio.py`` and ``utils/resize.py``: the same stores, byte
for byte.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

import numpy as np

from medical_image_segmentation_tpu_torch.data.ingest.create_splits import extract_id
from medical_image_segmentation_tpu_torch.data.store import CODEC_RAW, StoreWriter
from medical_image_segmentation_tpu_torch.utils.imageio import read_image
from medical_image_segmentation_tpu_torch.utils.resize import resize


def build_seg_stores(
    images_dir: str,
    masks_dir: str,
    output_prefix: str,
    split_file: Optional[str] = None,
    image_size: int = 224,
) -> dict:
    names = sorted(f for f in os.listdir(images_dir) if f.endswith(".png"))
    if split_file:
        with open(split_file) as f:
            splits = {k: set(v) for k, v in json.load(f).items()}
    else:
        splits = {"train": {extract_id(n) for n in names}}
    counts = {}
    os.makedirs(os.path.dirname(output_prefix) or ".", exist_ok=True)
    for split, ids in splits.items():
        split_names = [n for n in names if extract_id(n) in ids]
        img_w = StoreWriter(f"{output_prefix}_{split}_images.mis", channels=1)
        msk_w = StoreWriter(f"{output_prefix}_{split}_masks.mis", channels=1)
        for n in split_names:
            img = read_image(os.path.join(images_dir, n), gray=True)
            msk = read_image(os.path.join(masks_dir, n), gray=True)
            if img is None or msk is None:
                print(f"skip unreadable {n}", file=sys.stderr)
                continue
            img = resize(img, (image_size, image_size), "linear")
            msk = resize(msk, (image_size, image_size), "nearest")
            img_w.add(img[..., None], codec=CODEC_RAW)
            msk_w.add((msk > 0).astype(np.uint8)[..., None], codec=CODEC_RAW)
        img_w.close()
        msk_w.close()
        counts[split] = len(split_names)
    with open(f"{output_prefix}_manifest.json", "w") as f:
        json.dump({"image_size": image_size, "counts": counts}, f)
    return counts


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="Convert sliced PNG pairs to per-split MIS stores")
    ap.add_argument("--images_dir", required=True)
    ap.add_argument("--masks_dir", required=True)
    ap.add_argument("--output_prefix", required=True)
    ap.add_argument("--split_file", default=None)
    ap.add_argument("--image_size", type=int, default=224)
    args = ap.parse_args(argv)
    counts = build_seg_stores(args.images_dir, args.masks_dir, args.output_prefix,
                              args.split_file, args.image_size)
    print(json.dumps(counts))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
