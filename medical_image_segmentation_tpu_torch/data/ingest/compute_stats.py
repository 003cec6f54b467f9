"""Streaming dataset mean/std — bit-comparable with the reference.

Parity with `medical_image_segmentation/analyze_data/compute_dataset_metrics.py:12-29`:
two-moment accumulation in float64, summed over batch/height/width per
channel, finalized as ``std = sqrt(E[x²] − E[x]²)``. These constants are the
normalization parity targets (BASELINE.md): RADIOLOGY_1M train
μ=57.9764 σ=60.4759 (0–255), Decathlon heart .1181/.1720 etc.

The port's copy reads PNG trees with OpenCV where it imports and otherwise
through ``utils/imageio.py`` (the same pixels, OpenCV's BGR order), and
stores through the port's ``StoreReader``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

from medical_image_segmentation_tpu_torch.utils.imageio import read_image


class StreamingMoments:
    """Accumulate per-channel sum and sum-of-squares in float64."""

    def __init__(self, channels: int = 1):
        self.s1 = np.zeros(channels, np.float64)
        self.s2 = np.zeros(channels, np.float64)
        self.n = 0

    def update(self, batch: np.ndarray) -> None:
        """batch: (..., C) array; all leading dims are pooled."""
        b = batch.astype(np.float64).reshape(-1, batch.shape[-1])
        self.s1 += b.sum(axis=0)
        self.s2 += (b * b).sum(axis=0)
        self.n += b.shape[0]

    def finalize(self) -> Tuple[np.ndarray, np.ndarray]:
        mean = self.s1 / self.n
        var = self.s2 / self.n - mean * mean
        return mean, np.sqrt(np.maximum(var, 0.0))


def compute_mean_and_std(
    batches: Iterable[np.ndarray], channels: int = 1
) -> Tuple[np.ndarray, np.ndarray]:
    acc = StreamingMoments(channels)
    for b in batches:
        if b.ndim == 3:  # (B,H,W) → (B,H,W,1)
            b = b[..., None]
        acc.update(b)
    return acc.finalize()


def iter_png_batches(
    image_dir: str, batch_size: int = 64, scale: float = 1.0, limit: Optional[int] = None
) -> Iterable[np.ndarray]:
    """Yield (B,H,W,C) float batches from a directory tree of images,
    multiplied by ``scale`` (e.g. 1/255 for the Decathlon 0–1 stats,
    1.0 for the 0–255 RADIOLOGY_1M stats)."""
    paths = []
    for root, _d, files in os.walk(image_dir):
        for f in sorted(files):
            if f.lower().endswith((".png", ".jpg", ".jpeg")):
                paths.append(os.path.join(root, f))
    if limit:
        paths = paths[:limit]
    buf = []
    for p in paths:
        img = read_image(p)
        if img is None:
            print(f"skip unreadable {p}", file=sys.stderr)
            continue
        if img.ndim == 2:
            img = img[..., None]
        buf.append(img.astype(np.float64) * scale)
        if len(buf) == batch_size:
            # images may differ in size — update per-image, no stacking needed
            for im in buf:
                yield im[None]
            buf = []
    for im in buf:
        yield im[None]


def iter_store_batches(
    store_path: str, batch_size: int = 64, scale: float = 1.0,
    limit: Optional[int] = None, center_crop: Optional[int] = None,
) -> Iterable[np.ndarray]:
    """Batches from a MIS store; ``center_crop`` reproduces the reference's
    FFCV stats variant with a CenterCrop(224) decoder
    (`compute_dataset_metrics.py:39-59`)."""
    from medical_image_segmentation_tpu_torch.data.store.reader import StoreReader

    r = StoreReader(store_path)
    n = min(limit, len(r)) if limit else len(r)
    for i in range(n):
        img = r.image(i).astype(np.float64) * scale
        if center_crop:
            h, w = img.shape[:2]
            s = min(h, w, center_crop)
            y0, x0 = (h - s) // 2, (w - s) // 2
            img = img[y0 : y0 + s, x0 : x0 + s]
        yield img[None]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="Compute per-channel dataset mean/std (float64 streaming)")
    ap.add_argument("--image_dir", default=None)
    ap.add_argument("--store", default=None, help="MIS store path (instead of --image_dir)")
    ap.add_argument("--center_crop", type=int, default=None, help="center-crop size for store stats")
    ap.add_argument("--scale", type=float, default=1.0, help="1.0 for 0-255 stats, 1/255 for 0-1 stats")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--output", default=None, help="optional JSON output path")
    args = ap.parse_args(argv)
    if not args.image_dir and not args.store:
        ap.error("one of --image_dir / --store is required")

    if args.store:
        batches = iter_store_batches(args.store, scale=args.scale, limit=args.limit,
                                     center_crop=args.center_crop)
    else:
        batches = iter_png_batches(args.image_dir, scale=args.scale, limit=args.limit)
    acc = None
    for batch in batches:
        if acc is None:
            acc = StreamingMoments(batch.shape[-1])
        acc.update(batch)
    if acc is None or acc.n == 0:
        print("no images found", file=sys.stderr)
        return 1
    mean, std = acc.finalize()
    result = {"mean": mean.tolist(), "std": std.tolist(), "pixels": acc.n}
    print(json.dumps(result))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(result, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
