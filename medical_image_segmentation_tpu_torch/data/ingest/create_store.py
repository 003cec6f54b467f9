"""DICOM → MIS store builder (the FFCV dataset-build equivalent).

Parity with the reference `analyze_data/create_ffcv_subset.py`:

- consumes the ``original_to_new_map.json`` written by ``write_subset``
  (:15-33) or a directory of DICOMs;
- per image (reference `DICOMImageDataset.__getitem__`, :36-65):
  decode → min-max normalize to float32 [0,1] → **PIL BICUBIC** resize to
  ``--max_resolution`` → re-min-max-normalize → scale to uint8. The
  double-normalization around the exact PIL BICUBIC resample is the
  bit-parity-sensitive sequence called out in SURVEY §7 "hard parts";
- ``--test`` mode builds a 100-image store (:85,94-95);
- output is one self-contained `.mis` file (instead of `.beton`).

Also provides ``pngdir_to_store`` for converting a curated PNG subset
directly (the `convert_pytorch_loader_to_ffcv_dataset.py` role).

The port's copy resizes with PIL and OpenCV where they import and otherwise
with ``utils/resize.py`` (``pil_bicubic``, ``INTER_AREA``), reads PNGs
through ``utils/imageio.py`` and encodes through the port's store writer:
the same store, byte for byte. Its worker pool starts with ``spawn``
(``data/ingest/utils.py`` says why)."""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional, Sequence

import numpy as np

from medical_image_segmentation_tpu_torch.data import dicom
from medical_image_segmentation_tpu_torch.data.store import CODEC_JLS, CODEC_JPEG, CODEC_RAW, StoreWriter
from medical_image_segmentation_tpu_torch.utils.imageio import read_image
from medical_image_segmentation_tpu_torch.utils.resize import pil_bicubic, resize


def dicom_to_uint(path: str, max_resolution: Optional[int], bit_depth: int = 8) -> np.ndarray:
    """The reference's exact decode→normalize→BICUBIC→renormalize sequence
    (`create_ffcv_subset.py:41-62`), quantized to ``bit_depth`` (8 → uint8
    parity with the reference's FFCV build; 16 → uint16, preserving the
    dynamic range the reference throws away — pairs with FLAG_U16 stores
    and the write_subset 16-bit PNG semantics, `create_subset.py:205-211`).
    Returns (H, W, 1)."""
    arr = dicom.read_dicom(path).pixel_array
    if arr.ndim != 2:
        raise ValueError(f"not 2D: {arr.shape}")
    arr = arr.astype(np.float32)
    lo, hi = float(arr.min()), float(arr.max())
    if hi <= lo:
        raise ValueError("constant image")
    arr = (arr - lo) / (hi - lo)
    if max_resolution is not None:
        h, w = arr.shape
        m = max(h, w)
        if m > max_resolution:
            scale = max_resolution / m
            size = (int(round(w * scale)), int(round(h * scale)))
            arr = pil_bicubic(arr, size)
    lo, hi = float(arr.min()), float(arr.max())
    if hi > lo:
        arr = (arr - lo) / (hi - lo)
    if bit_depth == 16:
        return (arr * 65535.0).astype(np.uint16)[..., None]
    return (arr * 255.0).astype(np.uint8)[..., None]


def dicom_to_uint8(path: str, max_resolution: Optional[int]) -> np.ndarray:
    return dicom_to_uint(path, max_resolution, 8)


def _encode_dicom_worker(path: str, max_resolution: Optional[int], codec: int,
                         quality: int, bit_depth: int = 8):
    """Pool worker: decode + resize + compress one DICOM; per-file errors
    become statuses, not crashes (reference fault tolerance,
    `create_subset.py:197-241`). Returns (payload, h, w, error)."""
    from medical_image_segmentation_tpu_torch.data.store.writer import _encode

    try:
        img = dicom_to_uint(path, max_resolution, bit_depth)
        payload = _encode(img[..., 0], codec, quality)
        return payload, img.shape[0], img.shape[1], None
    except Exception as e:
        return None, 0, 0, f"{type(e).__name__}: {e}"


def build_store(
    paths: Sequence[str],
    output: str,
    max_resolution: int = 224,
    codec: int = CODEC_JPEG,
    quality: int = 90,
    num_workers: int = 1,
    bit_depth: int = 8,
) -> int:
    """``num_workers > 1`` runs decode→resize→compress in a worker pool; the
    parent assembles records in path order, so the output is byte-identical
    to the serial build (the `DatasetWriter(num_workers)` role,
    reference `create_ffcv_subset.py:100-104`)."""
    n_ok = 0
    with StoreWriter(output, channels=1, with_labels=False,
                     dtype=np.uint16 if bit_depth == 16 else np.uint8) as w:
        if num_workers > 1:
            import concurrent.futures as cf
            import multiprocessing
            from functools import partial

            fn = partial(_encode_dicom_worker, max_resolution=max_resolution,
                         codec=codec, quality=quality, bit_depth=bit_depth)
            with cf.ProcessPoolExecutor(max_workers=num_workers,
                                        mp_context=multiprocessing.get_context("spawn")) as pool:
                for p, (payload, h, wd, err) in zip(
                    paths, pool.map(fn, paths, chunksize=16)
                ):
                    if err is not None:
                        print(f"skip {p}: {err}", file=sys.stderr)
                        continue
                    w.add_encoded(payload, h, wd, codec=codec)
                    n_ok += 1
                    if n_ok % 1000 == 0:
                        print(f"\r{n_ok}/{len(paths)}", end="", file=sys.stderr)
        else:
            for p in paths:
                payload, h, wd, err = _encode_dicom_worker(p, max_resolution, codec,
                                                           quality, bit_depth)
                if err is not None:
                    print(f"skip {p}: {err}", file=sys.stderr)
                    continue
                w.add_encoded(payload, h, wd, codec=codec)
                n_ok += 1
                if n_ok % 1000 == 0:
                    print(f"\r{n_ok}/{len(paths)}", end="", file=sys.stderr)
    print(f"\nwrote {n_ok} images → {output}", file=sys.stderr)
    return n_ok


def pngdir_to_store(
    image_dir: str,
    output: str,
    max_resolution: Optional[int] = None,
    codec: int = CODEC_JPEG,
    quality: int = 90,
    limit: Optional[int] = None,
    bit_depth: int = 8,
) -> int:
    """Convert a curated PNG subset (16-bit grayscale) to a store. At
    ``bit_depth=8`` applies the reference's uint16→uint8 `(image/256)`
    conversion (`pytorch_datasets.py:120-144`); at 16 the curated PNGs'
    full 16-bit range (write_subset stores min-maxed uint16,
    `create_subset.py:205-211`) is preserved into a FLAG_U16 store."""
    paths: List[str] = []
    for root, _d, files in os.walk(image_dir):
        for f in sorted(files):
            if f.endswith(".png"):
                paths.append(os.path.join(root, f))
    if limit:
        paths = paths[:limit]
    n_ok = 0
    with StoreWriter(output, channels=1, with_labels=False,
                     dtype=np.uint16 if bit_depth == 16 else np.uint8) as w:
        for p in paths:
            img = read_image(p)
            if img is None:
                print(f"skip unreadable {p}", file=sys.stderr)
                continue
            if img.ndim == 3:
                img = img[..., 0]
            if bit_depth == 16:
                if img.dtype == np.uint8:
                    img = img.astype(np.uint16) * 257  # 0-255 → 0-65535 exactly
            elif img.dtype == np.uint16:
                img = (img / 256).astype(np.uint8)
            if max_resolution is not None and max(img.shape) > max_resolution:
                scale = max_resolution / max(img.shape)
                img = resize(img, (int(round(img.shape[1] * scale)), int(round(img.shape[0] * scale))), "area")
            w.add(img[..., None], codec=codec, quality=quality)
            n_ok += 1
    print(f"wrote {n_ok} images → {output}", file=sys.stderr)
    return n_ok


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="Build a MIS store from DICOMs or a PNG subset")
    ap.add_argument("--subset_map", default=None, help="original_to_new_map.json from write_subset")
    ap.add_argument("--dicom_dir", default=None, help="directory tree of .dcm files")
    ap.add_argument("--png_dir", default=None, help="curated 16-bit PNG subset directory")
    ap.add_argument("--output", required=True)
    ap.add_argument("--max_resolution", type=int, default=224)
    ap.add_argument("--raw", action="store_true", help="store raw samples instead of compressed")
    ap.add_argument("--jpeg_quality", type=int, default=90)
    ap.add_argument("--bit_depth", type=int, default=8, choices=(8, 16),
                    help="8 = reference-parity uint8 store (JPEG); 16 = HU-native "
                         "uint16 FLAG_U16 store (JPEG-LS lossless) preserving the "
                         "dynamic range the reference squashes away")
    ap.add_argument("--test", action="store_true", help="100-image smoke mode")
    ap.add_argument("--num_workers", type=int,
                    default=int(os.environ.get("SLURM_CPUS_PER_TASK", os.cpu_count() or 1)),
                    help="parallel decode/encode workers")
    args = ap.parse_args(argv)

    if args.bit_depth == 16:
        codec = CODEC_RAW if args.raw else CODEC_JLS  # JPEG is 8-bit-only
    else:
        codec = CODEC_RAW if args.raw else CODEC_JPEG
    if args.png_dir:
        pngdir_to_store(args.png_dir, args.output, args.max_resolution, codec,
                        args.jpeg_quality, limit=100 if args.test else None,
                        bit_depth=args.bit_depth)
        return 0
    if args.subset_map:
        with open(args.subset_map) as f:
            paths = sorted(json.load(f).keys())
    elif args.dicom_dir:
        from medical_image_segmentation_tpu_torch.data.ingest.utils import get_file_paths

        paths = get_file_paths([args.dicom_dir], [".dcm"])
    else:
        ap.error("one of --subset_map / --dicom_dir / --png_dir is required")
    if args.test:
        paths = paths[:100]
    build_store(paths, args.output, args.max_resolution, codec, args.jpeg_quality,
                num_workers=args.num_workers, bit_depth=args.bit_depth)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
