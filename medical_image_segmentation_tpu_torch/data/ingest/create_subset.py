"""DICOM subset builder CLI — dimension/hash scans + curated PNG subset.

Capability parity with the reference CLI
(`medical_image_segmentation/analyze_data/create_subset.py`, subcommands at
:540-613):

- ``dicom_sizes``  : header-only (rows, cols) scan of *.dcm trees
  (fast path via ``stop_before_pixels`` — reference :392-463);
- ``dicom_hashes`` : sha256 of the decoded pixel array per file, exceptions
  swallowed to a skip (reference :466-537);
- ``raster_sizes`` : dimensions of already-written raster images (:320-389);
- ``write_subset`` : curate exactly ``--size`` images (reference :16-171):
  dimension filter 256–768 px on both sides, hash-dedup (first path per
  hash wins, :244-289), dataset-aware ordering that pushes the two
  over-represented datasets (dukebreastcancer, ctcolongraphy) to the back
  (:128-145), then a retry loop that tops up with fresh candidates until
  exactly ``size`` successes or ``max_retries`` rounds (:147-170).

Per-image writer (reference :174-241): decode → reject non-2D → min-max
normalize to uint16 → 16-bit PNG named ``<sha256>.png`` in a hash-bucketed
subfolder; numeric-overflow warnings escalate to per-file errors; existing
outputs are never overwritten; ``--write_to_null`` benchmarks the pipeline
without touching disk (:232-234).

Failures are per-file ``{"error": ...}`` statuses, never crashes — the
reference's fault-tolerance contract (SURVEY §5.3).

The port's copy writes the PNGs with OpenCV and reads raster sizes with PIL
where they import; elsewhere ``utils/png.py`` writes the same 16-bit pixels
and ``png_size`` / ``jpeg_size`` read the sizes from the file headers.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import random
import sys
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np

from medical_image_segmentation_tpu_torch.data import dicom
from medical_image_segmentation_tpu_torch.data.ingest import utils
from medical_image_segmentation_tpu_torch.utils.imageio import write_image
from medical_image_segmentation_tpu_torch.utils.jpeg import jpeg_size
from medical_image_segmentation_tpu_torch.utils.png import encode_png, png_size
from medical_image_segmentation_tpu_torch.utils.resize import cv2_or_none

# datasets the reference down-weights in candidate ordering
# (create_subset.py:128-145)
DEPRIORITIZED_DATASETS = ("dukebreastcancer", "ctcolongraphy")


def dataset_name_from_path(path: str) -> str:
    """Extract ``<dataset>`` from ``.../med_datasets/<dataset>/...``
    (reference `create_subset.py:292-295`); falls back to the first
    directory component under the scan root."""
    parts = os.path.normpath(path).split(os.sep)
    if "med_datasets" in parts:
        i = parts.index("med_datasets")
        if i + 1 < len(parts):
            return parts[i + 1]
    return parts[-2] if len(parts) >= 2 else ""


# ---------------------------------------------------------------------------
# scans
# ---------------------------------------------------------------------------

def _dims_one(path: str) -> dict:
    try:
        rows, cols = dicom.get_dimensions(path)
        return {"dimensions": [rows, cols]}
    except Exception as e:  # per-file fault tolerance
        return {"error": f"{type(e).__name__}: {e}"}


def get_dicom_image_dimensions(paths: Sequence[str], num_processes: int = 1) -> Dict[str, List[int]]:
    results = utils.process_files(paths, _dims_one, num_processes, progress_label="dicom_sizes")
    return {p: r["dimensions"] for p, r in results.items() if "dimensions" in r}


def _hash_one(path: str) -> dict:
    try:
        arr = dicom.read_dicom(path).pixel_array
        return {"hash": hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()}
    except Exception as e:
        return {"error": f"{type(e).__name__}: {e}"}


def get_dicom_image_hashes(paths: Sequence[str], num_processes: int = 1) -> Dict[str, str]:
    results = utils.process_files(paths, _hash_one, num_processes, progress_label="dicom_hashes")
    return {p: r["hash"] for p, r in results.items() if "hash" in r}


def _raster_size(path: str) -> List[int]:
    """[height, width] by PIL where it imports, else from the PNG or JPEG
    headers."""
    try:
        from PIL import Image
    except ImportError:
        with open(path, "rb") as f:
            head = f.read(2)
            f.seek(0)
            if head == b"\xFF\xD8":
                return list(jpeg_size(f))
        return list(png_size(path))
    with Image.open(path) as im:
        w, h = im.size
    return [h, w]


def _raster_one(path: str) -> dict:
    try:
        return {"dimensions": _raster_size(path)}
    except Exception as e:
        return {"error": f"{type(e).__name__}: {e}"}


def get_raster_image_dimensions(paths: Sequence[str], num_processes: int = 1) -> Dict[str, List[int]]:
    results = utils.process_files(paths, _raster_one, num_processes, progress_label="raster_sizes")
    return {p: r["dimensions"] for p, r in results.items() if "dimensions" in r}


# ---------------------------------------------------------------------------
# subset selection
# ---------------------------------------------------------------------------

def pick_possible_images(
    dimensions: Dict[str, Sequence[int]],
    hashes: Dict[str, str],
    min_dim: int = 256,
    max_dim: int = 768,
) -> List[str]:
    """Filter to 2-D images with both sides in [min_dim, max_dim] and
    deduplicate by pixel hash, first path wins (reference :244-289)."""
    seen = set()
    out = []
    for path, dims in dimensions.items():
        if len(dims) != 2:
            continue
        r, c = dims
        if not (min_dim <= r <= max_dim and min_dim <= c <= max_dim):
            continue
        h = hashes.get(path)
        if h is None or h in seen:
            continue
        seen.add(h)
        out.append(path)
    return out


def order_candidates(paths: List[str], seed: int = 0) -> List[str]:
    """Shuffle, then move images from the de-prioritized (over-represented)
    datasets to the back, preserving the shuffle inside each part
    (reference :128-145)."""
    rng = random.Random(seed)
    shuffled = paths[:]
    rng.shuffle(shuffled)
    front = [p for p in shuffled if dataset_name_from_path(p) not in DEPRIORITIZED_DATASETS]
    back = [p for p in shuffled if dataset_name_from_path(p) in DEPRIORITIZED_DATASETS]
    return front + back


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

def write_one_image(path: str, output_dir: str, num_subfolders: int, write_to_null: bool) -> dict:
    """Decode one DICOM and write the normalized 16-bit PNG
    (reference `_write_subset_helper`, :174-241)."""
    try:
        d = dicom.read_dicom(path)
        arr = d.pixel_array
        if arr.ndim != 2:
            return {"error": f"not a 2D image (shape {arr.shape})"}
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # overflow warnings → errors (:218-228)
            arr_f = arr.astype(np.float64)
            lo, hi = float(arr_f.min()), float(arr_f.max())
            if hi <= lo:
                return {"error": "constant image (max == min)"}
            norm = (arr_f - lo) / (hi - lo)
            out16 = (norm * 65535.0).astype(np.uint16)
        digest = hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()
        if write_to_null:
            cv2 = cv2_or_none()
            if cv2 is None:
                buf = encode_png(out16)
            else:
                ok, buf = cv2.imencode(".png", out16)
                if not ok:
                    return {"error": "png encode failed"}
                buf = buf.tobytes()
            with open(os.devnull, "wb") as f:
                f.write(buf)
            return {"output_path": os.devnull, "hash": digest}
        bucket = str(int(digest, 16) % num_subfolders)
        out_dir = os.path.join(output_dir, bucket)
        os.makedirs(out_dir, exist_ok=True)
        out_path = os.path.join(out_dir, f"{digest}.png")
        if os.path.exists(out_path):
            return {"error": f"output exists: {out_path}"}  # no overwrite (:236-237)
        if not write_image(out_path, out16):
            return {"error": f"cv2.imwrite failed: {out_path}"}
        return {"output_path": out_path, "hash": digest}
    except Exception as e:
        return {"error": f"{type(e).__name__}: {e}"}


def write_subset(
    dimensions: Dict[str, Sequence[int]],
    hashes: Dict[str, str],
    output_dir: str,
    size: int,
    num_subfolders: int = 100,
    num_processes: int = 1,
    seed: int = 0,
    max_retries: int = 10,
    write_to_null: bool = False,
    min_dim: int = 256,
    max_dim: int = 768,
) -> Dict[str, str]:
    """Write exactly ``size`` curated PNGs (or all candidates, if fewer).

    Returns the ``original → new`` path map (reference writes
    ``original_to_new_map.json`` consumed by the FFCV builder,
    `create_ffcv_subset.py:15-33`)."""
    candidates = order_candidates(
        pick_possible_images(dimensions, hashes, min_dim, max_dim), seed=seed
    )
    mapping: Dict[str, str] = {}
    cursor = 0
    for _ in range(max_retries):
        need = size - len(mapping)
        if need <= 0 or cursor >= len(candidates):
            break
        batch = candidates[cursor : cursor + need]
        cursor += len(batch)
        from functools import partial

        # partial of a module-level fn (not a lambda) so it pickles to workers
        one = partial(
            write_one_image,
            output_dir=output_dir,
            num_subfolders=num_subfolders,
            write_to_null=write_to_null,
        )
        results = utils.process_files(batch, one, num_processes, progress_label="write_subset")
        for p, r in results.items():
            if "output_path" in r:
                mapping[p] = r["output_path"]
            else:
                print(f"skip {p}: {r.get('error')}", file=sys.stderr)
    return mapping


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _default_procs() -> int:
    return int(os.environ.get("SLURM_CPUS_ON_NODE", os.cpu_count() or 1))


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="command", required=True)

    def add_common(p):
        p.add_argument("--num_processes", type=int, default=_default_procs())
        p.add_argument("--output", required=True, help="output JSON path")

    p = sub.add_parser("dicom_sizes")
    p.add_argument("directories", nargs="+")
    add_common(p)

    p = sub.add_parser("dicom_hashes")
    p.add_argument("directories", nargs="+")
    add_common(p)

    p = sub.add_parser("raster_sizes")
    p.add_argument("directories", nargs="+")
    add_common(p)

    p = sub.add_parser("write_subset")
    p.add_argument("--dimensions_map", required=True)
    p.add_argument("--hashes_map", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--size", type=int, required=True)
    p.add_argument("--num_subfolders", type=int, default=100)
    p.add_argument("--num_processes", type=int, default=_default_procs())
    p.add_argument("--seed", type=int, default=2)
    p.add_argument("--max_retries", type=int, default=10)
    p.add_argument("--write_to_null", action="store_true")
    p.add_argument("--mapping_output", default="original_to_new_map.json")

    args = ap.parse_args(argv)

    if args.command in ("dicom_sizes", "dicom_hashes", "raster_sizes"):
        exts = [".dcm"] if args.command.startswith("dicom") else [".png", ".jpg", ".jpeg"]
        paths = utils.get_file_paths(args.directories, exts)
        fn = {
            "dicom_sizes": get_dicom_image_dimensions,
            "dicom_hashes": get_dicom_image_hashes,
            "raster_sizes": get_raster_image_dimensions,
        }[args.command]
        result = fn(paths, args.num_processes)
        with open(args.output, "w") as f:
            json.dump(result, f)
        print(f"{args.command}: {len(result)}/{len(paths)} ok → {args.output}", file=sys.stderr)
        return 0

    with open(args.dimensions_map) as f:
        dims = json.load(f)
    with open(args.hashes_map) as f:
        hashes = json.load(f)
    mapping = write_subset(
        dims, hashes, args.output_dir, args.size,
        num_subfolders=args.num_subfolders, num_processes=args.num_processes,
        seed=args.seed, max_retries=args.max_retries, write_to_null=args.write_to_null,
    )
    with open(args.mapping_output, "w") as f:
        json.dump(mapping, f)
    print(f"write_subset: {len(mapping)} images → {args.output_dir}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
