"""Medical Decathlon NIfTI → per-slice PNG pairs.

Parity with the reference slicer
(`medical_image_segmentation/analyze_data/slice_medical_decathlon_scans.py`):

- scan/mask pairing by the shared uid in the filename (``<task>_<id>.nii.gz``,
  reference :26-39);
- slices taken along a chosen axis (default the last, :55-83);
- masks binarized ``(slice != 0) * 255`` as uint8 (:68-71);
- images min-max normalized per-volume to uint8 (:72-76);
- written as ``<name>_<sliceidx>.png`` image/mask pairs via cv2 (:77-83);
- parallel over volumes with per-file fault tolerance (:94-146).

The port's copy writes the PNGs with OpenCV where it imports and otherwise
with ``utils/png.py`` (the same pixels). ``nifti_names`` and
``pair_scans_and_masks`` are the port's one copy: ``data/volumes.py``
imports them from here.
"""

from __future__ import annotations

import argparse
import os
import sys
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from medical_image_segmentation_tpu_torch.data.nifti import read_nifti
from medical_image_segmentation_tpu_torch.data.ingest import utils
from medical_image_segmentation_tpu_torch.utils.imageio import write_image


def nifti_names(directory: str) -> List[str]:
    """The sorted ``.nii`` / ``.nii.gz`` file names of ``directory``,
    hidden files left out."""
    return sorted(f for f in os.listdir(directory)
                  if (f.endswith(".nii") or f.endswith(".nii.gz")) and not f.startswith("."))


def pair_scans_and_masks(images_dir: str, labels_dir: str) -> List[Tuple[str, str]]:
    """Match imagesTr/labelsTr files by basename (Decathlon layout)."""
    masks = set(nifti_names(labels_dir))
    return [(os.path.join(images_dir, f), os.path.join(labels_dir, f))
            for f in nifti_names(images_dir) if f in masks]


def save_nii_slices(
    pair: Tuple[str, str],
    images_out: str,
    masks_out: str,
    axis: int = -1,
    min_mask_pixels: int = 0,
) -> dict:
    """Slice one volume pair to PNGs. Returns a per-file status dict."""
    img_path, msk_path = pair
    try:
        vol = read_nifti(img_path).get_fdata()
        seg = read_nifti(msk_path).get_fdata()
        if vol.shape != seg.shape[: vol.ndim] and vol.shape[: seg.ndim] != seg.shape:
            return {"error": f"shape mismatch {vol.shape} vs {seg.shape}"}
        if vol.ndim == 4:  # multi-modal: first channel (reference uses 2D tasks)
            vol = vol[..., 0]
        ax = axis % vol.ndim
        name = os.path.basename(img_path).split(".nii")[0]
        lo, hi = float(vol.min()), float(vol.max())
        scale = 255.0 / (hi - lo) if hi > lo else 0.0
        os.makedirs(images_out, exist_ok=True)
        os.makedirs(masks_out, exist_ok=True)
        written = 0
        for i in range(vol.shape[ax]):
            sl = np.take(vol, i, axis=ax)
            ms = np.take(seg, i, axis=ax)
            mask8 = ((ms != 0) * 255).astype(np.uint8)
            if min_mask_pixels and int((mask8 > 0).sum()) < min_mask_pixels:
                continue
            img8 = ((sl - lo) * scale).astype(np.uint8)
            write_image(os.path.join(images_out, f"{name}_{i}.png"), img8)
            write_image(os.path.join(masks_out, f"{name}_{i}.png"), mask8)
            written += 1
        return {"slices": written}
    except Exception as e:
        return {"error": f"{type(e).__name__}: {e}"}


def slice_dataset(
    images_dir: str,
    labels_dir: str,
    images_out: str,
    masks_out: str,
    num_processes: int = 1,
    axis: int = -1,
) -> Dict[str, dict]:
    pairs = pair_scans_and_masks(images_dir, labels_dir)
    # process_files keys by the pair's image path for reporting
    results = {}
    statuses = utils.process_files(
        [p[0] for p in pairs],
        partial(_slice_by_image_path, labels_dir=labels_dir, images_out=images_out, masks_out=masks_out, axis=axis),
        num_processes,
        progress_label="slice",
    )
    results.update(statuses)
    return results


def _slice_by_image_path(img_path: str, labels_dir: str, images_out: str, masks_out: str, axis: int) -> dict:
    msk_path = os.path.join(labels_dir, os.path.basename(img_path))
    return save_nii_slices((img_path, msk_path), images_out, masks_out, axis=axis)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="Slice Medical Decathlon NIfTI volumes to PNG pairs")
    ap.add_argument("--images_dir", required=True)
    ap.add_argument("--labels_dir", required=True)
    ap.add_argument("--images_out", required=True)
    ap.add_argument("--masks_out", required=True)
    ap.add_argument("--axis", type=int, default=-1)
    ap.add_argument("--num_processes", type=int, default=int(os.environ.get("SLURM_CPUS_ON_NODE", 1)))
    args = ap.parse_args(argv)
    statuses = slice_dataset(
        args.images_dir, args.labels_dir, args.images_out, args.masks_out,
        num_processes=args.num_processes, axis=args.axis,
    )
    ok = sum(1 for s in statuses.values() if "slices" in s)
    total_slices = sum(s.get("slices", 0) for s in statuses.values())
    print(f"sliced {ok}/{len(statuses)} volumes → {total_slices} slice pairs", file=sys.stderr)
    for p, s in statuses.items():
        if "error" in s:
            print(f"  error {p}: {s['error']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
