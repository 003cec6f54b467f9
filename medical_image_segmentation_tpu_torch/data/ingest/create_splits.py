"""Train/val/test split generator with label-efficiency subsets.

Parity with the reference
(`medical_image_segmentation/analyze_data/create_data_splits.py`):

- ``create_split``: shuffled 70/20/10 split of scan ids (:7-23);
- ``create_split_by_percent``: nested 10/25/50/100% subsets of the train
  ids for label-efficiency experiments (:26-39);
- ids extracted from slice filenames ``<name>_<sliceidx>.png`` — the split
  is by *volume*, never by slice, so no patient leaks across splits (:42-49);
- writes ``split_{N}_percent_train.json`` plus ``split_all_in_train.json``
  (:60-75), each ``{"train": [...], "val": [...], "test": [...]}``.
"""

from __future__ import annotations

import argparse
import json
import os
import random
from typing import Dict, List, Optional, Sequence


def extract_id(filename: str) -> str:
    """``la_003_42.png`` → ``la_003`` (strip the slice index).

    NIfTI volumes are their own id: ``la_003.nii.gz`` → ``la_003`` — the
    volumetric path (`data/volumes.py`) filters by the same uid, so one
    split JSON drives both the sliced-2D and whole-volume-3D loaders.
    """
    stem = os.path.basename(filename)
    if stem.endswith(".nii") or stem.endswith(".nii.gz"):
        return stem.split(".nii")[0]
    stem = stem.split(".png")[0]
    return stem.rsplit("_", 1)[0]


def collect_ids(images_dir: str) -> List[str]:
    ids = {
        extract_id(f)
        for f in os.listdir(images_dir)
        if f.endswith((".png", ".nii", ".nii.gz")) and not f.startswith(".")
    }
    return sorted(ids)


def create_split(ids: Sequence[str], seed: int = 0,
                 fractions=(0.7, 0.2, 0.1)) -> Dict[str, List[str]]:
    ids = list(ids)
    random.Random(seed).shuffle(ids)
    n = len(ids)
    n_train = int(n * fractions[0])
    n_val = int(n * fractions[1])
    return {
        "train": sorted(ids[:n_train]),
        "val": sorted(ids[n_train : n_train + n_val]),
        "test": sorted(ids[n_train + n_val :]),
    }


def create_split_by_percent(split: Dict[str, List[str]], percent: int, seed: int = 0) -> Dict[str, List[str]]:
    """Keep ``percent``% of train ids (nested: 10% ⊂ 25% ⊂ 50% ⊂ 100%)."""
    train = list(split["train"])
    random.Random(seed).shuffle(train)  # same seed ⇒ nested prefixes
    k = max(1, int(len(train) * percent / 100))
    return {"train": sorted(train[:k]), "val": split["val"], "test": split["test"]}


def write_splits(images_dir: str, output_dir: str, seed: int = 0,
                 percents: Sequence[int] = (10, 25, 50, 100)) -> List[str]:
    ids = collect_ids(images_dir)
    base = create_split(ids, seed=seed)
    os.makedirs(output_dir, exist_ok=True)
    written = []
    for pct in percents:
        sp = create_split_by_percent(base, pct, seed=seed)
        path = os.path.join(output_dir, f"split_{pct}_percent_train.json")
        with open(path, "w") as f:
            json.dump(sp, f, indent=1)
        written.append(path)
    all_in = {"train": sorted(ids), "val": base["val"], "test": base["test"]}
    path = os.path.join(output_dir, "split_all_in_train.json")
    with open(path, "w") as f:
        json.dump(all_in, f, indent=1)
    written.append(path)
    return written


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="Create train/val/test splits by volume id")
    ap.add_argument("--images_dir", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    for p in write_splits(args.images_dir, args.output_dir, seed=args.seed):
        print(p)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
