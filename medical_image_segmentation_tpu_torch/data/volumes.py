"""Medical Decathlon volumetric datasets and loader (NIfTI, no slicing).

Port of ``data/volumes.py:35-208``, host code in numpy, so the arrays are
the JAX package's element for element:

- ``pair_scans_and_masks`` (the port's ``data/ingest/slice_decathlon.py``,
  one copy for both): imagesTr/labelsTr matched by basename; a split JSON
  filters them by the filename stem, the uid the 2D split files use;
- per-volume min-max normalization to 0..1, mask binarized ``!= 0``
  (with ``labels=True`` kept as the integer label map, rounded);
- NIfTI (X, Y, Z) becomes (D=Z, H=X, W=Y, 1) float32; a 4-D volume takes
  channel 0;
- ``center_fit`` pads or crops around the centre to a fixed
  ``target_shape``; the random crop, flips and jitter happen on the device
  (``ops/augment3d.py``).

``VolumeLoader`` shuffles by ``seed + epoch`` and bumps ``epoch`` at every
``iter()`` or ``iter_index_batches()``, so a resume sets ``epoch`` before
the first of either and reads the same order on both routes.
"""

from __future__ import annotations

import json
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from medical_image_segmentation_tpu_torch.data.ingest.slice_decathlon import (  # noqa: F401 (re-exported)
    nifti_names,
    pair_scans_and_masks,
)
from medical_image_segmentation_tpu_torch.data.nifti import read_nifti


def center_fit(vol: np.ndarray, target: Tuple[int, int, int]) -> np.ndarray:
    """Center-crop-or-pad (D, H, W[, C]) to ``target`` spatial dims."""
    out = vol
    for ax, t in enumerate(target):
        n = out.shape[ax]
        if n > t:
            lo = (n - t) // 2
            out = np.take(out, range(lo, lo + t), axis=ax)
        elif n < t:
            before = (t - n) // 2
            pad = [(0, 0)] * out.ndim
            pad[ax] = (before, t - n - before)
            out = np.pad(out, pad)
    return out


def read_volume(path: str) -> np.ndarray:
    """The float64 (D, H, W) volume of a NIfTI file: channel 0 of a 4-D
    one, the last axis moved first."""
    vol = read_nifti(path).get_fdata()
    if vol.ndim == 4:
        vol = vol[..., 0]
    return np.moveaxis(vol, -1, 0)


def minmax_unit(vol: np.ndarray) -> np.ndarray:
    """``vol`` scaled to 0..1 by its own extremes (all zeros when flat), f32."""
    lo, hi = float(vol.min()), float(vol.max())
    scale = 1.0 / (hi - lo) if hi > lo else 0.0
    return ((vol - lo) * scale).astype(np.float32)


class DecathlonVolumeDataset:
    """Paired (volume, mask) dataset over a Decathlon task directory.
    ``cache`` keeps the fitted pairs in host memory (NIfTI gunzip and parse
    otherwise repeat every epoch); ``raw`` is never cached."""

    def __init__(self, images_dir: str, masks_dir: str, target_shape: Tuple[int, int, int] = (64, 64, 64),
                 split_file: Optional[str] = None, split: str = "train", cache: bool = False, labels: bool = False):
        pairs = pair_scans_and_masks(images_dir, masks_dir)
        if split_file:
            with open(split_file) as f:
                ids = set(json.load(f)[split])
            pairs = [(i, m) for i, m in pairs if os.path.basename(i).split(".nii")[0] in ids]
        if not pairs:
            raise ValueError(f"no volume pairs under {images_dir} / {masks_dir} (split={split})")
        self.pairs: List[Tuple[str, str]] = pairs
        self.target_shape = tuple(target_shape)
        self.labels = labels
        self._cache: Optional[dict] = {} if cache else None

    def __len__(self) -> int:
        return len(self.pairs)

    def raw(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """(volume, mask) at native resolution, normalized and binarized
        (or the label map) but not fitted: for full-resolution
        sliding-window evaluation."""
        img_path, msk_path = self.pairs[i]
        vol = read_volume(img_path)
        seg = np.moveaxis(read_nifti(msk_path).get_fdata(), -1, 0)
        if vol.shape != seg.shape:
            raise ValueError(f"shape mismatch {vol.shape} vs {seg.shape} for {img_path}")
        msk = np.rint(seg) if self.labels else (seg != 0)
        return minmax_unit(vol)[..., None], msk.astype(np.float32)[..., None]

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        if self._cache is not None and i in self._cache:
            return self._cache[i]
        img, msk = self.raw(i)
        item = (center_fit(img, self.target_shape), center_fit(msk, self.target_shape))
        if self._cache is not None:
            self._cache[i] = item
        return item


class UnlabeledVolumeDataset:
    """Images-only volume dataset (volumetric BYOL pretraining): every
    .nii/.nii.gz under ``images_dir``, min-max normalized to 0..1 and
    center-fitted to ``target_shape``. Items are 1-tuples so
    ``VolumeLoader`` yields ``(batch,)``."""

    def __init__(self, images_dir: str, target_shape: Tuple[int, int, int] = (64, 96, 96), cache: bool = False):
        names = nifti_names(images_dir)
        if not names:
            raise ValueError(f"no NIfTI volumes under {images_dir}")
        self.paths = [os.path.join(images_dir, n) for n in names]
        self.target_shape = tuple(target_shape)
        self._cache: Optional[dict] = {} if cache else None

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, i: int):
        if self._cache is not None and i in self._cache:
            return self._cache[i]
        item = (center_fit(minmax_unit(read_volume(self.paths[i])), self.target_shape)[..., None],)
        if self._cache is not None:
            self._cache[i] = item
        return item


class VolumeLoader:
    """Batched loader with epoch shuffling and equalized shards."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 num_hosts: int = 1, host_id: int = 0):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_hosts = num_hosts
        self.host_id = host_id
        self.epoch = 0

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        # equalized shards: padded by wraparound so every shard steps in lockstep
        per = -(-len(idx) // self.num_hosts)
        idx = np.resize(idx, per * self.num_hosts)
        return idx[self.host_id::self.num_hosts]

    def __len__(self) -> int:
        n = len(self._indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, ...]]:
        for chunk in self.iter_index_batches():
            cols = zip(*(self.ds[int(i)] for i in chunk))
            yield tuple(np.stack(c) for c in cols)  # (imgs, masks) or (imgs,)

    def iter_index_batches(self) -> Iterator[np.ndarray]:
        """The int32 index batches of ``__iter__``, with the same shuffle,
        shard, drop-last and epoch bump: the feed of a corpus that lives on
        the device (``--device_cache``), where only the indices cross."""
        idx = self._indices()
        self.epoch += 1
        end = len(idx) - (len(idx) % self.batch_size) if self.drop_last else len(idx)
        for s in range(0, end, self.batch_size):
            yield idx[s:s + self.batch_size].astype(np.int32)
