"""Decathlon sliced-PNG dataset + batch loader.

Parity with the reference `DecathlonDataset`
(`medical_image_segmentation/analyze_data/pytorch_datasets.py:152-295`):

- image/mask PNG dirs produced by the slicer;
- optional split-file filtering by volume id (``name_<sliceidx>.png`` →
  ``name``), :201-220;
- image↔mask bijection check at construction — every image must have its
  mask and vice versa (:222-253);
- masks binarized (>0 → 1.0).

Host work is limited to decode + resize to the training resolution
(bilinear image / NEAREST mask — `lightning_module.py:694-699`), with
OpenCV where it imports and otherwise through ``utils/imageio.py`` and
``utils/resize.py`` to the same pixels; paired
random flips, color jitter and normalization run on-device
(`ops/augment.py::segmentation_augment`).
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np

from medical_image_segmentation_tpu_torch.data.ingest.create_splits import extract_id  # noqa: F401 (re-exported)
from medical_image_segmentation_tpu_torch.utils.imageio import read_image
from medical_image_segmentation_tpu_torch.utils.resize import resize


class DecathlonDataset:
    def __init__(
        self,
        images_dir: str,
        masks_dir: str,
        split_file: Optional[str] = None,
        split: str = "train",
    ):
        self.images_dir = images_dir
        self.masks_dir = masks_dir
        images = {f for f in os.listdir(images_dir) if f.endswith(".png")}
        masks = {f for f in os.listdir(masks_dir) if f.endswith(".png")}
        if images != masks:
            missing_m = sorted(images - masks)[:5]
            missing_i = sorted(masks - images)[:5]
            raise ValueError(
                f"image/mask sets differ: {len(images - masks)} masks missing "
                f"(e.g. {missing_m}), {len(masks - images)} images missing (e.g. {missing_i})"
            )
        names = sorted(images)
        if split_file:
            with open(split_file) as f:
                ids = set(json.load(f)[split])
            names = [n for n in names if extract_id(n) in ids]
        self.names: List[str] = names

    def __len__(self) -> int:
        return len(self.names)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        name = self.names[i]
        img = read_image(os.path.join(self.images_dir, name), gray=True)
        msk = read_image(os.path.join(self.masks_dir, name), gray=True)
        if img is None or msk is None:
            raise IOError(f"unreadable slice pair {name}")
        return img, (msk > 0).astype(np.uint8)


class DecathlonLoader:
    """Iterable of (images uint8 (B,S,S,1), masks float32 (B,S,S,1)) with a
    background prefetch thread."""

    def __init__(
        self,
        dataset: DecathlonDataset,
        batch_size: int,
        image_size: int = 224,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: Optional[bool] = None,
        shard: Tuple[int, int] = (0, 1),
        num_threads: int = 4,
        prefetch: int = 2,
    ):
        self.ds = dataset
        self.batch_size = batch_size
        self.image_size = image_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = shuffle if drop_last is None else drop_last
        self.shard = shard
        self.prefetch = prefetch
        self.epoch = 0

    def close(self) -> None:
        """No persistent resources (PNGs open per read) — exists so callers
        can treat every loader uniformly via contextlib.closing."""

    def _shard_indices(self) -> np.ndarray:
        shard_id, num_shards = self.shard
        if num_shards == 1:
            return np.arange(len(self.ds), dtype=np.int64)
        per = len(self.ds) // num_shards  # equalized contiguous blocks
        return np.arange(shard_id * per, (shard_id + 1) * per, dtype=np.int64)

    def __len__(self) -> int:
        n = len(self._shard_indices())
        drop = self.drop_last or self.shard[1] > 1
        return n // self.batch_size if drop else -(-n // self.batch_size)

    def _load_batch(self, idxs: np.ndarray):
        s = self.image_size
        imgs = np.empty((len(idxs), s, s, 1), np.uint8)
        msks = np.empty((len(idxs), s, s, 1), np.float32)
        for j, i in enumerate(idxs):
            img, msk = self.ds[int(i)]
            imgs[j, :, :, 0] = resize(img, (s, s), "linear")
            msks[j, :, :, 0] = resize(msk, (s, s), "nearest")
        return imgs, msks

    def _index_batches(self):
        mine = self._shard_indices()
        epoch = self.epoch
        self.epoch += 1  # up front: early break must not repeat the epoch
        if self.shuffle:
            rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch]))
            rng.shuffle(mine)
        drop = self.drop_last or self.shard[1] > 1
        end = len(mine) - (len(mine) % self.batch_size) if drop else len(mine)
        for s in range(0, end, self.batch_size):
            yield mine[s : s + self.batch_size]

    def __iter__(self):
        from medical_image_segmentation_tpu_torch.data.loader import prefetch_iter

        def gen():
            for idxs in self._index_batches():
                yield self._load_batch(idxs)

        yield from prefetch_iter(gen, self.prefetch)
