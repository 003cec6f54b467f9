"""High-throughput batch loader over MIS stores — the `ffcv.loader.Loader`
replacement (reference usage: `train/data_loaders/lightning_module.py:124-177`).

Pipeline per batch:
  sampler (sequential / random / quasi-random, per-host shard)
    → C++ decode workers (mmap + the port's own JPEG/PNG/JPEG-LS decoders,
      csrc/ → fixed uint8 buffer)
    → background prefetch thread (decodes batch t+1 while t trains)
    → ``data/device_feed.py`` (pinned, one batch ahead) onto the card.

Augmentation is NOT here: raw uint8 batches go to the device and the
fused augmentation kernel (ops/fused_augment.py) crops/flips/normalizes on
the card, so the host's per-image work is exactly one decode + one copy.

A copy of the JAX package's ``data/loader.py`` without its JAX half
(``device_put_sharded_batches``).

Ordering modes mirror FFCV's (`lightning_module.py:141-151`):
- SEQUENTIAL: validation order;
- RANDOM: full shuffle per epoch;
- QUASI_RANDOM: shuffle pages, then shuffle within a sliding window —
  approximates RANDOM while keeping mmap reads page-local (the mode the
  reference uses for distributed training).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

SEQUENTIAL = "sequential"
RANDOM = "random"
QUASI_RANDOM = "quasi_random"


def prefetch_iter(make_items, prefetch: int, registry: Optional[set] = None):
    """Run ``make_items()`` (a generator) on a background thread with a
    bounded queue. Exceptions propagate to the consumer; abandoning the
    iterator early unblocks, stops, AND JOINS the producer — an in-flight
    fetch may hold views into a store that the owner closes (munmap) right
    after dropping the iterator, so the producer must be fully finished
    before control returns. ``registry`` (a set owned by the Loader) gets a
    ``(stop_event, thread)`` handle for the producer's lifetime so
    ``Loader.close()`` can stop+join producers whose abandoned generators
    have not been finalized yet (non-refcounting interpreters)."""
    if prefetch <= 0:
        yield from make_items()
        return
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def producer():
        try:
            for item in make_items():
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.25)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # surface worker errors to the consumer
            while not stop.is_set():
                try:
                    q.put(e, timeout=0.25)
                    break
                except queue.Full:
                    continue
        finally:
            # the end sentinel MUST reach the consumer (a dropped sentinel
            # deadlocks q.get()); block with timeout until delivered or the
            # consumer has already gone away
            while not stop.is_set():
                try:
                    q.put(None, timeout=0.25)
                    break
                except queue.Full:
                    continue

    t = threading.Thread(target=producer, daemon=True)
    handle = (stop, t)
    if registry is not None:
        registry.add(handle)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        # drain so a producer blocked in put() can observe stop and exit
        while not q.empty():
            try:
                q.get_nowait()
            except queue.Empty:
                break
        # wait for an in-flight fetch to finish before the caller can munmap
        # the store under it (put() polls stop every 0.25 s, so this is
        # bounded by one fetch)
        try:
            t.join()
        except (RuntimeError, TypeError):
            pass  # generator finalized during interpreter shutdown:
            # threading internals are already torn down and the process is
            # exiting anyway — nothing left to protect
        if registry is not None:
            registry.discard(handle)


def make_order(
    n: int,
    mode: str,
    seed: int,
    epoch: int,
    page_size: int = 128,
    window_pages: int = 8,
) -> np.ndarray:
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    if mode == SEQUENTIAL:
        return np.arange(n, dtype=np.int64)
    if mode == RANDOM:
        return rng.permutation(n).astype(np.int64)
    if mode == QUASI_RANDOM:
        # shuffle page order, then shuffle inside windows of consecutive pages
        n_pages = -(-n // page_size)
        pages = rng.permutation(n_pages)
        order = np.concatenate(
            [np.arange(p * page_size, min((p + 1) * page_size, n)) for p in pages]
        )
        w = page_size * window_pages
        for s in range(0, len(order), w):
            rng.shuffle(order[s : s + w])
        return order.astype(np.int64)
    raise ValueError(f"unknown order mode {mode!r}")


class Loader:
    """Iterable over (images uint8 (B,H,W,C), labels int32 (B,)) host batches.

    ``shard=(shard_id, num_shards)`` partitions samples across hosts (the
    per-host split that replaces FFCV's rank-aware ordering)."""

    def __init__(
        self,
        store_path: str,
        batch_size: int,
        order: str = SEQUENTIAL,
        num_threads: int = 4,
        seed: int = 0,
        drop_last: bool = True,
        shard: Tuple[int, int] = (0, 1),
        out_hw: Optional[Tuple[int, int]] = None,
        prefetch: int = 2,
        use_native: bool = True,
        precrop: Optional[dict] = None,
    ):
        """``precrop``: host-side RandomResizedCrop mode (see
        data/host_precrop.py) — dict with keys ``out_hw`` (required view
        size), ``n_views`` (default 2), ``scale``/``ratio`` (RRC params,
        torchvision defaults), ``hflip_prob`` (default 0.5). Batches become
        ((B*n_views, vh, vw, C) uint8 views — sample-major, rows
        [i*V:(i+1)*V] are sample i's views — , (B,) labels) and H2D shrinks
        to the view bytes. The device-side elementwise tail is
        ops.augment.two_view_tail_augment."""
        self.store_path = store_path
        self.batch_size = batch_size
        self.order_mode = order
        self.num_threads = num_threads
        self.seed = seed
        self.drop_last = drop_last
        self.shard = shard
        self.prefetch = prefetch
        self.epoch = 0
        # per-stage wall timers (SURVEY §5.1 — the reference has none);
        # "decode" accumulates on the prefetch thread
        from medical_image_segmentation_tpu_torch.core.profiling import StageTimers

        self.timers = StageTimers()
        self._producers: set = set()  # live prefetch (stop, thread) handles

        self._native = None
        self._reader = None
        if use_native:
            try:
                from medical_image_segmentation_tpu_torch.data.store.native import NativeStore

                self._native = NativeStore(store_path)
            except Exception:
                self._native = None
        if self._native is None:
            from medical_image_segmentation_tpu_torch.data.store.reader import StoreReader

            self._reader = StoreReader(store_path)
        shape = self._native.shape if self._native else (
            self._reader.header.height, self._reader.header.width, self._reader.header.channels
        )
        # sample dtype from the store header (uint8, or uint16 for FLAG_U16
        # stores — the HU-native path); batches come out in this dtype
        self.dtype = (self._native.dtype if self._native
                      else np.dtype(self._reader.header.sample_dtype))
        self.out_hw = out_hw or shape[:2]
        self.channels = shape[2]
        self._n_total = self._native.num_samples if self._native else len(self._reader)
        self.precrop = dict(precrop) if precrop else None
        if self.precrop is not None:
            self.precrop.setdefault("n_views", 2)
            self.precrop.setdefault("scale", (0.08, 1.0))
            self.precrop.setdefault("ratio", (0.75, 4.0 / 3.0))
            self.precrop.setdefault("hflip_prob", 0.5)
            if "out_hw" not in self.precrop:
                raise ValueError("precrop requires 'out_hw' (the view size)")
            self._store_hw = shape[:2]

    @property
    def num_samples(self) -> int:
        """Samples in this host's shard (equalized: every shard gets
        floor(N/num_shards) so all hosts run identical batch counts and the
        collectives inside jitted steps stay in lockstep)."""
        _, num_shards = self.shard
        return self._n_total // num_shards if num_shards > 1 else self._n_total

    def __len__(self) -> int:
        n = self.num_samples
        drop = self.drop_last or self.shard[1] > 1
        return n // self.batch_size if drop else -(-n // self.batch_size)

    def _shard_indices(self) -> np.ndarray:
        # contiguous block sharding (not strided): QUASI_RANDOM's page
        # locality only holds if a shard's records are adjacent in the file
        shard_id, num_shards = self.shard
        per = self.num_samples
        start = shard_id * per
        return np.arange(start, start + per, dtype=np.int64)

    def _fetch(self, idxs: np.ndarray):
        if self._native is not None:
            return self._native.fetch(idxs, out_hw=self.out_hw, num_threads=self.num_threads)
        oh, ow = self.out_hw
        imgs = np.empty((len(idxs), oh, ow, self.channels), self.dtype)
        labels = np.empty((len(idxs),), np.int32)
        for j, i in enumerate(idxs):
            img, lab = self._reader[int(i)]
            if img.shape[:2] != (oh, ow):
                ys = (np.arange(oh) * img.shape[0] // oh)
                xs = (np.arange(ow) * img.shape[1] // ow)
                img = img[ys][:, xs]
            imgs[j] = img
            labels[j] = lab
        return imgs, labels

    def _batches(self) -> Iterator[np.ndarray]:
        mine = self._shard_indices()
        # advance the epoch counter up front so an early break (e.g.
        # --limit_steps_per_epoch) still gets a fresh permutation next time
        epoch = self.epoch
        self.epoch += 1
        order = make_order(len(mine), self.order_mode, self.seed, epoch)
        mine = mine[order]
        # multi-host: partial batches can't be assembled into a global array
        # with uneven per-host sizes — always drop the remainder when sharded
        drop = self.drop_last or self.shard[1] > 1
        end = len(mine) - (len(mine) % self.batch_size) if drop else len(mine)
        for s in range(0, end, self.batch_size):
            yield mine[s : s + self.batch_size]

    def _fetch_views(self, idxs: np.ndarray, epoch: int, batch_index: int):
        """Host pre-crop fetch: sample this batch's RRC windows
        deterministically from (seed, epoch, batch_index) — so --resume
        replays the identical augmentation stream — then decode+crop in the
        C++ workers (numpy fallback without a toolchain). Windows are sampled
        in the store's nominal (header) coordinates; per-record deviations
        are clamped at decode."""
        from medical_image_segmentation_tpu_torch.data.host_precrop import (
            fetch_views_fallback, make_view_params,
        )

        pc = self.precrop
        in_h, in_w = self._store_hw
        params = make_view_params(
            self.seed, epoch, batch_index, len(idxs), in_h, in_w,
            n_views=pc["n_views"], scale=pc["scale"], ratio=pc["ratio"],
            hflip_prob=pc["hflip_prob"], shard=self.shard[0],
        )
        if self._native is not None:
            return self._native.fetch_views(
                idxs, params, pc["out_hw"], num_threads=self.num_threads)
        return fetch_views_fallback(self._reader, idxs, params, pc["out_hw"])

    def __iter__(self):
        def gen():
            # capture before _batches advances the counter: _batches reads
            # this same value for its permutation, so the window stream and
            # the data order share one epoch
            epoch = self.epoch
            for b_idx, idxs in enumerate(self._batches()):
                with self.timers.stage("decode"):
                    if self.precrop is not None:
                        batch = self._fetch_views(idxs, epoch, b_idx)
                    else:
                        batch = self._fetch(idxs)
                yield batch

        yield from prefetch_iter(gen, self.prefetch, registry=self._producers)

    def close(self):
        # a consumer may abandon an iterator mid-epoch (e.g. the KNN bank cap
        # breaks out of the loop) — stop and join any still-live producers
        # before unmapping the store they decode from
        for stop, _ in list(self._producers):
            stop.set()
        for _, t in list(self._producers):
            t.join()
        self._producers.clear()
        if self._native is not None:
            self._native.close()
        if self._reader is not None:
            self._reader.close()


class PairedLoader:
    """Two aligned stores (e.g. images + masks) sampled with ONE order so
    pairs stay matched — the store-backed fast path for segmentation
    (created by `ingest/create_seg_store.py`)."""

    def __init__(
        self,
        image_store: str,
        mask_store: str,
        batch_size: int,
        order: str = RANDOM,
        num_threads: int = 4,
        seed: int = 0,
        drop_last: bool = True,
        shard: Tuple[int, int] = (0, 1),
        prefetch: int = 2,
        use_native: bool = True,
    ):
        self._imgs = Loader(image_store, batch_size, order=order, num_threads=num_threads,
                            seed=seed, drop_last=drop_last, shard=shard, prefetch=0,
                            use_native=use_native)
        self._msks = Loader(mask_store, batch_size, order=order, num_threads=num_threads,
                            seed=seed, drop_last=drop_last, shard=shard, prefetch=0,
                            use_native=use_native)
        if self._imgs._n_total != self._msks._n_total:
            raise ValueError(
                f"store size mismatch: {self._imgs._n_total} images vs {self._msks._n_total} masks"
            )
        self.batch_size = batch_size
        self.prefetch = prefetch

    def __len__(self):
        return len(self._imgs)

    @property
    def timers(self):
        return self._imgs.timers

    @property
    def epoch(self) -> int:
        """The epoch whose order the next ``iter()`` takes: the image
        loader's counter, which drives both stores. A resume sets it."""
        return self._imgs.epoch

    @epoch.setter
    def epoch(self, value: int) -> None:
        self._imgs.epoch = value

    def _pairs(self):
        # one index stream drives both stores (same seed/epoch → same order,
        # but we fetch by explicit indices to be immune to loader drift)
        for idxs in self._imgs._batches():
            with self.timers.stage("decode"):
                imgs, _ = self._imgs._fetch(idxs)
                msks, _ = self._msks._fetch(idxs)
            yield imgs, msks.astype(np.float32)

    def __iter__(self):
        # register on the image loader so close() joins our producer too
        yield from prefetch_iter(self._pairs, self.prefetch,
                                 registry=self._imgs._producers)

    def close(self):
        self._imgs.close()
        self._msks.close()
