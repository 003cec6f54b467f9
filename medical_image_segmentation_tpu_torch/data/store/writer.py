"""MIS store writer.

Capability parity with `ffcv.writer.DatasetWriter` as used by the reference
(`create_ffcv_subset.py:100-108`, `convert_pytorch_loader_to_ffcv_dataset.py:90-95`):
consume an indexed dataset (``__getitem__``/``__len__`` returning an image
array or (image, label)), optionally resize to ``max_resolution`` and
JPEG-compress, write in parallel, produce one self-contained file.

OpenCV encodes and resizes where it imports; elsewhere (the H100 machine)
``utils/jpeg.py``, ``utils/png.py`` and ``utils/resize.py`` write the same
JPEG bytes and the same pixels. A three-channel JPEG payload needs OpenCV.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from medical_image_segmentation_tpu_torch.data.store.format import (
    ALIGN,
    CODEC_JLS,
    CODEC_JPEG,
    CODEC_RAW,
    FLAG_U16,
    HEADER_SIZE,
    LABEL_INT32,
    LABEL_NONE,
    RECORD_SIZE,
    SampleRecord,
    StoreHeader,
)
from medical_image_segmentation_tpu_torch.utils.jpeg import encode_jpeg_numpy
from medical_image_segmentation_tpu_torch.utils.png import encode_png
from medical_image_segmentation_tpu_torch.utils.resize import cv2_or_none, resize


def _encode(img: np.ndarray, codec: int, quality: int) -> bytes:
    if codec == CODEC_RAW:
        # on-disk byte order is little-endian (the C++ loader casts the mmap
        # pointer); make it explicit for u16 so big-endian hosts interoperate
        if img.dtype == np.uint16:
            img = img.astype("<u2", copy=False)
        return np.ascontiguousarray(img).tobytes()
    if codec == CODEC_JLS:
        from medical_image_segmentation_tpu_torch.data.jpegls import jpeg_ls_encode

        # precision pinned by dtype (not by the sample's max value): the
        # decoders derive the output dtype from the stream's precision, so
        # a dark u16 slice must still round-trip as uint16
        return jpeg_ls_encode(img, near=0, precision=16 if img.dtype == np.uint16 else 8)
    if codec == CODEC_JPEG and img.dtype != np.uint8:
        raise ValueError("JPEG store payloads are 8-bit; use PNG/JLS/RAW for uint16")
    cv2 = cv2_or_none()
    if cv2 is None:  # the numpy codecs: the same pixels (JPEG: the same bytes), gray JPEG only
        return encode_jpeg_numpy(img, quality) if codec == CODEC_JPEG else encode_png(img)
    # store payloads are RGB-ordered: cv2.imencode assumes BGR input, so
    # 3-channel images are swapped before encoding (the C++ loader decodes
    # with libjpeg/libpng straight to RGB; StoreReader swaps back after
    # cv2.imdecode) — without this the two decode paths disagree
    if img.ndim == 3 and img.shape[-1] == 3:
        img = cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
    ext = ".jpg" if codec == CODEC_JPEG else ".png"
    params = [cv2.IMWRITE_JPEG_QUALITY, quality] if codec == CODEC_JPEG else []
    ok, buf = cv2.imencode(ext, img, params)
    if not ok:
        raise ValueError("image encode failed")
    return buf.tobytes()


def _maybe_resize(img: np.ndarray, max_resolution: Optional[int]) -> np.ndarray:
    if max_resolution is None:
        return img
    h, w = img.shape[:2]
    m = max(h, w)
    if m <= max_resolution:
        return img
    scale = max_resolution / m
    return resize(img, (int(round(w * scale)), int(round(h * scale))), "area")


class StoreWriter:
    """Streaming writer. Samples must share the channel count; per-sample
    h/w may vary (the header records the max, sizing loader buffers).

    ``dtype=np.uint16`` writes a 16-bit store (header ``FLAG_U16``) —
    single-channel only, codecs RAW/PNG/JLS (see format.py)."""

    def __init__(self, path: str, channels: int, with_labels: bool = False,
                 dtype=np.uint8):
        self.path = path
        self.channels = channels
        self.with_labels = with_labels
        self.dtype = np.dtype(dtype)
        if self.dtype not in (np.dtype(np.uint8), np.dtype(np.uint16)):
            raise ValueError(f"store dtype must be uint8 or uint16, got {self.dtype}")
        if self.dtype == np.uint16 and channels != 1:
            raise ValueError("uint16 stores are single-channel (radiology grayscale)")
        self.records = []
        self._tmp_data = open(path + ".data.tmp", "wb")
        self._data_pos = 0
        self.max_h = 0
        self.max_w = 0

    def add(self, img: np.ndarray, label: int = 0, codec: int = CODEC_RAW, quality: int = 90) -> None:
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[-1] != self.channels:
            raise ValueError(f"expected {self.channels} channels, got {img.shape}")
        if img.dtype != self.dtype:
            raise ValueError(f"store holds {self.dtype} images, got {img.dtype}")
        payload = _encode(img if img.shape[-1] > 1 else img[..., 0], codec, quality)
        self.add_encoded(payload, img.shape[0], img.shape[1], label=label, codec=codec)

    def add_encoded(self, payload: bytes, height: int, width: int,
                    label: int = 0, codec: int = CODEC_RAW) -> None:
        """Append a pre-encoded payload (the parallel-writer path: workers
        encode, the parent assembles in index order)."""
        pad = (-self._data_pos) % ALIGN
        self._tmp_data.write(b"\x00" * pad)
        self._data_pos += pad
        self.records.append(
            SampleRecord(
                offset=self._data_pos, length=len(payload),
                height=height, width=width, channels=self.channels,
                codec=codec, label=int(label),
            )
        )
        self._tmp_data.write(payload)
        self._data_pos += len(payload)
        self.max_h = max(self.max_h, height)
        self.max_w = max(self.max_w, width)

    def close(self) -> None:
        self._tmp_data.close()
        n = len(self.records)
        header = StoreHeader(
            num_samples=n, height=self.max_h, width=self.max_w, channels=self.channels,
            default_codec=self.records[0].codec if n else CODEC_RAW,
            label_dtype=LABEL_INT32 if self.with_labels else LABEL_NONE,
            flags=FLAG_U16 if self.dtype == np.uint16 else 0,
        )
        data_start = HEADER_SIZE + n * RECORD_SIZE
        data_start += (-data_start) % ALIGN
        with open(self.path, "wb") as f:
            f.write(header.pack())
            for r in self.records:
                r2 = SampleRecord(**{**r.__dict__, "offset": r.offset + data_start})
                f.write(r2.pack())
            f.write(b"\x00" * (data_start - HEADER_SIZE - n * RECORD_SIZE))
            with open(self.path + ".data.tmp", "rb") as src:
                while True:
                    chunk = src.read(1 << 22)
                    if not chunk:
                        break
                    f.write(chunk)
        os.remove(self.path + ".data.tmp")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# fork-inherited worker state (Linux): set in the parent right before the
# pool spawns so child processes see the dataset without pickling it —
# the same trick FFCV's DatasetWriter uses for its worker pool
# (`create_ffcv_subset.py:100-104` passes num_workers)
_WORKER_CTX: dict = {}


def _encode_chunk(chunk: Sequence[int]):
    ds = _WORKER_CTX["dataset"]
    max_res = _WORKER_CTX["max_resolution"]
    codec = _WORKER_CTX["codec"]
    quality = _WORKER_CTX["quality"]
    channels = _WORKER_CTX["channels"]
    dtype = _WORKER_CTX["dtype"]
    out = []
    for i in chunk:
        item = ds[i]
        if isinstance(item, tuple):
            img, label = item
            labeled = True
        else:
            img, label = item, 0
            labeled = False
        img = _maybe_resize(np.asarray(img), max_res)
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[-1] != channels:
            raise ValueError(f"expected {channels} channels, got {img.shape}")
        if img.dtype != dtype:
            raise ValueError(f"store holds {dtype} images, got {img.dtype}")
        payload = _encode(img if img.shape[-1] > 1 else img[..., 0], codec, quality)
        out.append((payload, img.shape[0], img.shape[1], int(label), labeled))
    return out


def write_store_from_dataset(
    path: str,
    dataset,                      # __len__ + __getitem__ → img | (img, label)
    channels: int,
    max_resolution: Optional[int] = None,
    codec: int = CODEC_RAW,
    quality: int = 90,
    num_processes: int = 1,
    indices: Optional[Sequence[int]] = None,
    dtype=np.uint8,
) -> int:
    """Build a store from an indexed dataset (the `DatasetWriter.
    from_indexed_dataset` equivalent). Returns the number of samples written.

    ``num_processes > 1`` encodes (decode→resize→JPEG) in a worker pool while
    the parent assembles records in index order — the output is byte-identical
    to the serial path."""
    idxs = list(indices) if indices is not None else list(range(len(dataset)))
    with_labels = False
    parallel = num_processes > 1 and len(idxs) > 1
    if parallel:
        import multiprocessing

        # the parallel path hard-requires fork inheritance of _WORKER_CTX;
        # on platforms without fork (or from a process where forking is
        # unsafe), degrade to the byte-identical serial path
        parallel = "fork" in multiprocessing.get_all_start_methods()
    with StoreWriter(path, channels=channels, with_labels=True, dtype=dtype) as w:
        if parallel:
            import concurrent.futures as cf
            import multiprocessing

            _WORKER_CTX.update(
                dataset=dataset, max_resolution=max_resolution,
                codec=codec, quality=quality, channels=channels,
                dtype=np.dtype(dtype),
            )
            try:
                chunk_size = max(1, min(64, len(idxs) // (num_processes * 4) or 1))
                chunks = [idxs[s : s + chunk_size] for s in range(0, len(idxs), chunk_size)]
                # _WORKER_CTX reaches workers by fork inheritance — request
                # the fork start method explicitly (spawn/forkserver defaults
                # elsewhere would give workers an empty context)
                with cf.ProcessPoolExecutor(
                    max_workers=num_processes,
                    mp_context=multiprocessing.get_context("fork"),
                ) as pool:
                    # executor.map preserves chunk order → records land in
                    # index order, matching the serial writer byte-for-byte
                    for results in pool.map(_encode_chunk, chunks):
                        for payload, h, wdt, label, labeled in results:
                            with_labels = with_labels or labeled
                            w.add_encoded(payload, h, wdt, label=label, codec=codec)
            finally:
                _WORKER_CTX.clear()
        else:
            for i in idxs:
                item = dataset[i]
                if isinstance(item, tuple):
                    img, label = item
                    with_labels = True
                else:
                    img, label = item, 0
                img = _maybe_resize(np.asarray(img), max_resolution)
                w.add(img, label=label, codec=codec, quality=quality)
        w.with_labels = with_labels
    return len(idxs)
