"""MIS store reader — memory-mapped random access (pure Python path).

This is the fallback/reference implementation; the hot path is the C++
loader (`csrc/mis_loader.cpp`) which shares the same on-disk format. The
mmap + page-cache behavior is the analogue of FFCV's ``os_cache=True``
(`lightning_module.py:141-151`).

PNG and JPEG payloads decode with OpenCV where it imports and otherwise
with ``utils/png.py`` and ``utils/jpeg.py`` (gray JPEG), to the same pixels.
"""

from __future__ import annotations

import mmap
from typing import Tuple

import numpy as np

from medical_image_segmentation_tpu_torch.data.store.format import (
    CODEC_JLS,
    CODEC_PNG,
    CODEC_RAW,
    HEADER_SIZE,
    RECORD_SIZE,
    SampleRecord,
    StoreHeader,
)
from medical_image_segmentation_tpu_torch.utils.jpeg import decode_jpeg_numpy
from medical_image_segmentation_tpu_torch.utils.png import decode_png
from medical_image_segmentation_tpu_torch.utils.resize import cv2_or_none


class StoreReader:
    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        self.header = StoreHeader.unpack(self._mm[:HEADER_SIZE])
        n = self.header.num_samples
        # vectorized index table — copied (32 B/sample) so no buffer export
        # pins the mmap open (mmap.close() raises BufferError while any
        # frombuffer view of it is alive)
        raw = np.frombuffer(self._mm, np.uint8, n * RECORD_SIZE, HEADER_SIZE)
        self._table = raw.reshape(n, RECORD_SIZE).copy()

    def __len__(self) -> int:
        return self.header.num_samples

    def record(self, i: int) -> SampleRecord:
        return SampleRecord.unpack(self._table[i].tobytes())

    @property
    def labels(self) -> np.ndarray:
        """All labels as one int32 vector (for KNN banks / stratified splits)."""
        return self._table[:, 24:28].copy().view("<i4").reshape(-1)

    def payload(self, i: int) -> bytes:
        r = self.record(i)
        return self._mm[r.offset : r.offset + r.length]

    def image(self, i: int) -> np.ndarray:
        r = self.record(i)
        dtype = self.header.sample_dtype
        if r.codec == CODEC_RAW:
            img = np.frombuffer(self._mm, np.dtype(dtype).newbyteorder("<"),
                                r.height * r.width * r.channels, r.offset)
            return img.astype(dtype, copy=False).reshape(r.height, r.width, r.channels)
        if r.codec == CODEC_JLS:
            from medical_image_segmentation_tpu_torch.data.jpegls import jpeg_ls_decode

            img = jpeg_ls_decode(self.payload(i))
            if img.ndim == 2:
                img = img[..., None]
            if img.dtype != dtype:
                raise ValueError(f"sample {i}: JLS precision mismatch "
                                 f"({img.dtype} payload in a {np.dtype(dtype)} store)")
            return img
        cv2 = cv2_or_none()
        if cv2 is None:  # the numpy codecs: PNG in its file's RGB order, gray JPEG
            data = self.payload(i)
            img = decode_png(data) if r.codec == CODEC_PNG else decode_jpeg_numpy(data)
        else:
            buf = np.frombuffer(self._mm, np.uint8, r.length, r.offset)
            img = cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)
            if img is None:
                raise ValueError(f"decode failed for sample {i}")
            if img.ndim == 3 and img.shape[-1] == 3:
                img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)  # payloads are RGB (see writer._encode)
        if img.dtype != dtype:
            raise ValueError(f"sample {i}: {img.dtype} payload in a {np.dtype(dtype)} store")
        if img.ndim == 2:
            img = img[..., None]
        return img

    def __getitem__(self, i: int) -> Tuple[np.ndarray, int]:
        return self.image(i), self.record(i).label

    def close(self) -> None:
        self._mm.close()
        self._f.close()
