"""An 8-bit grayscale / RGB PNG writer on ``zlib`` and ``struct``.

The port's one image writer: the masks and overlays of ``mis-predict-torch``
and the prediction grid of ``mis-train-segmentation-torch`` (the JAX
package writes them with OpenCV, ``train/predict.py:104-116`` and
``utils/viz.py:43-77``). Every row gets filter type 0; the file is the
signature, IHDR, one IDAT and IEND. ``decode_png`` reads such files back.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 3: 2}  # channels → PNG colour type (gray, RGB)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)


def encode_png(img: np.ndarray, level: int = 1) -> bytes:
    """PNG bytes of a uint8 (H, W) gray, (H, W, 1) gray or (H, W, 3) RGB image."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"encode_png takes (H, W), (H, W, 1) or (H, W, 3), got {img.shape}")
    h, w, c = img.shape
    rows = np.zeros((h, 1 + w * c), np.uint8)  # column 0: filter type 0 (none)
    rows[:, 1:] = img.reshape(h, w * c)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def decode_png(data: bytes) -> np.ndarray:
    """The uint8 (H, W) or (H, W, 3) image of a PNG that ``encode_png``
    wrote: 8-bit gray or RGB, every row of filter type 0. Raises on any
    other PNG."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
    if header is None or header[2] != 8 or header[3] not in (0, 2) or any(header[4:]):
        raise ValueError(f"decode_png reads 8-bit gray/RGB PNGs without interlace, got IHDR {header}")
    w, h, c = header[0], header[1], 1 if header[3] == 0 else 3
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * c)
    if rows[:, 0].any():
        raise ValueError("decode_png reads rows of filter type 0 only")
    img = rows[:, 1:].reshape(h, w, c)
    return img[..., 0] if c == 1 else img
