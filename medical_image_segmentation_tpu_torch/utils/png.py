"""A PNG writer and reader on ``zlib``, ``struct`` and numpy.

``encode_png`` is the port's one image writer: the masks and overlays of
``mis-predict-torch``, the prediction grid of
``mis-train-segmentation-torch`` and, where OpenCV does not import, the
curated 16-bit subset and the Decathlon slices of the ingest CLIs (the JAX
package writes them with OpenCV, ``train/predict.py:104-116``,
``utils/viz.py:43-77``, ``data/ingest/create_subset.py:170-187``). It
writes 8-bit gray or RGB and 16-bit gray (big-endian samples); every row
gets filter type 0; the file is the signature, IHDR, one IDAT and IEND.
``png_size`` reads (height, width) from the IHDR alone.

``decode_png`` reads any non-interlaced PNG (all five row filters, every
bit depth, gray, gray+alpha, RGB, RGBA and palette), so that
``mis-predict-torch --images_dir`` serves PNG slices where OpenCV is not
installed. ``to_gray`` is OpenCV's ``COLOR_BGR2GRAY`` on its output.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


class PngUnsupported(ValueError):
    """A well-formed PNG that ``decode_png`` does not read (interlaced)."""
_COLOR_TYPE = {1: 0, 3: 2}  # channels → PNG colour type (gray, RGB)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)


def encode_png(img: np.ndarray, level: int = 1) -> bytes:
    """PNG bytes of a uint8 (H, W) gray, (H, W, 1) gray or (H, W, 3) RGB
    image, or of a uint16 gray one (bit depth 16)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"encode_png takes uint8 or uint16, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"encode_png takes (H, W), (H, W, 1) or (H, W, 3), got {img.shape}")
    if img.dtype == np.uint16 and img.shape[2] != 1:
        raise ValueError(f"encode_png writes 16 bits for gray images only, got {img.shape}")
    h, w, c = img.shape
    samples = img.astype(">u2").view(np.uint8) if img.dtype == np.uint16 else img
    rows = np.zeros((h, 1 + w * c * img.itemsize), np.uint8)  # column 0: filter type 0 (none)
    rows[:, 1:] = samples.reshape(h, -1)
    header = struct.pack(">IIBBBBB", w, h, 8 * img.itemsize, _COLOR_TYPE[c], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def png_size(path: str) -> tuple:
    """(height, width) of a PNG file from its IHDR chunk, the rest unread."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != _SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG")
    w, h = struct.unpack(">II", head[16:24])
    return h, w


_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type → samples a pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters. ``raw`` is ``h`` rows of one filter-type
    byte and ``stride`` data bytes; ``bpp`` is the whole bytes a pixel takes
    (at least 1), the distance to a byte's left neighbour."""
    rows = raw.reshape(h, 1 + stride)
    out = np.zeros((h + 1, stride), np.uint8)  # row 0: the zeros above the first row
    for y in range(h):
        kind, line, up = int(rows[y, 0]), rows[y, 1:], out[y]
        if kind == 0:
            out[y + 1] = line
        elif kind == 1:  # Sub: a running sum (mod 256) within each byte lane of the pixel
            for lane in range(bpp):
                out[y + 1, lane::bpp] = np.cumsum(line[lane::bpp], dtype=np.uint8)
        elif kind == 2:  # Up
            out[y + 1] = line + up
        elif kind in (3, 4):  # Average, Paeth: each byte needs its decoded left neighbour
            cur = [0] * bpp + line.tolist()
            above = [0] * bpp + up.tolist()
            for i in range(bpp, bpp + stride):
                a, b, c = cur[i - bpp], above[i], above[i - bpp]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else b if pb <= pc else c
                cur[i] = (cur[i] + pred) & 0xFF
            out[y + 1] = cur[bpp:]
        else:
            raise ValueError(f"PNG row {y} has unknown filter type {kind}")
    return out[1:]


def decode_png(data: bytes) -> np.ndarray:
    """The image of a non-interlaced PNG: (H, W) gray, (H, W, 2) gray+alpha,
    (H, W, 3) RGB or (H, W, 4) RGBA, uint8, or uint16 for 16-bit files. A
    palette file comes back as RGB (RGBA when it has a tRNS chunk); gray of
    1, 2 or 4 bits is scaled to 0..255, as libpng's expansion does. Raises
    PngUnsupported (a ValueError) on an interlaced (Adam7) file and
    ValueError on anything malformed."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG")
    pos, header, idat, palette, trns = 8, None, [], None, None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, ctype, compression, filtering, interlace = header
    if interlace:
        raise PngUnsupported("decode_png does not read interlaced (Adam7) PNGs; re-save the file without interlace")
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype] or compression or filtering:
        raise ValueError(f"unsupported PNG header {header}")
    c = _CHANNELS[ctype]
    stride = (w * c * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + stride):
        raise ValueError(f"PNG data holds {raw.size} bytes, its header asks for {h * (1 + stride)}")
    rows = _unfilter(raw, h, stride, max(1, c * depth // 8))
    if depth == 16:
        img = rows.reshape(h, w * c, 2).astype(np.uint16)
        img = (img[..., 0] << 8 | img[..., 1]).reshape(h, w, c)
    elif depth == 8:
        img = rows.reshape(h, w, c)
    else:  # 1, 2 or 4 bits: c == 1, samples packed high bits first, rows padded to a byte
        bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)[:, :w]
        img = (bits << np.arange(depth - 1, -1, -1, dtype=np.uint8)).sum(axis=2, dtype=np.uint8)[..., None]
        if ctype == 0:
            img = img * np.uint8(255 // ((1 << depth) - 1))
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without a PLTE chunk")
        index = img[..., 0]
        img = palette[index]
        if trns is not None:
            alpha = np.full(256, 255, np.uint8)
            alpha[:len(trns)] = trns
            img = np.concatenate([img, alpha[index][..., None]], axis=-1)
    return img[..., 0] if img.shape[2] == 1 else img


def to_gray(img: np.ndarray) -> np.ndarray:
    """(H, W) gray of a ``decode_png`` image, as OpenCV's ``COLOR_BGR2GRAY``
    makes it from ``cv2.imread(..., IMREAD_UNCHANGED)``: the BT.601 weights
    in fixed point, alpha ignored; uint8 stays uint8 and uint16 uint16."""
    if img.ndim == 2:
        return img
    if img.shape[2] == 2:
        return img[..., 0]
    r, g, b = (img[..., i].astype(np.int64) for i in range(3))
    return ((r * 9798 + g * 19235 + b * 3735 + (1 << 14)) >> 15).astype(img.dtype)
