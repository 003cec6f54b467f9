"""Baseline JPEG for one 8-bit component, in numpy.

The MIS store writes its 8-bit images as JPEG (``data/store/writer.py``,
``create_store``'s default) with ``cv2.imencode`` and reads them back with
``cv2.imdecode``. Where OpenCV does not import, ``encode_jpeg`` and
``decode_jpeg`` do the same work as libjpeg-turbo does for a gray image:

- encode: edges replicated to whole 8×8 blocks, libjpeg's quality scaling
  of the standard luminance table (baseline-limited), the integer "islow"
  forward DCT, libjpeg-turbo's reciprocal quantization, the standard
  Huffman tables of Annex K, and the same markers in the same order (SOI,
  JFIF APP0, DQT, SOF0, DHT DC, DHT AC, SOS, EOI). The bytes equal
  ``cv2.imencode(".jpg", gray, [IMWRITE_JPEG_QUALITY, q])``;
- decode: any baseline or extended sequential Huffman stream of one 8-bit
  component (its own tables, restart intervals), dequantization and
  libjpeg's integer "islow" inverse DCT with its rounding and clamping.
  The pixels equal ``cv2.imdecode``'s.

Streams of three components, progressive or arithmetic-coded ones raise
``JpegUnsupported`` by name: OpenCV reads those. The native store reader's
decoder (``csrc/jpeg_decode.cpp``) is this decoder's C++ twin, with YCbCr
added. ``encode_jpeg`` calls
OpenCV where it imports. ``jpeg_size`` reads the frame size from the
headers alone.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Dict, List, Tuple

import numpy as np


class JpegError(ValueError):
    """A stream the numpy routes cannot read or write: malformed data."""


class JpegUnsupported(JpegError):
    """A well-formed stream or image this numpy route does not carry
    (three components, progressive, other precisions): OpenCV does."""


def _zigzag() -> np.ndarray:
    """``jpeg_natural_order``: the natural (row-major) index of each zigzag position."""
    order = sorted(((r, c) for r in range(8) for c in range(8)),
                   key=lambda rc: (rc[0] + rc[1], rc[0] if (rc[0] + rc[1]) % 2 else rc[1]))
    return np.array([r * 8 + c for r, c in order], np.int64)


ZIGZAG = _zigzag()

# Annex K.1, natural order
STD_LUMINANCE_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99,
], np.int64)

# Annex K.3: code counts by length 1..16, then the symbols
DC_LUMINANCE = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
AC_LUMINANCE = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
    0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0,
    0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
    0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
    0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
    0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5,
    0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA,
])

# jfdctint.c / jidctint.c fixed-point constants (CONST_BITS = 13)
CONST_BITS, PASS1_BITS = 13, 2
F0_298, F0_390, F0_541, F0_765 = 2446, 3196, 4433, 6270
F0_899, F1_175, F1_501, F1_847 = 7373, 9633, 12299, 15137
F1_961, F2_053, F2_562, F3_072 = 16069, 16819, 20995, 25172


def _descale(x, n: int):
    return (x + (1 << (n - 1))) >> n


def quality_table(quality: int) -> np.ndarray:
    """libjpeg's ``jpeg_set_quality(cinfo, quality, TRUE)`` luminance table
    (natural order)."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return np.clip((STD_LUMINANCE_QUANT * scale + 50) // 100, 1, 255)


def huffman_codes(bits: List[int], values: List[int]) -> Dict[int, Tuple[int, int]]:
    """Annex C: symbol → (code, length) of a canonical Huffman table."""
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[values[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

def _fdct_1d(d, first: bool):
    """One pass of ``jpeg_fdct_islow`` over the last axis of ``d`` (int64)."""
    tmp0, tmp7 = d[..., 0] + d[..., 7], d[..., 0] - d[..., 7]
    tmp1, tmp6 = d[..., 1] + d[..., 6], d[..., 1] - d[..., 6]
    tmp2, tmp5 = d[..., 2] + d[..., 5], d[..., 2] - d[..., 5]
    tmp3, tmp4 = d[..., 3] + d[..., 4], d[..., 3] - d[..., 4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    out = np.empty_like(d)
    shift = CONST_BITS - PASS1_BITS if first else CONST_BITS + PASS1_BITS
    if first:
        out[..., 0] = (tmp10 + tmp11) << PASS1_BITS
        out[..., 4] = (tmp10 - tmp11) << PASS1_BITS
    else:
        out[..., 0] = _descale(tmp10 + tmp11, PASS1_BITS)
        out[..., 4] = _descale(tmp10 - tmp11, PASS1_BITS)
    z1 = (tmp12 + tmp13) * F0_541
    out[..., 2] = _descale(z1 + tmp13 * F0_765, shift)
    out[..., 6] = _descale(z1 + tmp12 * -F1_847, shift)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * F1_175
    tmp4, tmp5, tmp6, tmp7 = tmp4 * F0_298, tmp5 * F2_053, tmp6 * F3_072, tmp7 * F1_501
    z1, z2, z3, z4 = z1 * -F0_899, z2 * -F2_562, z3 * -F1_961 + z5, z4 * -F0_390 + z5
    out[..., 7] = _descale(tmp4 + z1 + z3, shift)
    out[..., 5] = _descale(tmp5 + z2 + z4, shift)
    out[..., 3] = _descale(tmp6 + z2 + z3, shift)
    out[..., 1] = _descale(tmp7 + z1 + z4, shift)
    return out


def _reciprocals(qtable: np.ndarray):
    """libjpeg-turbo's ``compute_reciprocal`` for the islow divisors
    ``q << 3``: q' = ((|x| + corr) * recip) >> shift."""
    recip, corr, shift = [], [], []
    for q in qtable.tolist():
        d = q << 3
        r = 16 + d.bit_length() - 1
        fq, fr = divmod(1 << r, d)
        c = d // 2
        if fr == 0:
            fq >>= 1
            r -= 1
        elif fr <= d // 2:
            c += 1
        else:
            fq += 1
        recip.append(fq)
        corr.append(c)
        shift.append(r)
    return np.array(recip, np.int64), np.array(corr, np.int64), np.array(shift, np.int64)


def _bit_pack(codes: np.ndarray, lengths: np.ndarray) -> bytes:
    """Concatenate variable-length codes MSB first, pad with 1 bits, then
    stuff a zero byte after every 0xFF."""
    width = int(lengths.max()) if lengths.size else 1
    j = np.arange(width)
    shifts = lengths[:, None] - 1 - j[None, :]
    bits = ((codes[:, None] >> np.maximum(shifts, 0)) & 1).astype(np.uint8)
    stream = bits[shifts >= 0]
    pad = (-stream.size) % 8
    stream = np.concatenate([stream, np.ones(pad, np.uint8)])
    packed = np.packbits(stream)
    ff = np.flatnonzero(packed == 0xFF)
    return np.insert(packed, ff + 1, 0).tobytes()


def _category(v: np.ndarray) -> np.ndarray:
    """Bit length of |v| (the JPEG magnitude category)."""
    a = np.abs(v)
    return np.where(a > 0, np.floor(np.log2(np.maximum(a, 1))).astype(np.int64) + 1, 0)


def _marker(code: int, payload: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, code, len(payload) + 2) + payload


def encode_jpeg_numpy(img: np.ndarray, quality: int = 95) -> bytes:
    """The bytes of ``cv2.imencode(".jpg", img, [IMWRITE_JPEG_QUALITY,
    quality])`` for a uint8 (H, W) or (H, W, 1) gray image."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim != 2:
        raise JpegUnsupported(f"the numpy JPEG encoder writes one component (gray), got {img.shape}: "
                        "three-channel JPEG needs OpenCV (cv2), which is not installed")
    if img.dtype != np.uint8:
        raise JpegError(f"baseline JPEG holds 8-bit samples, got {img.dtype}")
    h, w = img.shape
    if not (0 < h < 65536 and 0 < w < 65536):
        raise JpegError(f"JPEG sides are 1..65535, got {img.shape}")
    qt = quality_table(quality)
    padded = np.pad(img, ((0, -h % 8), (0, -w % 8)), mode="edge").astype(np.int64) - 128
    by, bx = padded.shape[0] // 8, padded.shape[1] // 8
    blocks = padded.reshape(by, 8, bx, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)
    coef = _fdct_1d(_fdct_1d(blocks, True).swapaxes(1, 2), False).swapaxes(1, 2).reshape(-1, 64)
    recip, corr, shift = _reciprocals(qt)
    q = ((np.abs(coef) + corr) * recip) >> shift
    q = np.where(coef < 0, -q, q)[:, ZIGZAG]

    dc_codes, ac_codes = huffman_codes(*DC_LUMINANCE), huffman_codes(*AC_LUMINANCE)
    dc_code = np.zeros(16, np.int64)
    dc_len = np.zeros(16, np.int64)
    for s, (c, n) in dc_codes.items():
        dc_code[s], dc_len[s] = c, n
    ac_code = np.zeros(256, np.int64)
    ac_len = np.zeros(256, np.int64)
    for s, (c, n) in ac_codes.items():
        ac_code[s], ac_len[s] = c, n

    nblocks = q.shape[0]
    diff = np.diff(q[:, 0], prepend=0)
    cat = _category(diff)
    extra = np.where(diff < 0, diff - 1, diff) & ((1 << cat) - 1)
    keys = [np.arange(nblocks) * 256]
    codes = [(dc_code[cat] << cat) | extra]
    lens = [dc_len[cat] + cat]

    blk, pos = np.nonzero(q[:, 1:])
    pos = pos + 1
    val = q[blk, pos]
    first = np.ones(blk.size, bool)
    first[1:] = blk[1:] != blk[:-1]
    prev = np.where(first, 0, np.concatenate([[0], pos[:-1]]))
    run = pos - prev - 1
    size = _category(val)
    bits = np.where(val < 0, val - 1, val) & ((1 << size) - 1)
    sym = ((run & 15) << 4) | size
    keys.append(blk * 256 + 2 * pos)
    codes.append((ac_code[sym] << size) | bits)
    lens.append(ac_len[sym] + size)
    nzrl = run >> 4
    zrl_at = np.repeat(np.arange(blk.size), nzrl)
    keys.append(blk[zrl_at] * 256 + 2 * pos[zrl_at] - 1)
    codes.append(np.full(zrl_at.size, ac_code[0xF0]))
    lens.append(np.full(zrl_at.size, ac_len[0xF0]))
    last = np.zeros(nblocks, np.int64)
    np.maximum.at(last, blk, pos)
    eob = np.flatnonzero(last < 63)
    keys.append(eob * 256 + 255)
    codes.append(np.full(eob.size, ac_code[0x00]))
    lens.append(np.full(eob.size, ac_len[0x00]))

    order = np.argsort(np.concatenate(keys), kind="stable")
    scan = _bit_pack(np.concatenate(codes)[order], np.concatenate(lens)[order])

    def dht(cls_id: int, table) -> bytes:
        return _marker(0xC4, bytes([cls_id]) + bytes(table[0]) + bytes(table[1]))

    return b"".join([
        b"\xFF\xD8",
        _marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"),
        _marker(0xDB, b"\x00" + bytes(qt[ZIGZAG].astype(np.uint8))),
        _marker(0xC0, struct.pack(">BHHB", 8, h, w, 1) + b"\x01\x11\x00"),
        dht(0x00, DC_LUMINANCE),
        dht(0x10, AC_LUMINANCE),
        _marker(0xDA, b"\x01\x01\x00\x00\x3F\x00"),
        scan,
        b"\xFF\xD9",
    ])


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _idct_1d(d, first: bool):
    """One pass of ``jpeg_idct_islow`` over the last axis of ``d`` (int64)."""
    z2, z3 = d[..., 2], d[..., 6]
    z1 = (z2 + z3) * F0_541
    tmp2 = z1 + z3 * -F1_847
    tmp3 = z1 + z2 * F0_765
    tmp0 = (d[..., 0] + d[..., 4]) << CONST_BITS
    tmp1 = (d[..., 0] - d[..., 4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    tmp0, tmp1, tmp2, tmp3 = d[..., 7], d[..., 5], d[..., 3], d[..., 1]
    z1, z2, z3, z4 = tmp0 + tmp3, tmp1 + tmp2, tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * F1_175
    tmp0, tmp1, tmp2, tmp3 = tmp0 * F0_298, tmp1 * F2_053, tmp2 * F3_072, tmp3 * F1_501
    z1, z2, z3, z4 = z1 * -F0_899, z2 * -F2_562, z3 * -F1_961 + z5, z4 * -F0_390 + z5
    tmp0, tmp1, tmp2, tmp3 = tmp0 + z1 + z3, tmp1 + z2 + z4, tmp2 + z2 + z3, tmp3 + z1 + z4
    n = CONST_BITS - PASS1_BITS if first else CONST_BITS + PASS1_BITS + 3
    out = np.empty_like(d)
    out[..., 0], out[..., 7] = _descale(tmp10 + tmp3, n), _descale(tmp10 - tmp3, n)
    out[..., 1], out[..., 6] = _descale(tmp11 + tmp2, n), _descale(tmp11 - tmp2, n)
    out[..., 2], out[..., 5] = _descale(tmp12 + tmp1, n), _descale(tmp12 - tmp1, n)
    out[..., 3], out[..., 4] = _descale(tmp13 + tmp0, n), _descale(tmp13 - tmp0, n)
    return out


def _lookup(bits: List[int], values: List[int]):
    """16-bit peek tables: symbol and code length of every 16-bit prefix."""
    sym = np.zeros(1 << 16, np.int64)
    length = np.zeros(1 << 16, np.int64)  # 0: no code starts so
    for s, (code, n) in huffman_codes(bits, values).items():
        lo = code << (16 - n)
        sym[lo:lo + (1 << (16 - n))] = s
        length[lo:lo + (1 << (16 - n))] = n
    return sym.tolist(), length.tolist()


def _entropy_segments(data: bytes, start: int) -> Tuple[List[bytes], int]:
    """The entropy-coded bytes after an SOS header, unstuffed and split at
    restart markers, and the position of the marker that ends the scan."""
    segments, cur, i, n = [], bytearray(), start, len(data)
    while i < n:
        j = data.find(b"\xFF", i)
        if j < 0 or j + 1 >= n:
            cur += data[i:]
            i = n
            break
        cur += data[i:j]
        nxt = data[j + 1]
        if nxt == 0x00:
            cur.append(0xFF)
            i = j + 2
        elif nxt == 0xFF:  # fill byte
            i = j + 1
        elif 0xD0 <= nxt <= 0xD7:
            segments.append(bytes(cur))
            cur = bytearray()
            i = j + 2
        else:
            i = j
            break
    segments.append(bytes(cur))
    return segments, i


def _decode_scan(segment: bytes, nblocks: int, dc_table, ac_table, out: List[int], first: int) -> None:
    """Huffman-decode ``nblocks`` blocks of one restart interval into
    ``out``: flat (block * 64 + natural index, value) pairs."""
    buf = np.frombuffer(segment + b"\x00" * 8, np.uint8).astype(np.int64)
    words = ((buf[:-3] << 24) | (buf[1:-2] << 16) | (buf[2:-1] << 8) | buf[3:]).tolist()
    dc_sym, dc_len = dc_table
    ac_sym, ac_len = ac_table
    natural = ZIGZAG.tolist() + [63] * 16
    pos, pred = 0, 0
    limit = len(segment) * 8 + 32
    append = out.append
    for b in range(first, first + nblocks):
        base = b * 64
        w = words[pos >> 3]
        peek = (w >> (16 - (pos & 7))) & 0xFFFF
        n = dc_len[peek]
        if n == 0 or pos > limit:
            raise JpegError("corrupt JPEG data: bad Huffman code")
        s = dc_sym[peek]
        pos += n
        if s:
            v = (words[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
            pos += s
            if v < (1 << (s - 1)):
                v -= (1 << s) - 1
            pred += v
        append(base)
        append(pred)
        k = 1
        while k < 64:
            w = words[pos >> 3]
            peek = (w >> (16 - (pos & 7))) & 0xFFFF
            n = ac_len[peek]
            if n == 0:
                raise JpegError("corrupt JPEG data: bad Huffman code")
            rs = ac_sym[peek]
            pos += n
            s = rs & 15
            if s:
                k += rs >> 4
                v = (words[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                pos += s
                if v < (1 << (s - 1)):
                    v -= (1 << s) - 1
                append(base + natural[k])
                append(v)
            elif rs != 0xF0:
                break
            else:
                k += 15
            k += 1
        if pos > limit:
            raise JpegError("corrupt JPEG data: scan ends early")


def decode_jpeg_numpy(data: bytes) -> np.ndarray:
    """The uint8 (H, W) image of a sequential Huffman JPEG of one 8-bit
    component: the pixels ``cv2.imdecode`` gives."""
    data = bytes(data)
    if data[:2] != b"\xFF\xD8":
        raise JpegError("not a JPEG (no SOI marker)")
    qtables: Dict[int, np.ndarray] = {}
    dc_tables, ac_tables = {}, {}
    frame = None
    restart = 0
    i = 2
    while i < len(data):
        if data[i] != 0xFF:
            raise JpegError(f"corrupt JPEG: expected a marker at byte {i}")
        while i < len(data) and data[i] == 0xFF:
            i += 1
        if i >= len(data):
            break
        code = data[i]
        i += 1
        if code == 0xD9:
            break
        if code == 0xD8 or 0xD0 <= code <= 0xD7 or code == 0x01:
            continue
        (length,) = struct.unpack(">H", data[i:i + 2])
        body = data[i + 2:i + length]
        i += length
        if code == 0xDB:
            p = 0
            while p < len(body):
                prec, tid = body[p] >> 4, body[p] & 15
                n = 128 if prec else 64
                vals = np.frombuffer(body[p + 1:p + 1 + n], ">u2" if prec else np.uint8).astype(np.int64)
                table = np.zeros(64, np.int64)
                table[ZIGZAG] = vals
                qtables[tid] = table
                p += 1 + n
        elif code == 0xC4:
            p = 0
            while p < len(body):
                cls, tid = body[p] >> 4, body[p] & 15
                bits = list(body[p + 1:p + 17])
                vals = list(body[p + 17:p + 17 + sum(bits)])
                (ac_tables if cls else dc_tables)[tid] = _lookup(bits, vals)
                p += 17 + sum(bits)
        elif code == 0xDD:
            (restart,) = struct.unpack(">H", body[:2])
        elif code in (0xC0, 0xC1):
            prec, h, w, nc = struct.unpack(">BHHB", body[:6])
            if prec != 8:
                raise JpegUnsupported(f"the numpy JPEG decoder reads 8-bit samples, this stream has {prec}")
            if nc != 1:
                raise JpegUnsupported(f"the numpy JPEG decoder reads one component (gray); this stream has {nc} "
                                "(three-channel JPEG needs OpenCV (cv2), which is not installed)")
            if h == 0:
                raise JpegUnsupported("JPEG with a DNL height is not supported")
            frame = (h, w, body[6], body[8])
        elif 0xC2 <= code <= 0xCF and code not in (0xC4, 0xC8, 0xCC):
            kind = "progressive" if code in (0xC2, 0xC6, 0xCA) else "lossless or arithmetic-coded"
            raise JpegUnsupported(f"the numpy JPEG decoder reads baseline/sequential Huffman streams; this one is "
                            f"{kind} (SOF{code - 0xC0}) and needs OpenCV (cv2), which is not installed")
        elif code == 0xDA:
            if frame is None:
                raise JpegError("SOS before SOF")
            h, w, comp_id, qid = frame
            if body[0] != 1 or body[1] != comp_id:
                raise JpegError("scan does not cover the frame's one component")
            td, ta = body[2] >> 4, body[2] & 15
            if td not in dc_tables or ta not in ac_tables or qid not in qtables:
                raise JpegError("scan references a missing Huffman or quantization table")
            by, bx = -(-h // 8), -(-w // 8)
            total = by * bx
            segments, i = _entropy_segments(data, i)
            per = restart or total
            flat: List[int] = []
            for n_seg, seg in enumerate(segments):
                first = n_seg * per
                if first >= total:
                    break
                _decode_scan(seg, min(per, total - first), dc_tables[td], ac_tables[ta], flat, first)
            pairs = np.array(flat, np.int64).reshape(-1, 2)
            coef = np.zeros(total * 64, np.int64)
            coef[pairs[:, 0]] = pairs[:, 1]
            coef = coef.reshape(total, 8, 8) * qtables[qid].reshape(8, 8)
            ws = _idct_1d(coef.swapaxes(1, 2), True).swapaxes(1, 2)
            pix = np.clip(_idct_1d(ws, False), -128, 127) + 128
            img = pix.reshape(by, bx, 8, 8).transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)
            return np.ascontiguousarray(img[:h, :w].astype(np.uint8))
    raise JpegError("JPEG without a scan")


def jpeg_size(f: BinaryIO) -> Tuple[int, int]:
    """(height, width) from the frame header (any SOF marker) of the JPEG
    file ``f`` (open, binary), reading no further than it."""
    read = f.read
    if read(2) != b"\xFF\xD8":
        raise JpegError("not a JPEG (no SOI marker)")
    while True:
        byte = read(1)
        while byte == b"\xFF":
            byte = read(1)
        if not byte:
            raise JpegError("JPEG without a frame header")
        code = byte[0]
        if code in (0x01, 0xD8) or 0xD0 <= code <= 0xD7:
            continue
        (length,) = struct.unpack(">H", read(2))
        body = read(length - 2)
        if 0xC0 <= code <= 0xCF and code not in (0xC4, 0xC8, 0xCC):
            _prec, h, w = struct.unpack(">BHH", body[:5])
            return h, w
        if code in (0xD9, 0xDA):
            raise JpegError("JPEG without a frame header")


def encode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """``cv2.imencode(".jpg", img, [IMWRITE_JPEG_QUALITY, quality])`` where
    OpenCV imports (BGR order for three channels, as OpenCV takes it),
    otherwise the numpy encoder (gray only)."""
    try:
        import cv2
    except ImportError:
        return encode_jpeg_numpy(img, quality)
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, int(quality)])
    if not ok:
        raise JpegError("JPEG encode failed")
    return buf.tobytes()

