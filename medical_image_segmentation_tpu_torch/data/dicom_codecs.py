"""Compressed DICOM pixel-data codecs.

The reference ingests compressed TCIA DICOMs through pydicom's
GDCM/pylibjpeg plugins (`docker/Dockerfile:34-35`, consumed at
`medical_image_segmentation/analyze_data/create_subset.py:197,506`). This
module provides the native equivalents for the syntaxes that dominate TCIA
archives:

- **RLE Lossless** (1.2.840.10008.1.2.5) — PS3.5 Annex G PackBits byte
  segments, decoded with NumPy (decode) and encoded for fixtures/tools;
- **JPEG Baseline** (1.2.840.10008.1.2.4.50) — 8-bit DCT, decoded through
  OpenCV's libjpeg binding (decode integration is ours, the codec is the
  same libjpeg-turbo the loader links);
- **JPEG Lossless, Non-Hierarchical** (1.2.840.10008.1.2.4.57 and the
  first-order-prediction .70 that TCIA CT/MR series use) — ITU-T T.81
  process 14: Huffman-coded difference categories + predictor
  reconstruction. Fast path is the C++ decoder in `csrc/dicom_codecs.cpp`;
  a pure-Python implementation (same spec) is the no-toolchain fallback and
  the parity oracle in tests.

Encoders (`rle_encode`, `jpeg_lossless_encode`) exist for building
synthetic fixtures and for the DICOM writer — they emit spec-conformant
streams that round-trip through both decoders.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np


class CodecError(ValueError):
    pass


# ---------------------------------------------------------------------------
# RLE Lossless (PS3.5 Annex G)
# ---------------------------------------------------------------------------

def _rle_decode_segment(data: bytes, expected: int) -> np.ndarray:
    """PackBits-decode one byte segment."""
    out = np.empty(expected, np.uint8)
    pos = 0
    i = 0
    n_data = len(data)
    while pos < expected and i < n_data:
        n = data[i]
        i += 1
        if n <= 127:
            count = n + 1
            if i + count > n_data or pos + count > expected:
                raise CodecError("RLE literal run overruns segment")
            out[pos : pos + count] = np.frombuffer(data, np.uint8, count, i)
            i += count
            pos += count
        elif n >= 129:  # -127..-1 two's complement
            count = 257 - n
            if i >= n_data or pos + count > expected:
                raise CodecError("RLE replicate run overruns segment")
            out[pos : pos + count] = data[i]
            i += 1
            pos += count
        # n == 128: no-op per spec
    if pos != expected:
        raise CodecError(f"RLE segment decoded {pos} of {expected} bytes")
    return out


def rle_decode(
    data: bytes, rows: int, cols: int, bits_allocated: int, samples: int = 1
) -> np.ndarray:
    """Decode one RLE frame → (rows, cols) or (rows, cols, samples) uint8/16.

    Segment layout per Annex G: for each sample, one segment per byte of the
    composite pixel code, most-significant byte first."""
    if len(data) < 64:
        raise CodecError("RLE frame shorter than its 64-byte header")
    header = struct.unpack("<16I", data[:64])
    n_seg = header[0]
    bytes_per = bits_allocated // 8
    if n_seg != samples * bytes_per:
        raise CodecError(f"RLE header has {n_seg} segments, expected {samples * bytes_per}")
    offsets = list(header[1 : 1 + n_seg]) + [len(data)]
    n_px = rows * cols
    planes = []
    for s in range(n_seg):
        seg = data[offsets[s] : offsets[s + 1]]
        planes.append(_rle_decode_segment(seg, n_px))
    out = np.zeros((samples, n_px), np.uint32)
    for smp in range(samples):
        for b in range(bytes_per):  # MSB first
            shift = 8 * (bytes_per - 1 - b)
            out[smp] |= planes[smp * bytes_per + b].astype(np.uint32) << shift
    dtype = {1: np.uint8, 2: np.uint16, 4: np.uint32}[bytes_per]
    arr = out.astype(dtype).reshape(samples, rows, cols)
    return arr[0] if samples == 1 else np.moveaxis(arr, 0, -1)


def _rle_encode_segment(plane: np.ndarray) -> bytes:
    """PackBits-encode one byte plane (replicate runs ≥3, literals otherwise)."""
    data = plane.tobytes()
    n = len(data)
    out = bytearray()
    i = 0
    while i < n:
        # find run length at i
        run = 1
        while i + run < n and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 3:
            out.append(257 - run)
            out.append(data[i])
            i += run
        else:
            # literal: scan forward until a ≥3 run starts or 128 bytes
            j = i
            while j < n and j - i < 128:
                r = 1
                while j + r < n and r < 3 and data[j + r] == data[j]:
                    r += 1
                if r >= 3:
                    break
                j += 1
            out.append(j - i - 1)
            out += data[i:j]
            i = j
    if len(out) % 2:
        out.append(0)  # segments are padded to even length
    return bytes(out)


def rle_encode(arr: np.ndarray) -> bytes:
    """Encode (rows, cols[, samples]) uint8/uint16 → one RLE frame."""
    if arr.ndim == 2:
        arr = arr[..., None]
    rows, cols, samples = arr.shape
    bytes_per = arr.dtype.itemsize
    segs: List[bytes] = []
    for smp in range(samples):
        v = arr[..., smp].astype(np.uint32).ravel()
        for b in range(bytes_per):  # MSB first
            shift = 8 * (bytes_per - 1 - b)
            segs.append(_rle_encode_segment(((v >> shift) & 0xFF).astype(np.uint8)))
    if len(segs) > 15:
        raise CodecError("RLE supports at most 15 segments")
    header = [len(segs)]
    pos = 64
    for s in segs:
        header.append(pos)
        pos += len(s)
    header += [0] * (16 - len(header))
    body = struct.pack("<16I", *header) + b"".join(segs)
    if len(body) % 2:
        body += b"\x00"
    return body


# ---------------------------------------------------------------------------
# JPEG Lossless process 14 (ITU-T T.81) — pure-Python reference decoder
# ---------------------------------------------------------------------------

class _BitReader:
    """MSB-first bit reader over entropy-coded data with 0xFF00 unstuffing."""

    __slots__ = ("data", "i", "n", "acc", "bits")

    def __init__(self, data: bytes):
        self.data = data
        self.i = 0
        self.n = len(data)
        self.acc = 0
        self.bits = 0

    def _fill(self):
        while self.bits <= 24 and self.i < self.n:
            b = self.data[self.i]
            if b == 0xFF:
                if self.i + 1 < self.n and self.data[self.i + 1] == 0x00:
                    self.i += 2
                else:
                    # a marker: feed 1-bits (decoders may read past the end
                    # of the last byte's padding)
                    self.acc = (self.acc << 8) | 0xFF
                    self.bits += 8
                    continue
            else:
                self.i += 1
            self.acc = (self.acc << 8) | b
            self.bits += 8

    def read(self, k: int) -> int:
        if k == 0:
            return 0
        if self.bits < k:
            self._fill()
            if self.bits < k:
                # pad with 1s (marker padding)
                self.acc = (self.acc << (k - self.bits)) | ((1 << (k - self.bits)) - 1)
                self.bits = k
        self.bits -= k
        v = (self.acc >> self.bits) & ((1 << k) - 1)
        self.acc &= (1 << self.bits) - 1
        return v


class _Huffman:
    """Canonical JPEG Huffman table → (maxcode/valptr decoding, T.81 F.2.2.3)."""

    def __init__(self, counts: List[int], symbols: List[int]):
        code = 0
        self.mincode = [0] * 17
        self.maxcode = [-1] * 17
        self.valptr = [0] * 17
        k = 0
        for ln in range(1, 17):
            if counts[ln - 1]:
                self.valptr[ln] = k
                self.mincode[ln] = code
                code += counts[ln - 1]
                k += counts[ln - 1]
                self.maxcode[ln] = code - 1
            code <<= 1
        self.symbols = symbols

    def decode(self, br: _BitReader) -> int:
        code = br.read(1)
        ln = 1
        while ln < 17 and code > self.maxcode[ln]:
            code = (code << 1) | br.read(1)
            ln += 1
        if ln >= 17:
            raise CodecError("invalid Huffman code")
        return self.symbols[self.valptr[ln] + code - self.mincode[ln]]


def _extend(v: int, t: int) -> int:
    """T.81 F.2.2.1 EXTEND: map t-bit magnitude to signed difference."""
    if t == 0:
        return 0
    if v < (1 << (t - 1)):
        return v - (1 << t) + 1
    return v


def jpeg_lossless_decode_py(data: bytes) -> np.ndarray:
    """Decode a lossless (process 14) JPEG stream → (rows, cols[, ncomp])
    uint16. Supports 2–16-bit precision, 1–3 non-subsampled components,
    any predictor selection 1–7, point transform, restart intervals."""
    if len(data) < 4 or data[0] != 0xFF or data[1] != 0xD8:
        raise CodecError("not a JPEG stream (no SOI)")
    i = 2
    huff: dict = {}
    precision = rows = cols = 0
    ncomp = 0
    comp_ids: List[int] = []
    restart_interval = 0
    scan = None
    while i < len(data):
        if data[i] != 0xFF:
            i += 1
            continue
        marker = data[i + 1]
        i += 2
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            continue
        if marker == 0xD9:  # EOI
            break
        (seglen,) = struct.unpack(">H", data[i : i + 2])
        seg = data[i + 2 : i + seglen]
        if marker == 0xC3:  # SOF3 — lossless sequential Huffman
            precision = seg[0]
            rows, cols = struct.unpack(">HH", seg[1:5])
            ncomp = seg[5]
            comp_ids = []
            for c in range(ncomp):
                cid, hv, _tq = seg[6 + 3 * c : 9 + 3 * c]
                if hv != 0x11:
                    raise CodecError("subsampled lossless JPEG not supported")
                comp_ids.append(cid)
        elif marker in (0xC0, 0xC1, 0xC2, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF):
            raise CodecError(f"not a lossless (SOF3) JPEG: SOF{marker & 0xF}")
        elif marker == 0xC4:  # DHT
            p = 0
            while p < len(seg):
                if p + 17 > len(seg):
                    raise CodecError("truncated DHT segment")
                tc_th = seg[p]
                counts = list(seg[p + 1 : p + 17])
                nsym = sum(counts)
                if nsym > 256:  # T.81 limit; also the C++ decoder's bound
                    raise CodecError(f"DHT declares {nsym} symbols (max 256)")
                if p + 17 + nsym > len(seg):
                    raise CodecError("DHT symbol table truncated")
                symbols = list(seg[p + 17 : p + 17 + nsym])
                huff[tc_th & 0x0F] = _Huffman(counts, symbols)
                p += 17 + nsym
        elif marker == 0xDD:  # DRI
            (restart_interval,) = struct.unpack(">H", seg[:2])
        elif marker == 0xDA:  # SOS
            ns = seg[0]
            tables = []
            for c in range(ns):
                cid, tdta = seg[1 + 2 * c : 3 + 2 * c]
                if cid not in comp_ids:
                    raise CodecError("scan component not in frame")
                td = tdta >> 4
                if td not in huff:
                    raise CodecError(f"scan references undefined Huffman table {td}")
                tables.append(huff[td])
            predictor = seg[1 + 2 * ns]  # Ss = predictor selection value
            pt = seg[3 + 2 * ns] & 0x0F  # Al = point transform
            scan = (ns, tables, predictor, pt, data[i + seglen :])
            break
        i += seglen
    if scan is None or rows == 0:
        raise CodecError("missing SOF3/SOS")
    ns, tables, sel, pt, entropy = scan
    if ns != ncomp:
        raise CodecError("non-interleaved multi-scan lossless not supported")
    if pt >= precision:
        # point transform must leave >=1 magnitude bit (mirrors C++ rc=14)
        raise CodecError(f"point transform {pt} >= precision {precision}")

    br = _BitReader(entropy)
    out = np.empty((rows, cols, ncomp), np.int32)
    default = 1 << (precision - pt - 1)
    mask = (1 << 16) - 1
    mcu = 0
    restart_left = restart_interval if restart_interval else -1
    for y in range(rows):
        for x in range(cols):
            if restart_interval and mcu and mcu % restart_interval == 0:
                # byte-align + skip the RSTn marker; predictors reset
                br.acc = 0
                br.bits = 0
                while br.i + 1 < br.n and not (
                    br.data[br.i] == 0xFF and 0xD0 <= br.data[br.i + 1] <= 0xD7
                ):
                    br.i += 1
                br.i += 2
            restart = restart_interval and mcu % restart_interval == 0
            for c in range(ncomp):
                t = tables[c].decode(br)
                if t > 16:
                    raise CodecError(f"invalid SSSS {t}")
                diff = 32768 if t == 16 else _extend(br.read(t), t)
                if (y == 0 and x == 0) or restart:
                    px = default
                elif y == 0:
                    px = out[y, x - 1, c]
                elif x == 0:
                    px = out[y - 1, x, c]
                else:
                    ra = out[y, x - 1, c]
                    rb = out[y - 1, x, c]
                    rc_ = out[y - 1, x - 1, c]
                    if sel == 1:
                        px = ra
                    elif sel == 2:
                        px = rb
                    elif sel == 3:
                        px = rc_
                    elif sel == 4:
                        px = ra + rb - rc_
                    elif sel == 5:
                        px = ra + ((rb - rc_) >> 1)
                    elif sel == 6:
                        px = rb + ((ra - rc_) >> 1)
                    elif sel == 7:
                        px = (ra + rb) >> 1
                    else:
                        raise CodecError(f"invalid predictor selection {sel}")
                out[y, x, c] = (px + diff) & mask
            mcu += 1
    arr = (out.astype(np.uint32) << pt).astype(np.uint16)
    return arr[..., 0] if ncomp == 1 else arr


# ---------------------------------------------------------------------------
# JPEG Lossless encoder (fixtures + DICOM writer)
# ---------------------------------------------------------------------------

class _BitWriter:
    __slots__ = ("out", "acc", "bits")

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.bits = 0

    def write(self, v: int, k: int):
        self.acc = (self.acc << k) | (v & ((1 << k) - 1))
        self.bits += k
        while self.bits >= 8:
            self.bits -= 8
            b = (self.acc >> self.bits) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0x00)  # byte stuffing
            self.acc &= (1 << self.bits) - 1

    def flush(self):
        if self.bits:
            pad = 8 - self.bits
            self.write((1 << pad) - 1, pad)


def _category(diff: int) -> Tuple[int, int]:
    """SSSS category + magnitude bits for a difference (mod-2^16 folded)."""
    diff = ((diff + 32768) & 0xFFFF) - 32768
    if diff == 0:
        return 0, 0
    if diff == 32768 or diff == -32768:
        return 16, 0
    mag = abs(diff)
    t = mag.bit_length()
    v = diff if diff > 0 else diff + (1 << t) - 1
    return t, v


def jpeg_lossless_encode(
    arr: np.ndarray, precision: Optional[int] = None, predictor: int = 1
) -> bytes:
    """Encode (rows, cols) uint8/uint16 → a process-14 JPEG stream
    (selection value ``predictor``; SV1 = the DICOM .70 syntax)."""
    if arr.ndim != 2:
        raise CodecError("encoder supports single-component images")
    rows, cols = arr.shape
    if precision is None:
        precision = max(2, int(arr.max()).bit_length()) if arr.size else 8
    a = arr.astype(np.int32)

    # pass 1: differences
    diffs = np.empty((rows, cols), np.int32)
    default = 1 << (precision - 1)
    pred = np.empty((rows, cols), np.int32)
    pred[0, 0] = default
    if cols > 1:
        pred[0, 1:] = a[0, :-1]
    if rows > 1:
        pred[1:, 0] = a[:-1, 0]
        if cols > 1:
            ra = a[1:, :-1]
            rb = a[:-1, 1:]
            rc_ = a[:-1, :-1]
            if predictor == 1:
                pred[1:, 1:] = ra
            elif predictor == 2:
                pred[1:, 1:] = rb
            elif predictor == 3:
                pred[1:, 1:] = rc_
            elif predictor == 4:
                pred[1:, 1:] = ra + rb - rc_
            elif predictor == 5:
                pred[1:, 1:] = ra + ((rb - rc_) >> 1)
            elif predictor == 6:
                pred[1:, 1:] = rb + ((ra - rc_) >> 1)
            elif predictor == 7:
                pred[1:, 1:] = (ra + rb) >> 1
            else:
                raise CodecError(f"invalid predictor {predictor}")
    diffs = (a - pred) & 0xFFFF

    # pass 2: Huffman table from category histogram (canonical, ≤16-bit codes)
    cats = np.empty((rows, cols), np.uint8)
    flat = diffs.ravel()
    signed = ((flat + 32768) & 0xFFFF) - 32768
    mag = np.abs(signed)
    cats = np.where(
        signed == -32768, 16,
        np.where(mag == 0, 0, np.ceil(np.log2(mag.astype(np.float64) + 1)).astype(np.int64)),
    ).astype(np.uint8)
    # exact bit_length (log2 rounding is unsafe near powers of two)
    for t in range(1, 17):
        sel_ = (mag >= (1 << (t - 1))) & (mag < (1 << t)) & (signed != -32768)
        cats[sel_] = t
    hist = np.bincount(cats, minlength=17)
    present = [s for s in range(17) if hist[s]]
    # simple length assignment: frequent symbols get short codes; a proper
    # Huffman build is overkill for ≤17 symbols — assign by sorted frequency,
    # lengths grow just enough to stay prefix-decodable (canonical Kraft)
    order = sorted(present, key=lambda s: -int(hist[s]))
    lengths = {}
    # canonical length assignment with a RESERVED leaf: T.81 requires that
    # no codeword be all 1-bits (padding disambiguation, Annex K.2), so the
    # prefix set must stay incomplete — at each level take the most symbols
    # that still leave >= remaining+1 leaves reachable at depth 16
    remaining = len(order)
    idx = 0
    cap = 2
    for ln in range(1, 17):
        if not remaining:
            break
        t = 0
        for cand in range(min(remaining, cap), -1, -1):
            if (cap - cand) * (1 << (16 - ln)) >= remaining - cand + 1:
                t = cand
                break
        for s in order[idx:idx + t]:
            lengths[s] = ln
        idx += t
        remaining -= t
        cap = (cap - t) * 2
    if remaining:
        raise CodecError("Huffman length overflow")
    counts = [0] * 16
    by_len = sorted(lengths.items(), key=lambda kv: (kv[1], kv[0]))
    symbols = [s for s, _l in by_len]
    for _s, l in by_len:
        counts[l - 1] += 1
    codes = {}
    code = 0
    k = 0
    for l in range(1, 17):
        for _ in range(counts[l - 1]):
            codes[symbols[k]] = (code, l)
            code += 1
            k += 1
        code <<= 1

    bw = _BitWriter()
    for y in range(rows):
        for x in range(cols):
            d = int(diffs[y, x])
            t, v = _category(((d + 32768) & 0xFFFF) - 32768)
            c, l = codes[t]
            bw.write(c, l)
            if 0 < t < 16:
                bw.write(v, t)
    bw.flush()

    out = bytearray(b"\xff\xd8")  # SOI
    # DHT
    dht = bytes([0x00]) + bytes(counts) + bytes(symbols)
    out += b"\xff\xc4" + struct.pack(">H", 2 + len(dht)) + dht
    # SOF3
    sof = struct.pack(">BHHB", precision, rows, cols, 1) + bytes([1, 0x11, 0])
    out += b"\xff\xc3" + struct.pack(">H", 2 + len(sof)) + sof
    # SOS
    sos = bytes([1, 1, 0x00, predictor, 0, 0])
    out += b"\xff\xda" + struct.pack(">H", 2 + len(sos)) + sos
    out += bw.out
    out += b"\xff\xd9"  # EOI
    return bytes(out)


# ---------------------------------------------------------------------------
# Native (C++) fast path + dispatch
# ---------------------------------------------------------------------------

def jpeg_lossless_decode(data: bytes) -> np.ndarray:
    """JPEG-lossless decode: C++ when the toolchain is available, else the
    pure-Python reference implementation (same spec; parity-tested)."""
    from medical_image_segmentation_tpu_torch.data.store.native import get_lib

    lib = get_lib()
    if lib is not None and hasattr(lib, "jls_decode"):
        import ctypes

        rows = ctypes.c_int()
        cols = ctypes.c_int()
        ncomp = ctypes.c_int()
        rc = lib.jls_probe(data, len(data), ctypes.byref(rows), ctypes.byref(cols),
                           ctypes.byref(ncomp))
        if rc == 0:
            out = np.empty(rows.value * cols.value * ncomp.value, np.uint16)
            rc = lib.jls_decode(
                data, len(data),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), out.size,
            )
            if rc == 0:
                out = out.reshape(rows.value, cols.value, ncomp.value)
                return out[..., 0] if ncomp.value == 1 else out
        # rc != 0 → fall through to the Python decoder for a precise error
    return jpeg_lossless_decode_py(data)


def jpeg_baseline_decode(data: bytes) -> np.ndarray:
    """8-bit baseline JPEG via OpenCV (libjpeg-turbo), or without OpenCV
    through ``utils/jpeg.py`` for one-component frames (the same pixels)."""
    try:
        import cv2
    except ImportError:
        from medical_image_segmentation_tpu_torch.utils.jpeg import JpegError, decode_jpeg_numpy

        try:
            return decode_jpeg_numpy(data)
        except JpegError as e:
            raise CodecError(f"JPEG baseline decode failed: {e}") from e
    arr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    if arr is None:
        raise CodecError("JPEG baseline decode failed")
    if arr.ndim == 3 and arr.shape[-1] == 3:
        arr = cv2.cvtColor(arr, cv2.COLOR_BGR2RGB)
    return arr
