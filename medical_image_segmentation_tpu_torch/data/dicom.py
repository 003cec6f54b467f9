"""Minimal, fast DICOM reader (pure Python + NumPy — no pydicom).

The reference consumes DICOM through `pydicom.dcmread(...).pixel_array`
(`medical_image_segmentation/analyze_data/create_subset.py:197,506`;
`create_ffcv_subset.py:44`) with GDCM/pylibjpeg plugins for compressed pixel
data (`docker/Dockerfile:34-35`). This module provides the subset of that
capability the ingest pipeline needs, implemented from the DICOM PS3.10/3.5
encoding rules:

- Part 10 file meta (128-byte preamble + "DICM" + group-0002 elements);
- implicit VR little endian (1.2.840.10008.1.2) and explicit VR little
  endian (1.2.840.10008.1.2.1) datasets, including undefined-length
  sequences/items (skipped — we only materialize the elements we need);
- header-only scanning (``stop_before_pixels=True`` — the fast path the
  reference uses for its dimension scan, `create_subset.py:459-463`);
- ``pixel_array`` for uncompressed pixel data: 8/16-bit, signed/unsigned,
  single- or multi-frame, grayscale or RGB, with MONOCHROME1 left to the
  caller (parity: pydicom also does not invert);
- **compressed pixel data** (encapsulated PS3.5 §A.4: basic offset table +
  fragments) for RLE Lossless (1.2.840.10008.1.2.5), JPEG Baseline
  (.4.50), JPEG Lossless (.4.57/.4.70) via `data/dicom_codecs.py`,
  JPEG-LS (.4.80/.4.81) via `data/jpegls.py`, and JPEG 2000 (.4.90/.4.91)
  via `data/jpeg2000.py` — each with a C++ fast path and a pure-Python
  reference decoder;
- **deflated explicit VR LE** (1.2.840.10008.1.2.1.99, PS3.5 A.5):
  whole-stream raw-deflate inflation before dataset parsing.
  Header-only scans work for EVERY transfer syntax. Still-unsupported
  codecs (JPEG extended 12-bit, MPEG, HTJ2K) fall back to pydicom when it
  is installed, else raise ``UnsupportedTransferSyntax`` — a per-file error
  status in the ingest tools rather than a crash (matching the reference's
  per-file fault tolerance, `create_subset.py:197-241`).

A copy of the JAX package's ``data/dicom.py`` for the port's readers and
writers. Baseline JPEG frames go through OpenCV where it imports and
otherwise through ``utils/jpeg.py`` (one component); lossy JPEG 2000 needs
PIL, JPEG 2000 lossless uses ``data/jpeg2000_encode.py``.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import BinaryIO, Dict, Optional, Tuple, Union

import numpy as np

IMPLICIT_VR_LE = "1.2.840.10008.1.2"
EXPLICIT_VR_LE = "1.2.840.10008.1.2.1"
EXPLICIT_VR_BE = "1.2.840.10008.1.2.2"
DEFLATED_VR_LE = "1.2.840.10008.1.2.1.99"
JPEG_BASELINE = "1.2.840.10008.1.2.4.50"
JPEG_LOSSLESS = "1.2.840.10008.1.2.4.57"
JPEG_LOSSLESS_SV1 = "1.2.840.10008.1.2.4.70"
JPEG_LS_LOSSLESS = "1.2.840.10008.1.2.4.80"
JPEG_LS_NEAR_LOSSLESS = "1.2.840.10008.1.2.4.81"
JPEG_2000_LOSSLESS = "1.2.840.10008.1.2.4.90"
JPEG_2000 = "1.2.840.10008.1.2.4.91"
RLE_LOSSLESS = "1.2.840.10008.1.2.5"

# encapsulated syntaxes we decode natively
# (data/dicom_codecs.py, data/jpegls.py, data/jpeg2000.py)
_NATIVE_CODECS = {
    JPEG_BASELINE, JPEG_LOSSLESS, JPEG_LOSSLESS_SV1,
    JPEG_LS_LOSSLESS, JPEG_LS_NEAR_LOSSLESS,
    JPEG_2000_LOSSLESS, JPEG_2000, RLE_LOSSLESS,
}

# VRs that use the 12-byte (2 reserved + 4-byte length) explicit header
_LONG_VRS = {b"OB", b"OW", b"OF", b"OD", b"OL", b"OV", b"SQ", b"UC", b"UR", b"UT", b"UN"}

# tags we materialize: (group, element) → name
_KEEP = {
    (0x0008, 0x0018): "sop_instance_uid",
    (0x0008, 0x0060): "modality",
    (0x0010, 0x0020): "patient_id",
    (0x0020, 0x000D): "study_uid",
    (0x0020, 0x000E): "series_uid",
    (0x0028, 0x0002): "samples_per_pixel",
    (0x0028, 0x0004): "photometric_interpretation",
    (0x0028, 0x0008): "number_of_frames",
    (0x0028, 0x0010): "rows",
    (0x0028, 0x0011): "columns",
    (0x0028, 0x0100): "bits_allocated",
    (0x0028, 0x0101): "bits_stored",
    (0x0028, 0x0103): "pixel_representation",
    (0x0028, 0x1052): "rescale_intercept",
    (0x0028, 0x1053): "rescale_slope",
}
_PIXEL_DATA = (0x7FE0, 0x0010)
_US_TAGS = {"rows", "columns", "bits_allocated", "bits_stored", "pixel_representation", "samples_per_pixel"}


class DicomError(ValueError):
    pass


class UnsupportedTransferSyntax(DicomError):
    pass


@dataclass
class DicomFile:
    transfer_syntax: str = EXPLICIT_VR_LE
    elements: Dict[str, Union[int, float, str]] = field(default_factory=dict)
    pixel_bytes: Optional[bytes] = None
    # encapsulated (compressed) pixel data: per-fragment byte strings + the
    # basic offset table (PS3.5 §A.4); None for uncompressed syntaxes
    pixel_fragments: Optional[list] = None
    basic_offset_table: Optional[Tuple[int, ...]] = None
    source_path: Optional[str] = None

    @property
    def rows(self) -> int:
        return int(self.elements.get("rows", 0))

    @property
    def columns(self) -> int:
        return int(self.elements.get("columns", 0))

    def _frame_chunks(self) -> list:
        """Group fragments into per-frame byte strings: single frame → all
        fragments concatenated; else 1:1 when counts match; else split by the
        basic offset table (offsets point at fragment item headers, relative
        to the first byte after the BOT item)."""
        frames = int(self.elements.get("number_of_frames", 1) or 1)
        frags = self.pixel_fragments
        if frames == 1:
            return [b"".join(frags)]
        if len(frags) == frames:
            return list(frags)
        bot = self.basic_offset_table
        if not bot or len(bot) != frames:
            raise DicomError(
                f"cannot map {len(frags)} fragments to {frames} frames without an offset table"
            )
        frag_offsets = []
        pos = 0
        for fr in frags:
            frag_offsets.append(pos)
            pos += 8 + len(fr)  # 8-byte item header precedes each fragment
        out = []
        for k in range(frames):
            end = bot[k + 1] if k + 1 < frames else pos + 1
            out.append(b"".join(
                fr for off, fr in zip(frag_offsets, frags) if bot[k] <= off < end
            ))
        return out

    def _decode_frame(self, data: bytes) -> np.ndarray:
        from medical_image_segmentation_tpu_torch.data import dicom_codecs as codecs

        ts = self.transfer_syntax
        bits = int(self.elements.get("bits_allocated", 16))
        samples = int(self.elements.get("samples_per_pixel", 1))
        if ts == RLE_LOSSLESS:
            arr = codecs.rle_decode(data, self.rows, self.columns, bits, samples)
        elif ts in (JPEG_LOSSLESS, JPEG_LOSSLESS_SV1):
            arr = codecs.jpeg_lossless_decode(data)
        elif ts in (JPEG_LS_LOSSLESS, JPEG_LS_NEAR_LOSSLESS):
            from medical_image_segmentation_tpu_torch.data.jpegls import jpeg_ls_decode

            arr = jpeg_ls_decode(data)
        elif ts in (JPEG_2000_LOSSLESS, JPEG_2000):
            from medical_image_segmentation_tpu_torch.data.jpeg2000 import j2k_decode

            arr = j2k_decode(data)
        elif ts == JPEG_BASELINE:
            arr = codecs.jpeg_baseline_decode(data)
        else:  # pragma: no cover — guarded by _NATIVE_CODECS check
            raise UnsupportedTransferSyntax(ts)
        if arr.shape[:2] != (self.rows, self.columns):
            raise DicomError(
                f"decoded frame {arr.shape} != header ({self.rows}, {self.columns})"
            )
        if int(self.elements.get("pixel_representation", 0)) == 1:
            arr = arr.astype({8: np.int8, 16: np.int16}.get(bits, np.int16))
        elif bits == 8 and arr.dtype != np.uint8:
            arr = arr.astype(np.uint8)
        return arr

    def _pydicom_fallback(self) -> Optional[np.ndarray]:
        """Last resort for the rare syntaxes we don't decode natively
        (JPEG extended 12-bit, MPEG, HTJ2K): pydicom + its codec plugins,
        when installed. Every common TCIA syntax (RLE, JPEG baseline/
        lossless, JPEG-LS, JPEG 2000) decodes natively without this."""
        if self.source_path is None:
            return None
        try:
            import pydicom
        except ImportError:
            return None
        # Classify by CAPABILITY, not by exception message: probe whether
        # pydicom has an available handler for this syntax first. If it
        # does, any failure below is a real decode error and must surface
        # as DicomError so per-file ingest statuses record the true cause;
        # if it doesn't, the caller raises UnsupportedTransferSyntax.
        # (Message matching misclassified decode errors that merely
        # mentioned "handler"/"plugin" in their text.)
        can_decode = True
        try:
            from pydicom.uid import UID

            uid = UID(self.transfer_syntax)
            handlers = getattr(pydicom.config, "pixel_data_handlers", None)
            if handlers is not None:
                can_decode = any(
                    h.is_available() and h.supports_transfer_syntax(uid)
                    for h in handlers
                )
        except Exception:
            pass  # introspection API drift: attempt the decode anyway
        if not can_decode:
            return None
        try:
            return pydicom.dcmread(self.source_path).pixel_array
        except (ImportError, NotImplementedError):
            return None  # handler advertised support but can't run here
        except Exception as e:
            raise DicomError(f"pydicom fallback decode failed: {e}") from e

    @property
    def pixel_array(self) -> np.ndarray:
        """Decode pixel data, pydicom-shaped:
        (rows, cols), (frames, rows, cols), or (..., samples)."""
        if self.pixel_fragments is not None:
            if self.transfer_syntax not in _NATIVE_CODECS:
                arr = self._pydicom_fallback()
                if arr is not None:
                    return arr
                raise UnsupportedTransferSyntax(self.transfer_syntax)
            decoded = [self._decode_frame(d) for d in self._frame_chunks()]
            return decoded[0] if len(decoded) == 1 else np.stack(decoded)
        if self.pixel_bytes is None:
            raise DicomError("no pixel data read (header-only parse?)")
        bits = int(self.elements.get("bits_allocated", 16))
        signed = int(self.elements.get("pixel_representation", 0)) == 1
        samples = int(self.elements.get("samples_per_pixel", 1))
        frames = int(self.elements.get("number_of_frames", 1) or 1)
        rows, cols = self.rows, self.columns
        if bits == 8:
            dtype = np.int8 if signed else np.uint8
        elif bits == 16:
            dtype = np.int16 if signed else np.uint16
        elif bits == 32:
            dtype = np.int32 if signed else np.uint32
        else:
            raise DicomError(f"unsupported bits_allocated={bits}")
        n = frames * rows * cols * samples
        arr = np.frombuffer(self.pixel_bytes, dtype=dtype, count=n)
        shape = [frames, rows, cols, samples]
        arr = arr.reshape(shape)
        if samples == 1:
            arr = arr[..., 0]
        if frames == 1:
            arr = arr[0]
        return arr


def _read_exact(f: BinaryIO, n: int) -> bytes:
    b = f.read(n)
    if len(b) != n:
        raise DicomError(f"truncated file (wanted {n} bytes, got {len(b)})")
    return b


def _parse_meta(f: BinaryIO) -> str:
    """Parse the group-0002 file meta (always explicit VR LE); return the
    dataset transfer syntax UID."""
    head = f.read(132)
    if len(head) == 132 and head[128:132] == b"DICM":
        pass  # standard part-10 file
    else:
        # some files omit the preamble; rewind and try bare dataset
        f.seek(0)
        return ""
    ts = ""
    while True:
        pos = f.tell()
        hdr = f.read(8)
        if len(hdr) < 8:
            break
        group, elem, vr = struct.unpack("<HH2s", hdr[:6])
        if group != 0x0002:
            f.seek(pos)
            break
        if vr in _LONG_VRS:
            (length,) = struct.unpack("<I", _read_exact(f, 4))
        else:
            (length,) = struct.unpack("<H", hdr[6:8])
        value = _read_exact(f, length)
        if (group, elem) == (0x0002, 0x0010):
            ts = value.decode("ascii").rstrip("\x00 ")
    return ts


def _skip_undefined_sequence(f: BinaryIO, explicit: bool) -> None:
    """Skip an undefined-length SQ: walk items until the sequence
    delimitation item (FFFE,E0DD)."""
    while True:
        group, elem = struct.unpack("<HH", _read_exact(f, 4))
        (length,) = struct.unpack("<I", _read_exact(f, 4))
        if (group, elem) == (0xFFFE, 0xE0DD):
            return
        if (group, elem) != (0xFFFE, 0xE000):
            raise DicomError(f"malformed sequence item tag ({group:04x},{elem:04x})")
        if length == 0xFFFFFFFF:
            _skip_undefined_item(f, explicit)
        else:
            f.seek(length, 1)


def _skip_undefined_item(f: BinaryIO, explicit: bool) -> None:
    """Skip an undefined-length item: nested element walk until (FFFE,E00D)."""
    while True:
        group, elem = struct.unpack("<HH", _read_exact(f, 4))
        if (group, elem) == (0xFFFE, 0xE00D):
            f.seek(4, 1)  # zero length
            return
        vr, length = _read_element_header(f, explicit)
        if length == 0xFFFFFFFF:
            if vr == b"SQ" or not explicit:
                _skip_undefined_sequence(f, explicit)
            else:
                raise DicomError("undefined length on non-SQ element in item")
        else:
            f.seek(length, 1)


def _read_element_header(f: BinaryIO, explicit: bool) -> Tuple[bytes, int]:
    """Read VR+length (tag already consumed)."""
    if explicit:
        vr = _read_exact(f, 2)
        if vr in _LONG_VRS:
            _read_exact(f, 2)  # reserved
            (length,) = struct.unpack("<I", _read_exact(f, 4))
        else:
            (length,) = struct.unpack("<H", _read_exact(f, 2))
        return vr, length
    (length,) = struct.unpack("<I", _read_exact(f, 4))
    return b"", length


def _decode_value(name: str, vr: bytes, raw: bytes, explicit: bool):
    if name in _US_TAGS:
        # US (2-byte little-endian unsigned), same bytes under implicit VR
        if len(raw) >= 2:
            return struct.unpack("<H", raw[:2])[0]
        return 0
    text = raw.decode("latin-1").rstrip("\x00 ").strip()
    if name in ("rescale_intercept", "rescale_slope"):
        try:
            return float(text)
        except ValueError:
            return 1.0 if name == "rescale_slope" else 0.0
    if name == "number_of_frames":
        try:
            return int(text)
        except ValueError:
            return 1
    return text


def _read_encapsulated(f: BinaryIO):
    """Parse encapsulated pixel data (PS3.5 §A.4): first item = basic offset
    table, remaining items = fragments, terminated by (FFFE,E0DD)."""
    bot: Optional[Tuple[int, ...]] = None
    frags = []
    first = True
    while True:
        group, elem = struct.unpack("<HH", _read_exact(f, 4))
        (length,) = struct.unpack("<I", _read_exact(f, 4))
        if (group, elem) == (0xFFFE, 0xE0DD):
            if length:
                f.seek(length, 1)
            return bot, frags
        if (group, elem) != (0xFFFE, 0xE000):
            raise DicomError(f"malformed encapsulated item tag ({group:04x},{elem:04x})")
        data = _read_exact(f, length)
        if first:
            first = False
            if length:
                bot = struct.unpack(f"<{length // 4}I", data)
        else:
            frags.append(data)


def read_dicom(
    path_or_file: Union[str, BinaryIO],
    stop_before_pixels: bool = False,
) -> DicomFile:
    """Parse a DICOM file.

    ``stop_before_pixels=True`` is the header-only fast path used by the
    dimension/hash scans (reference `create_subset.py:459-463`) — it works
    for every transfer syntax, compressed included."""
    if isinstance(path_or_file, str):
        with open(path_or_file, "rb") as f:
            out = read_dicom(f, stop_before_pixels)
            out.source_path = path_or_file
            return out
    f = path_or_file
    ts = _parse_meta(f)
    if ts in ("", IMPLICIT_VR_LE):
        explicit = ts == ""  # bare datasets here are written explicit by us; sniff below
    elif ts == DEFLATED_VR_LE:
        # PS3.5 A.5: everything after the meta group is one raw-deflate
        # stream of an explicit-VR-LE dataset. Whole-stream inflation (the
        # same strategy pydicom uses); header scans pay it too, but deflated
        # files are rare and small in practice.
        import io as _io
        import zlib

        try:
            inflated = zlib.decompress(f.read(), -15)
        except zlib.error as e:
            raise DicomError(f"deflated dataset inflate failed: {e}") from e
        f = _io.BytesIO(inflated)
        explicit = True
    elif ts == EXPLICIT_VR_BE:
        # big-endian retired (PS3.5 2016b); absent from TCIA archives
        raise UnsupportedTransferSyntax(ts)
    else:
        # explicit LE and ALL encapsulated syntaxes (1.2.840.10008.1.2.4.*/.5)
        # use explicit VR LE dataset encoding; parse proceeds for every one —
        # codec support is decided at pixel_array time, not here
        explicit = True

    if ts == IMPLICIT_VR_LE:
        explicit = False
    elif ts == "":
        # no meta: sniff — explicit files have an uppercase-ASCII VR at byte 4
        pos = f.tell()
        probe = f.read(6)
        f.seek(pos)
        explicit = len(probe) == 6 and probe[4:6].isalpha() and probe[4:6].isupper()

    out = DicomFile(transfer_syntax=ts or (EXPLICIT_VR_LE if explicit else IMPLICIT_VR_LE))
    while True:
        hdr = f.read(4)
        if len(hdr) < 4:
            break
        group, elem = struct.unpack("<HH", hdr)
        vr, length = _read_element_header(f, explicit)
        tag = (group, elem)

        if tag == _PIXEL_DATA:
            if stop_before_pixels:
                break
            if length == 0xFFFFFFFF:
                out.basic_offset_table, out.pixel_fragments = _read_encapsulated(f)
            else:
                out.pixel_bytes = _read_exact(f, length)
            break

        if length == 0xFFFFFFFF:
            _skip_undefined_sequence(f, explicit)
            continue

        name = _KEEP.get(tag)
        if name is not None:
            raw = _read_exact(f, length)
            out.elements[name] = _decode_value(name, vr, raw, explicit)
        else:
            f.seek(length, 1)
    return out


def get_dimensions(path: str) -> Tuple[int, int]:
    """(rows, columns) via the header-only fast path."""
    d = read_dicom(path, stop_before_pixels=True)
    return d.rows, d.columns


# ---------------------------------------------------------------------------
# Writer (tests + synthetic-data tooling)
# ---------------------------------------------------------------------------

def _enc_element(group: int, elem: int, vr: bytes, value: bytes, explicit: bool) -> bytes:
    if len(value) % 2:
        value += b"\x00" if vr not in (b"US", b"OW", b"OB") else b"\x00"
    if not explicit:
        return struct.pack("<HHI", group, elem, len(value)) + value
    if vr in _LONG_VRS:
        return struct.pack("<HH2sHI", group, elem, vr, 0, len(value)) + value
    return struct.pack("<HH2sH", group, elem, vr, len(value)) + value


def write_dicom(
    path: str,
    pixels: np.ndarray,
    explicit: bool = True,
    extra_elements: Optional[Dict[Tuple[int, int], Tuple[bytes, bytes]]] = None,
    sop_instance_uid: str = "1.2.3.4",
    transfer_syntax: Optional[str] = None,
) -> None:
    """Write a little-endian part-10 DICOM file.

    ``pixels``: (rows, cols) or (frames, rows, cols) of uint8/uint16/int16.
    ``extra_elements``: {(group, elem): (vr, raw_bytes)} appended in order.
    ``transfer_syntax``: uncompressed LE by default; RLE_LOSSLESS,
    JPEG_LOSSLESS(_SV1), JPEG_LS(_NEAR)_LOSSLESS, JPEG_2000(_LOSSLESS) and
    JPEG_BASELINE produce encapsulated compressed pixel data;
    DEFLATED_VR_LE writes the dataset as one raw-deflate stream (PS3.5 A.5).
    Fixture/tooling path for the compressed-ingest support.
    """
    pixels = np.asarray(pixels)
    frames = 1
    if pixels.ndim == 3:
        frames, rows, cols = pixels.shape
    else:
        rows, cols = pixels.shape
    bits = pixels.dtype.itemsize * 8
    signed = 1 if pixels.dtype in (np.dtype(np.int8), np.dtype(np.int16)) else 0

    ts = transfer_syntax or (EXPLICIT_VR_LE if explicit else IMPLICIT_VR_LE)
    meta_body = b""
    meta_body += _enc_element(0x0002, 0x0010, b"UI", ts.encode() + (b"\x00" if len(ts) % 2 else b""), True)
    # (0002,0000) group length
    meta = _enc_element(0x0002, 0x0000, b"UL", struct.pack("<I", len(meta_body)), True) + meta_body

    body = b""
    body += _enc_element(0x0008, 0x0018, b"UI", sop_instance_uid.encode(), explicit)
    if frames > 1:
        body += _enc_element(0x0028, 0x0008, b"IS", str(frames).encode(), explicit)
    body += _enc_element(0x0028, 0x0002, b"US", struct.pack("<H", 1), explicit)
    body += _enc_element(0x0028, 0x0004, b"CS", b"MONOCHROME2", explicit)
    body += _enc_element(0x0028, 0x0010, b"US", struct.pack("<H", rows), explicit)
    body += _enc_element(0x0028, 0x0011, b"US", struct.pack("<H", cols), explicit)
    body += _enc_element(0x0028, 0x0100, b"US", struct.pack("<H", bits), explicit)
    body += _enc_element(0x0028, 0x0101, b"US", struct.pack("<H", bits), explicit)
    body += _enc_element(0x0028, 0x0103, b"US", struct.pack("<H", signed), explicit)
    for (g, e), (vr, raw) in (extra_elements or {}).items():
        body += _enc_element(g, e, vr, raw, explicit)

    if ts in _NATIVE_CODECS:
        if not explicit:
            raise DicomError("encapsulated pixel data requires explicit VR")
        from medical_image_segmentation_tpu_torch.data import dicom_codecs as codecs

        frame_list = pixels if pixels.ndim == 3 else pixels[None]
        frags = []
        for fr in frame_list:
            if ts == RLE_LOSSLESS:
                payload = codecs.rle_encode(fr)
            elif ts in (JPEG_LOSSLESS, JPEG_LOSSLESS_SV1):
                payload = codecs.jpeg_lossless_encode(
                    fr.astype(np.uint16), precision=bits, predictor=1)
            elif ts in (JPEG_LS_LOSSLESS, JPEG_LS_NEAR_LOSSLESS):
                from medical_image_segmentation_tpu_torch.data.jpegls import jpeg_ls_encode

                payload = jpeg_ls_encode(
                    fr, near=0 if ts == JPEG_LS_LOSSLESS else 2, precision=bits)
            elif ts == JPEG_2000_LOSSLESS:
                from medical_image_segmentation_tpu_torch.data.jpeg2000_encode import j2k_encode

                payload = j2k_encode(fr)
            elif ts == JPEG_2000:
                # lossy (.91) fixtures only: our encoder is lossless-profile
                # (reversible 5/3); use PIL/OpenJPEG's irreversible 9/7 here
                import io as _io

                try:
                    from PIL import Image as _PILImage
                except ImportError:
                    raise DicomError("writing lossy JPEG 2000 DICOM needs PIL (OpenJPEG), which is not "
                                     "installed; JPEG 2000 lossless needs nothing") from None

                buf = _io.BytesIO()
                try:
                    _PILImage.fromarray(fr).save(
                        buf, format="JPEG2000", no_jp2=True,
                        irreversible=True, quality_mode="rates",
                        quality_layers=[10])
                except Exception as e:
                    raise DicomError(f"JPEG 2000 encode failed: {e}") from e
                payload = buf.getvalue()
            else:  # JPEG_BASELINE: OpenCV's bytes, or the same bytes from utils/jpeg.py (gray)
                from medical_image_segmentation_tpu_torch.utils.jpeg import JpegError, encode_jpeg

                try:
                    payload = encode_jpeg(fr.astype(np.uint8), 95)
                except JpegError as e:
                    raise DicomError(f"baseline JPEG encode failed: {e}") from e
            if len(payload) % 2:
                payload += b"\x00"
            frags.append(payload)
        # basic offset table: per-frame offsets when multi-frame, empty else
        if len(frags) > 1:
            offs, pos = [], 0
            for fr_b in frags:
                offs.append(pos)
                pos += 8 + len(fr_b)
            bot = struct.pack(f"<{len(offs)}I", *offs)
        else:
            bot = b""
        value = struct.pack("<HHI", 0xFFFE, 0xE000, len(bot)) + bot
        for fr_b in frags:
            value += struct.pack("<HHI", 0xFFFE, 0xE000, len(fr_b)) + fr_b
        value += struct.pack("<HHI", 0xFFFE, 0xE0DD, 0)
        body += struct.pack("<HH2sHI", 0x7FE0, 0x0010, b"OB", 0, 0xFFFFFFFF) + value
    else:
        pix_vr = b"OB" if bits == 8 else b"OW"
        body += _enc_element(0x7FE0, 0x0010, pix_vr, pixels.tobytes(), explicit)

    if ts == DEFLATED_VR_LE:
        # PS3.5 A.5: meta group stays uncompressed; the dataset is one raw
        # deflate stream (explicit VR LE encoding)
        import zlib

        if not explicit:
            raise DicomError("deflated transfer syntax requires explicit VR")
        co = zlib.compressobj(9, zlib.DEFLATED, -15)
        body = co.compress(body) + co.flush()

    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM" + meta + body)
