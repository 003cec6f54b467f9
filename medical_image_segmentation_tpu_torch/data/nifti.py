"""Minimal NIfTI-1 reader/writer (pure Python + NumPy, no nibabel).

The port's own copy of the JAX package's ``data/nifti.py`` (the port imports
nothing of that package). It implements the NIfTI-1 standard header
(348 bytes + vox_offset) for the cases the Medical Decathlon ships:
.nii / .nii.gz, little-endian, scalar dtypes, 3-D/4-D volumes, with
scl_slope/scl_inter scaling applied by ``get_fdata`` semantics.
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass
from typing import Tuple

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclass
class NiftiFile:
    data: np.ndarray          # raw stored array (x, y, z[, t])
    scl_slope: float = 1.0
    scl_inter: float = 0.0
    pixdim: Tuple[float, ...] = (1.0, 1.0, 1.0)

    def get_fdata(self) -> np.ndarray:
        """float64 volume with slope/inter applied (nibabel semantics)."""
        out = self.data.astype(np.float64)
        slope = self.scl_slope if self.scl_slope not in (0.0,) else 1.0
        if slope != 1.0 or self.scl_inter != 0.0:
            out = out * slope + self.scl_inter
        return out

    @property
    def shape(self):
        return self.data.shape


def read_nifti(path: str) -> NiftiFile:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()
    if len(raw) < 352:
        raise ValueError(f"{path}: too small for a NIfTI-1 header")
    (sizeof_hdr,) = struct.unpack("<i", raw[0:4])
    if sizeof_hdr != 348:
        raise ValueError(f"{path}: not little-endian NIfTI-1 (sizeof_hdr={sizeof_hdr})")
    magic = raw[344:348]
    if magic[:3] not in (b"n+1", b"ni1"):
        raise ValueError(f"{path}: bad magic {magic!r}")
    dim = struct.unpack("<8h", raw[40:56])
    ndim = dim[0]
    if not 1 <= ndim <= 7:
        raise ValueError(f"{path}: bad ndim {ndim}")
    shape = tuple(max(1, d) for d in dim[1 : 1 + ndim])
    (datatype,) = struct.unpack("<h", raw[70:72])
    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported datatype code {datatype}")
    dtype = np.dtype(_DTYPES[datatype])
    pixdim = struct.unpack("<8f", raw[76:108])[1 : 1 + ndim]
    (vox_offset,) = struct.unpack("<f", raw[108:112])
    scl_slope, scl_inter = struct.unpack("<2f", raw[112:120])
    n = int(np.prod(shape))
    start = int(vox_offset) if vox_offset else 352
    data = np.frombuffer(raw, dtype=dtype, count=n, offset=start)
    # NIfTI data is Fortran-ordered (x fastest)
    data = data.reshape(shape, order="F")
    return NiftiFile(data=data, scl_slope=float(scl_slope), scl_inter=float(scl_inter), pixdim=tuple(pixdim))


def write_nifti(path: str, data: np.ndarray, scl_slope: float = 1.0, scl_inter: float = 0.0) -> None:
    """Write a minimal little-endian NIfTI-1 file (used by tests and tools)."""
    data = np.asarray(data)
    if data.dtype not in _CODES:
        raise ValueError(f"unsupported dtype {data.dtype}")
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    dim = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, _CODES[data.dtype])
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)  # bitpix
    struct.pack_into("<8f", hdr, 76, 1.0, *([1.0] * 7))
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<2f", hdr, 112, scl_slope, scl_inter)
    hdr_bytes = bytes(hdr[:344]) + b"n+1\x00"
    payload = hdr_bytes + b"\x00\x00\x00\x00" + data.tobytes(order="F")
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(payload)
