"""ctypes binding + on-demand build of the port's C++ MIS loader.

The shared object is compiled once per machine from the port's own
``csrc/`` (``mis_loader.cpp`` with its JPEG and PNG decoders, and the
DICOM, JPEG-LS and JPEG 2000 codecs) with ``g++`` alone: it links no codec
library, so it builds wherever a C++17 compiler is. It goes to
``build/native/`` under a name of its own and a digest of its sources, and
loads with ctypes' default ``RTLD_LOCAL``, so it can share a process with
the JAX package's library, which exports the same symbols. Callers fall
back to the pure-Python ``StoreReader`` when the build fails, after a line
on stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
import time
from typing import Optional

import numpy as np

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_BUILD_FAILED = False
_BUILD: dict = {}

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_REPO_ROOT = os.path.dirname(_PKG_DIR)
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
_SRCS = [os.path.join(CSRC_DIR, name) for name in (
    "mis_loader.cpp", "jpeg_decode.cpp", "png_decode.cpp",
    "dicom_codecs.cpp", "jpegls_codec.cpp", "j2k_codec.cpp",
)]
_HEADERS = [os.path.join(CSRC_DIR, "image_codecs.h")]

# the loader's return codes (csrc/mis_loader.cpp, csrc/image_codecs.h): the
# reference reader's, then the streams the port's decoders name and refuse
ERRORS = {
    -1: "corrupt or truncated payload",
    -2: "index out of range",
    -3: "wrong codec or channel count",
    -4: "record offset past the end of the store",
    -5: "raw payload shorter than its record",
    -6: "payload of zero height or width",
    -7: "bad fetch arguments",
    -8: "payload precision or format does not match the store",
    -9: "corrupt JPEG-LS payload",
    -10: "store dtype does not match the call",
    -11: "progressive JPEG",
    -12: "arithmetic-coded, lossless or hierarchical JPEG",
    -13: "JPEG of other than 8-bit samples",
    -14: "JPEG component layout not carried (RGB colour space, several scans, or chroma "
         "sampling other than 1x1, 2x1, 1x2, 2x2)",
    -15: "PNG colour management not carried (cHRM, or a stated gamma on 16-bit RGB read as gray)",
}
UNSUPPORTED = (-11, -12, -13, -14, -15)


class NativeUnsupported(IOError):
    """A well-formed payload the port's native decoders do not carry (the
    reference reader decodes it through libjpeg or libpng); ``code`` is the
    loader's return code."""

    def __init__(self, call: str, code: int):
        super().__init__(f"{call} error {code}: {ERRORS[code]}")
        self.code = code


def check_rc(call: str, rc: int) -> None:
    """Raise on a nonzero loader return code: ``NativeUnsupported`` by name
    for the payloads the decoders refuse, IOError for the rest."""
    if rc in UNSUPPORTED:
        raise NativeUnsupported(call, rc)
    if rc != 0:
        raise IOError(f"{call} error {rc}: {ERRORS.get(rc, 'unknown error')}")


def _cache_dir() -> str:
    d = os.environ.get("MIS_NATIVE_CACHE", os.path.join(_REPO_ROOT, "build", "native"))
    os.makedirs(d, exist_ok=True)
    return d


def build_command(out: str) -> list:
    """The one compiler call that builds the library: the port's sources,
    no library beyond the C++ runtime and pthread."""
    return ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", *_SRCS, "-pthread", "-o", out]


def build_info() -> dict:
    """How this process got the library: ``path``, ``command`` and
    ``seconds`` (None when an earlier build was reused); empty before
    ``get_lib``."""
    return dict(_BUILD)


def _build() -> Optional[str]:
    h = hashlib.sha256()
    for src in _SRCS + _HEADERS:
        with open(src, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    out = os.path.join(_cache_dir(), f"libmisloader-torch-{digest}.so")
    if os.path.exists(out):
        _BUILD.update(path=out, command=build_command(out), seconds=None)
        return out
    tmp = f"{out}.{os.getpid()}.tmp"  # pid-unique: concurrent builders must
    # not interleave writes into one -o target before the atomic publish
    cmd = build_command(tmp)
    t0 = time.time()
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except (subprocess.SubprocessError, FileNotFoundError) as e:
        stderr = getattr(e, "stderr", b"") or b""
        print(f"mis_loader native build failed: {e}\n{stderr.decode()[:2000]}", file=sys.stderr)
        return None
    os.replace(tmp, out)
    _BUILD.update(path=out, command=build_command(out), seconds=time.time() - t0)
    return out


def get_lib() -> Optional[ctypes.CDLL]:
    """Build (once) and load the native loader; None if unavailable."""
    global _LIB, _BUILD_FAILED
    with _LOCK:
        if _LIB is not None or _BUILD_FAILED:
            return _LIB
        so = _build()
        if so is None:
            _BUILD_FAILED = True
            return None
        lib = ctypes.CDLL(so)
        lib.mis_open.restype = ctypes.c_void_p
        lib.mis_open.argtypes = [ctypes.c_char_p]
        lib.mis_close.argtypes = [ctypes.c_void_p]
        lib.mis_num_samples.restype = ctypes.c_int64
        lib.mis_num_samples.argtypes = [ctypes.c_void_p]
        lib.mis_shape.argtypes = [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_int)] * 3
        lib.mis_fetch.restype = ctypes.c_int
        lib.mis_fetch.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ]
        lib.mis_fetch_views.restype = ctypes.c_int
        lib.mis_fetch_views.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ]
        # uint16-store variants (header FLAG_U16): same contracts, u16 buffers
        lib.mis_sample_u16.restype = ctypes.c_int
        lib.mis_sample_u16.argtypes = [ctypes.c_void_p]
        lib.mis_fetch_u16.restype = ctypes.c_int
        lib.mis_fetch_u16.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint16),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ]
        lib.mis_fetch_views_u16.restype = ctypes.c_int
        lib.mis_fetch_views_u16.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint16),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ]
        # compressed-DICOM codecs (csrc/dicom_codecs.cpp of this package)
        lib.jls_probe.restype = ctypes.c_int
        lib.jls_probe.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.jls_decode.restype = ctypes.c_int
        lib.jls_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint16), ctypes.c_int64,
        ]
        # JPEG-LS T.87 codec (csrc/jpegls_codec.cpp)
        lib.jpegls_probe.restype = ctypes.c_int
        lib.jpegls_probe.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.jpegls_decode.restype = ctypes.c_int
        lib.jpegls_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint16), ctypes.c_int64,
        ]
        # row-limited decode (crop-at-decode for JLS; bit-identical prefix)
        lib.jpegls_decode_rows.restype = ctypes.c_int
        lib.jpegls_decode_rows.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint16), ctypes.c_int64, ctypes.c_int,
        ]
        lib.jpegls_encode.restype = ctypes.c_int
        lib.jpegls_encode.argtypes = [
            ctypes.POINTER(ctypes.c_uint16),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        # JPEG 2000 T.800 codec (csrc/j2k_codec.cpp)
        lib.j2k_probe.restype = ctypes.c_int
        lib.j2k_probe.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.j2k_decode.restype = ctypes.c_int
        lib.j2k_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ]
        _LIB = lib
        return _LIB


class NativeStore:
    """Thin RAII wrapper over the C++ store handle."""

    def __init__(self, path: str):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native loader unavailable")
        self._lib = lib
        self._handle = lib.mis_open(path.encode())
        if not self._handle:
            raise IOError(f"mis_open failed for {path}")
        h = ctypes.c_int()
        w = ctypes.c_int()
        c = ctypes.c_int()
        lib.mis_shape(self._handle, ctypes.byref(h), ctypes.byref(w), ctypes.byref(c))
        self.shape = (h.value, w.value, c.value)
        self.num_samples = int(lib.mis_num_samples(self._handle))
        self.dtype = np.dtype(np.uint16 if lib.mis_sample_u16(self._handle) else np.uint8)

    def fetch(
        self,
        indices: np.ndarray,
        out: Optional[np.ndarray] = None,
        labels: Optional[np.ndarray] = None,
        out_hw: Optional[tuple] = None,
        num_threads: int = 4,
    ):
        """Decode ``indices`` into (B, H, W, C) samples (store dtype: uint8,
        or uint16 for FLAG_U16 stores) + (B,) int32 labels."""
        indices = np.ascontiguousarray(indices, np.int64)
        n = len(indices)
        oh, ow = out_hw or self.shape[:2]
        oc = self.shape[2]
        if out is None:
            out = np.empty((n, oh, ow, oc), self.dtype)
        if labels is None:
            labels = np.empty((n,), np.int32)
        if self.dtype == np.uint16:
            fn = self._lib.mis_fetch_u16
            out_ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16))
        else:
            fn = self._lib.mis_fetch
            out_ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        rc = fn(
            self._handle,
            indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
            out_ptr,
            oh, ow, oc,
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            num_threads,
        )
        check_rc("mis_fetch", rc)
        return out, labels

    def fetch_views(
        self,
        indices: np.ndarray,
        params: np.ndarray,
        out_hw: tuple,
        out: Optional[np.ndarray] = None,
        labels: Optional[np.ndarray] = None,
        num_threads: int = 4,
    ):
        """Host-side RandomResizedCrop fast path: decode each sample once and
        emit V bilinear crop-resized views, SAMPLE-major.

        ``params`` is float32 (B, V, 5) = (y0, x0, crop_h, crop_w, flip) per
        view in source-pixel coordinates (same convention as
        ``ops.augment._resize_matrix``). Returns ((B*V, vh, vw, C) uint8,
        (B,) int32) — SAMPLE-major: view v of sample i lives at row
        ``i*V + v``, so per-host shards concatenate into a correct global
        batch and the on-device (B, V, ...) reshape/split is shard-local
        (see the layout note in csrc/mis_loader.cpp::mis_fetch_views).
        """
        indices = np.ascontiguousarray(indices, np.int64)
        n = len(indices)
        params = np.ascontiguousarray(params, np.float32)
        if params.shape[0] != n or params.shape[-1] != 5:
            raise ValueError(f"params must be (B, V, 5); got {params.shape}")
        views = int(params.shape[1]) if params.ndim == 3 else 1
        vh, vw = out_hw
        oc = self.shape[2]
        if out is None:
            out = np.empty((n * views, vh, vw, oc), self.dtype)
        if labels is None:
            labels = np.empty((n,), np.int32)
        if self.dtype == np.uint16:
            fn = self._lib.mis_fetch_views_u16
            out_ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16))
        else:
            fn = self._lib.mis_fetch_views
            out_ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        rc = fn(
            self._handle,
            indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
            params.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), views,
            out_ptr,
            vh, vw, oc,
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            num_threads,
        )
        check_rc("mis_fetch_views", rc)
        return out, labels

    def close(self):
        if self._handle:
            self._lib.mis_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
