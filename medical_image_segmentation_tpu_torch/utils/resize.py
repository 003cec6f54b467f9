"""Image resizing in numpy with the arithmetic of OpenCV and PIL.

The ingest CLIs and the Decathlon PNG loader resize with OpenCV
(``cv2.resize``: ``INTER_LINEAR`` and ``INTER_NEAREST`` for slices and
masks, ``INTER_AREA`` for store images) and with PIL (``Image.resize(...,
BICUBIC)`` on float32 DICOM pixels). ``resize`` and ``pil_bicubic`` call
those libraries where they import and otherwise compute the same result
here, to the pixel:

- ``INTER_LINEAR`` on uint8: OpenCV's fixed-point path, coefficients
  rounded to 11 bits (``INTER_RESIZE_COEF_BITS``), the horizontal pass in
  int32, the vertical pass as ``(((b0*(S0>>4))>>16) + ((b1*(S1>>4))>>16)
  + 2) >> 2``; an exact 2× downscale becomes ``INTER_AREA`` as in OpenCV;
- ``INTER_NEAREST``: source index ``floor(dst * (src/dst))``, clamped;
- ``INTER_AREA`` downscale on uint8 and uint16: at integer ratios the
  block mean (``(sum + 2) >> 2`` at 2×2, ``rint(sum * (1/area))`` in
  float32 otherwise); at other ratios OpenCV's area table, accumulated in
  float32 in its order and rounded half to even;
- PIL's BICUBIC on float32 (mode ``F``): a = -0.5, support 2 scaled by
  the downscale factor, float64 coefficients normalised per pixel, the
  horizontal pass first, each pass accumulated in float64 in tap order and
  stored as float32.

Anything else (another dtype, an ``INTER_AREA`` upscale) raises by name.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

INTER_RESIZE_COEF_BITS = 11
_COEF_SCALE = 1 << INTER_RESIZE_COEF_BITS
_DBL_EPSILON = float(np.finfo(np.float64).eps)
INTERPOLATIONS = ("linear", "nearest", "area")


def cv2_or_none():
    """The ``cv2`` module, or None where OpenCV does not import."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def resize(img: np.ndarray, size: Tuple[int, int], interpolation: str) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=INTER_<interpolation>)``:
    ``size`` is (width, height), ``interpolation`` one of ``INTERPOLATIONS``.
    OpenCV does it where it imports; otherwise the numpy route below, which
    returns the same array (a (H, W, 1) input comes back (h, w), as from
    OpenCV)."""
    if interpolation not in INTERPOLATIONS:
        raise ValueError(f"interpolation must be one of {INTERPOLATIONS}, got {interpolation!r}")
    cv2 = cv2_or_none()
    if cv2 is not None:
        flag = {"linear": cv2.INTER_LINEAR, "nearest": cv2.INTER_NEAREST, "area": cv2.INTER_AREA}[interpolation]
        return cv2.resize(img, tuple(size), interpolation=flag)
    return resize_numpy(img, size, interpolation)


def resize_numpy(img: np.ndarray, size: Tuple[int, int], interpolation: str) -> np.ndarray:
    """The numpy route of ``resize``, whether or not OpenCV imports."""
    img = np.asarray(img)
    if img.ndim not in (2, 3):
        raise ValueError(f"resize takes (H, W) or (H, W, C), got {img.shape}")
    dw, dh = int(size[0]), int(size[1])
    if dw <= 0 or dh <= 0:
        raise ValueError(f"resize to a positive size, got {size}")
    sh, sw = img.shape[:2]
    src = img if img.ndim == 3 else img[..., None]
    if (dh, dw) == (sh, sw):
        out = src.copy()
    elif interpolation == "nearest":
        out = _nearest(src, dh, dw)
    else:
        sx, sy = _scales(sw, dw), _scales(sh, dh)
        if interpolation == "linear" and sx[2] and sy[2] and sx[1] == 2 and sy[1] == 2:
            interpolation = "area"  # OpenCV: an exact 2x linear downscale is the area mean
        if interpolation == "linear":
            out = _linear_u8(src, dh, dw)
        else:
            out = _area(src, dh, dw, sx, sy)
    return out[..., 0] if out.shape[2] == 1 else out


def _scales(src: int, dst: int) -> Tuple[float, int, bool]:
    """OpenCV's ``scale = 1/(dst/src)``, its integer rounding and whether the
    scale is that integer (``is_area_fast``)."""
    scale = 1.0 / (dst / src)
    iscale = int(np.rint(scale))
    return scale, iscale, abs(scale - iscale) < _DBL_EPSILON


def _nearest(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    sh, sw = src.shape[:2]
    fx, fy = 1.0 / (dw / sw), 1.0 / (dh / sh)
    xs = np.minimum(np.floor(np.arange(dw) * fx).astype(np.int64), sw - 1)
    ys = np.minimum(np.floor(np.arange(dh) * fy).astype(np.int64), sh - 1)
    return src[ys][:, xs]


def _linear_coeffs(src: int, dst: int, clamp: bool):
    """Source index and the two 11-bit weights of each output position, as
    ``cv::resize`` computes them for ``INTER_LINEAR`` (x clamps at the
    borders, y keeps its index and clips the rows it reads)."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    if clamp:
        low, high = s < 0, s >= src - 1
        f[low | high] = 0
        s[low] = 0
        s[high] = src - 1
    one = np.float32(1.0)
    w0 = np.rint((one - f) * np.float32(_COEF_SCALE)).astype(np.int64)
    w1 = np.rint(f * np.float32(_COEF_SCALE)).astype(np.int64)
    return s, w0, w1


def _linear_u8(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    if src.dtype != np.uint8:
        raise NotImplementedError(f"the numpy INTER_LINEAR route takes uint8 (OpenCV's fixed-point path), "
                                  f"got {src.dtype}; install OpenCV for other types")
    sh, sw = src.shape[:2]
    xs, a0, a1 = _linear_coeffs(sw, dw, clamp=True)
    ys, b0, b1 = _linear_coeffs(sh, dh, clamp=False)
    s = src.astype(np.int64)
    rows = (s[:, xs] * a0[None, :, None] + s[:, np.minimum(xs + 1, sw - 1)] * a1[None, :, None])
    r0, r1 = rows[np.clip(ys, 0, sh - 1)], rows[np.clip(ys + 1, 0, sh - 1)]
    out = (((b0[:, None, None] * (r0 >> 4)) >> 16) + ((b1[:, None, None] * (r1 >> 4)) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def _check_area(src: np.ndarray, sx, sy) -> None:
    if src.dtype not in (np.uint8, np.uint16):
        raise NotImplementedError(f"the numpy INTER_AREA route takes uint8 or uint16, got {src.dtype}; "
                                  "install OpenCV for other types")
    if sx[0] < 1 or sy[0] < 1:
        raise NotImplementedError("the numpy INTER_AREA route downscales only (OpenCV upscales INTER_AREA as a "
                                  "variant of INTER_LINEAR); install OpenCV to enlarge with it")


def _saturate(x: np.ndarray, dtype) -> np.ndarray:
    info = np.iinfo(dtype)
    return np.clip(np.rint(x), info.min, info.max).astype(dtype)


def _area(src: np.ndarray, dh: int, dw: int, sx, sy) -> np.ndarray:
    _check_area(src, sx, sy)
    if sx[2] and sy[2]:
        return _area_fast(src, dh, dw, sx[1], sy[1])
    xi, xa = _area_taps(src.shape[1], dw, sx[0])
    yi, ya = _area_taps(src.shape[0], dh, sy[0])
    s = src.astype(np.float32)
    buf = np.zeros((src.shape[0], dw, src.shape[2]), np.float32)
    for t in range(xi.shape[1]):  # per source row: the taps of each output column, in order
        buf += s[:, xi[:, t]] * xa[None, :, t, None]
    acc = np.zeros((dh, dw, src.shape[2]), np.float32)
    for t in range(yi.shape[1]):  # the rows of each output row, in order
        acc += ya[:, t, None, None] * buf[yi[:, t]]
    return _saturate(acc, src.dtype)


def _area_fast(src: np.ndarray, dh: int, dw: int, kx: int, ky: int) -> np.ndarray:
    """Integer ratios: every output pixel is one whole kx × ky block."""
    c = src.shape[2]
    blocks = src[: dh * ky, : dw * kx].astype(np.int64).reshape(dh, ky, dw, kx, c)
    total = blocks.sum(axis=(1, 3))
    if kx == 2 and ky == 2 and c in (1, 3, 4):
        return ((total + 2) >> 2).astype(src.dtype)
    scale = np.float32(1.0) / np.float32(kx * ky)
    return _saturate(total.astype(np.float32) * scale, src.dtype)


def _area_taps(ssize: int, dsize: int, scale: float):
    """OpenCV's ``computeResizeAreaTab`` as dense (dsize, taps) index and
    float32 weight tables, each row's taps in OpenCV's order and padded
    with weight 0 (adding a zero leaves a float32 sum unchanged)."""
    rows: List[List[Tuple[int, float]]] = []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        taps = []
        if sx1 - fsx1 > 1e-3:
            taps.append((sx1 - 1, (sx1 - fsx1) / cell))
        for s in range(sx1, sx2):
            taps.append((s, 1.0 / cell))
        if fsx2 - sx2 > 1e-3:
            taps.append((sx2, min(min(fsx2 - sx2, 1.0), cell) / cell))
        rows.append(taps)
    width = max(len(t) for t in rows)
    index = np.zeros((dsize, width), np.int64)
    alpha = np.zeros((dsize, width), np.float32)
    for d, taps in enumerate(rows):
        for t, (s, a) in enumerate(taps):
            index[d, t], alpha[d, t] = s, np.float32(a)
    return index, alpha


# ---------------------------------------------------------------------------
# PIL's BICUBIC on float32 images
# ---------------------------------------------------------------------------

def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _pil_coeffs(in_size: int, out_size: int):
    """``precompute_coeffs`` of Pillow's Resample.c for BICUBIC: each output
    pixel's first source index and float64 weights (normalised, zero-padded
    to the kernel's width)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    w = _bicubic((taps[None, :] + xmin[:, None] - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    total = np.zeros(out_size)
    for t in range(ksize):  # ww += w in tap order
        total = total + w[:, t]
    w = np.where(total[:, None] != 0.0, w / np.where(total == 0.0, 1.0, total)[:, None], w)
    return xmin, xmax, w


def _pil_pass(img: np.ndarray, out_size: int) -> np.ndarray:
    """One Pillow pass along axis 1 of a float32 (rows, cols) image."""
    xmin, xmax, w = _pil_coeffs(img.shape[1], out_size)
    src = img.astype(np.float64)
    acc = np.zeros((img.shape[0], out_size))
    for t in range(w.shape[1]):
        idx = np.minimum(xmin + t, img.shape[1] - 1)
        acc = acc + src[:, idx] * w[None, :, t]
    return acc.astype(np.float32)


def pil_bicubic(arr: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``np.asarray(Image.fromarray(arr).resize(size, Image.BICUBIC),
    np.float32)`` for a 2-D float32 array; ``size`` is (width, height).
    PIL does it where it imports; otherwise the numpy route."""
    try:
        from PIL import Image
    except ImportError:
        return pil_bicubic_numpy(arr, size)
    return np.asarray(Image.fromarray(arr).resize(tuple(size), Image.BICUBIC), np.float32)


def pil_bicubic_numpy(arr: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """The numpy route of ``pil_bicubic``."""
    arr = np.asarray(arr)
    if arr.dtype != np.float32 or arr.ndim != 2:
        raise NotImplementedError(f"the numpy BICUBIC route takes a 2-D float32 image (PIL mode F), "
                                  f"got {arr.dtype} {arr.shape}")
    w, h = int(size[0]), int(size[1])
    out = arr
    if w != arr.shape[1]:
        out = _pil_pass(out, w)
    if h != arr.shape[0]:
        out = _pil_pass(out.T, h).T
    return np.ascontiguousarray(out)

