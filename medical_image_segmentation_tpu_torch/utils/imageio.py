"""Image files read and written as OpenCV does, with or without OpenCV.

The ingest CLIs, the Decathlon PNG loader and the PNG-tree datasets call
``cv2.imread`` / ``cv2.imwrite`` in the JAX package. ``read_image`` and
``write_image`` make those calls where ``cv2`` imports, so their output is
the reference's to the byte. Where it does not (the H100 machine has no
OpenCV, no PIL, no libpng and no libjpeg), PNG goes through
``utils/png.py`` and JPEG through ``utils/jpeg.py`` to the same pixels:

- ``read_image(path)`` is ``IMREAD_UNCHANGED``: the file's own depth and
  channels, colour in OpenCV's BGR(A) order;
- ``read_image(path, gray=True)`` is ``IMREAD_GRAYSCALE``: uint8, colour
  reduced as libpng reduces it for OpenCV, 16-bit samples cut to their
  high byte;
- ``write_image(path, img)`` writes 8- or 16-bit gray or 8-bit BGR PNG.

A three-channel JPEG, a progressive one and an interlaced PNG raise by name
without OpenCV; an unreadable file gives None, as from ``cv2.imread``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from medical_image_segmentation_tpu_torch.utils.jpeg import JpegUnsupported, decode_jpeg_numpy
from medical_image_segmentation_tpu_torch.utils.png import PngUnsupported, decode_png, encode_png
from medical_image_segmentation_tpu_torch.utils.resize import cv2_or_none

_PNG = b"\x89PNG\r\n\x1a\n"
_JPEG = b"\xFF\xD8"


def decode_image(data: bytes, gray: bool = False) -> np.ndarray:
    """The image of PNG or JPEG bytes by the numpy routes, as OpenCV's
    ``imdecode`` gives it (see the module docstring)."""
    if data[:8] == _PNG:
        img = decode_png(data)
        if img.ndim == 3 and img.shape[2] >= 3:
            img = img[..., [2, 1, 0, 3][: img.shape[2]]]  # RGB(A) → OpenCV's BGR(A)
        elif img.ndim == 3 and not gray:
            img = img[..., [0, 0, 0, 1]]  # gray+alpha: OpenCV gives BGRA
    elif data[:2] == _JPEG:
        img = decode_jpeg_numpy(data)
    else:
        raise ValueError("not a PNG or JPEG file")
    if gray:
        if img.ndim == 3 and img.shape[2] >= 3:
            img = _libpng_gray(img)
        elif img.ndim == 3:
            img = img[..., 0]
        if img.dtype == np.uint16:
            img = (img >> 8).astype(np.uint8)
    return img


def _libpng_gray(bgr: np.ndarray) -> np.ndarray:
    """libpng's ``png_set_rgb_to_gray(png, 1, 0.299, 0.587)``, which OpenCV's
    PNG reader asks for under ``IMREAD_GRAYSCALE``: weights truncated to 15
    bits (9797, 19234, 3737); 8-bit sums truncated, gray pixels kept, 16-bit
    sums rounded."""
    b, g, r = (bgr[..., i].astype(np.int64) for i in range(3))
    total = 9797 * r + 19234 * g + 3737 * b
    if bgr.dtype == np.uint16:
        return ((total + 16384) >> 15).astype(np.uint16)
    return np.where((r == g) & (r == b), r, total >> 15).astype(np.uint8)


def read_image(path: str, gray: bool = False) -> Optional[np.ndarray]:
    """``cv2.imread(path, IMREAD_GRAYSCALE if gray else IMREAD_UNCHANGED)``."""
    cv2 = cv2_or_none()
    if cv2 is not None:
        return cv2.imread(path, cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_UNCHANGED)
    if not os.path.isfile(path):
        return None
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG and data[:2] != _JPEG:
        return None
    try:
        return decode_image(data, gray)
    except (JpegUnsupported, PngUnsupported):
        raise  # the route cannot serve this file: say so by name
    except ValueError:
        return None  # malformed, as cv2.imread's None


def write_image(path: str, img: np.ndarray) -> bool:
    """``cv2.imwrite(path, img)`` for a PNG path; without OpenCV the PNG
    writer of ``utils/png.py`` (8-bit gray or BGR, 16-bit gray)."""
    cv2 = cv2_or_none()
    if cv2 is not None:
        return bool(cv2.imwrite(path, img))
    if not path.lower().endswith(".png"):
        raise ValueError(f"{path}: without OpenCV (cv2) images are written as PNG only")
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 3:
        img = img[..., ::-1]  # OpenCV's BGR → the file's RGB
    data = encode_png(img)
    with open(path, "wb") as f:
        f.write(data)
    return True
