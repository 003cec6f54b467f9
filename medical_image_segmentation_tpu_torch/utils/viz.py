"""Image grids and the prediction/truth overlay grid. Port of
``utils/viz.py:43-77``: ``save_image_grid`` writes with OpenCV where it
imports and otherwise with the port's PNG writer (``utils/imageio.py``),
the overlay always with ``utils/png.py``; the tiling helpers and
``print_batch_stats`` are copies of the JAX package's numpy code
(``utils/viz.py:21-40``, ``:80-86``)."""

from __future__ import annotations

import os
import sys

import numpy as np

from medical_image_segmentation_tpu_torch.utils.imageio import write_image
from medical_image_segmentation_tpu_torch.utils.png import write_png


def _to_grid(batch: np.ndarray, nrow: int = 8, pad: int = 2) -> np.ndarray:
    """(B,H,W,C) uint8 → one (GH,GW,C) grid image."""
    b, h, w, c = batch.shape
    ncol = min(nrow, b)
    nr = -(-b // ncol)
    grid = np.zeros((nr * (h + pad) + pad, ncol * (w + pad) + pad, c), np.uint8)
    for i in range(b):
        r, col = divmod(i, ncol)
        y = pad + r * (h + pad)
        x = pad + col * (w + pad)
        grid[y : y + h, x : x + w] = batch[i]
    return grid


def _normalize_to_uint8(images: np.ndarray) -> np.ndarray:
    img = np.asarray(images, np.float32)
    lo, hi = img.min(), img.max()
    if hi > lo:
        img = (img - lo) / (hi - lo)
    return (img * 255).astype(np.uint8)


def save_image_grid(images: np.ndarray, path: str, nrow: int = 8) -> None:
    """images: (B,H,W,C) any-range floats or uint8, tiled into one PNG."""
    if images.ndim == 3:
        images = images[..., None]
    grid = _to_grid(_normalize_to_uint8(images), nrow)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_image(path, grid)


def save_combined_image_grid(images: np.ndarray, pred_masks: np.ndarray, masks: np.ndarray, path: str,
                             nrow: int = 8, alpha: float = 0.5) -> None:
    """Gray images with the prediction blended into red and the ground
    truth into blue, tiled into one RGB PNG."""
    if images.ndim == 3:
        images = images[..., None]
    gray = _normalize_to_uint8(images).astype(np.float32)
    rgb = np.repeat(gray, 3, axis=-1)
    pred = np.asarray(pred_masks, np.float32).reshape(pred_masks.shape[0], *pred_masks.shape[1:3], -1)[..., :1]
    true = np.asarray(masks, np.float32).reshape(masks.shape[0], *masks.shape[1:3], -1)[..., :1]
    rgb[..., 0:1] = np.where(pred > 0.5, (1 - alpha) * rgb[..., 0:1] + alpha * 255.0, rgb[..., 0:1])
    rgb[..., 2:3] = np.where(true > 0.5, (1 - alpha) * rgb[..., 2:3] + alpha * 255.0, rgb[..., 2:3])
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_png(path, _to_grid(rgb.astype(np.uint8), nrow))


def print_batch_stats(name: str, arr: np.ndarray, file=sys.stderr) -> None:
    """One line of shape, dtype, min, max, mean and std of ``arr``."""
    arr = np.asarray(arr)
    print(
        f"{name}: shape={arr.shape} dtype={arr.dtype} "
        f"min={arr.min():.4f} max={arr.max():.4f} mean={arr.mean():.4f} std={arr.std():.4f}",
        file=file,
    )
