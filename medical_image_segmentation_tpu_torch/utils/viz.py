"""Prediction/truth overlay grid. Port of ``utils/viz.py:54-77`` onto the
port's PNG writer (``utils/png.py``); the tiling helpers are the JAX
package's own numpy code."""

from __future__ import annotations

import os

import numpy as np

from medical_image_segmentation_tpu.utils.viz import _normalize_to_uint8, _to_grid
from medical_image_segmentation_tpu_torch.utils.png import write_png


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
