"""Sliding-window full-resolution 2D segmentation. Port of
``eval/sliding_window.py:24-126, 232-242``.

An image larger than the network's window is tiled with overlapping
windows (stride window/2 by default, the last window right-aligned), the
windows go through the forward in fixed-size batches, and their logits are
blended back with a Hann profile (+1e-3, so every pixel has weight) and
divided by the summed weights. An image smaller than the window is padded
with zeros first and cropped back at the end. The window list is padded to
a whole number of batches by repeating its last window, so every forward
sees one shape; the repeats are not blended.

``count_windows`` is the one place the window count is computed. The JAX
package's fused one-dispatch predictor (``:129-229``) is not ported: here
the loop is the one path for every window count.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F


def _window_starts(full: int, window: int, stride: int) -> np.ndarray:
    """Start offsets covering [0, full) with the last window right-aligned."""
    if full <= window:
        return np.array([0], np.int32)
    starts = list(range(0, full - window + 1, stride))
    if starts[-1] != full - window:
        starts.append(full - window)
    return np.asarray(starts, np.int32)


def _blend_weights(window: int) -> np.ndarray:
    """1-D center-peaked (Hann) blend profile, strictly positive."""
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * (np.arange(window) + 0.5) / window)
    return (w + 1e-3).astype(np.float32)


def window_grid(h: int, w: int, window: int, stride: int = 0) -> np.ndarray:
    """(n, 2) window origins (y, x) for an h × w image, padded up to the
    window where it is smaller; ``stride`` ≤ 0 means window // 2."""
    if stride <= 0:
        stride = max(1, window // 2)
    ys = _window_starts(max(h, window), window, stride)
    xs = _window_starts(max(w, window), window, stride)
    return np.array([(y, x) for y in ys for x in xs], np.int32)


def count_windows(h: int, w: int, window: int, stride: int = 0) -> int:
    return len(window_grid(h, w, window, stride))


def sliding_window_predict(
    apply_fn: Callable[[torch.Tensor], torch.Tensor],  # (N, S, S, C) → (N, S, S, K) logits
    image: torch.Tensor,                                # (H, W, C), already normalized
    window: int,
    stride: int = 0,
    batch_windows: int = 16,
    num_classes: int = 1,
) -> torch.Tensor:
    """Full-resolution (H, W, K) f32 logits on ``image``'s device."""
    orig_h, orig_w, _ = image.shape
    pad_h, pad_w = max(window - orig_h, 0), max(window - orig_w, 0)
    if pad_h or pad_w:
        image = F.pad(image, (0, 0, 0, pad_w, 0, pad_h))
    h, w, _ = image.shape

    coords = window_grid(orig_h, orig_w, window, stride)
    n = len(coords)
    pad_n = (-n) % batch_windows
    if pad_n:
        coords = np.concatenate([coords, np.tile(coords[-1:], (pad_n, 1))])

    wy = torch.from_numpy(_blend_weights(window)).to(image.device)
    blend = (wy[:, None] * wy[None, :])[..., None]  # (S, S, 1)
    out_logits = torch.zeros((h, w, num_classes), dtype=torch.float32, device=image.device)
    weight_sum = torch.zeros((h, w, 1), dtype=torch.float32, device=image.device)
    for s in range(0, len(coords), batch_windows):
        cb = coords[s:s + batch_windows].tolist()
        windows = torch.stack([image[y:y + window, x:x + window] for y, x in cb])
        weighted = apply_fn(windows).float() * blend
        for j, (y, x) in enumerate(cb[:n - s]):  # the padded tail is not blended
            out_logits[y:y + window, x:x + window] += weighted[j]
            weight_sum[y:y + window, x:x + window] += blend
    return (out_logits / weight_sum)[:orig_h, :orig_w]


def make_unet_window_fn(task) -> Callable[[torch.Tensor], torch.Tensor]:
    """The normalized-window forward for ``sliding_window_predict``: the
    task's eval-mode f32 logits."""
    return task.logits
