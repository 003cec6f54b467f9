"""The deployed 2D serving function. Port of ``serve.py:49-70``
(``make_predict_fn`` only; the exported artifact and its loader are not
ported yet).

uint8 batch → /255 → optional multi-window channels → normalize → U-Net
eval forward → sigmoid threshold → uint8 0/1 masks. ``mis-predict-torch``
serves with it; the sliding-window mode normalizes with
``normalize_u8`` and forwards windows instead.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple, Union

import torch

from medical_image_segmentation_tpu_torch.ops.augment import apply_hu_windows
from medical_image_segmentation_tpu_torch.ops.dice import post_process_masks

Stats = Union[float, Sequence[float]]


def normalize_u8(imgs_u8: torch.Tensor, mean: Stats, std: Stats,
                 hu_windows: Sequence[Tuple[float, float]] = ()) -> torch.Tensor:
    """(..., 1) uint8 → f32 network input on the 0-1 scale's stats."""
    dev = imgs_u8.device
    x = imgs_u8.float() / torch.tensor(255.0, device=dev)
    x = apply_hu_windows(x, hu_windows)
    mean_t = torch.tensor(mean, dtype=torch.float32, device=dev).reshape(-1)
    std_t = torch.tensor(std, dtype=torch.float32, device=dev).reshape(-1)
    return (x - mean_t) / std_t


def make_predict_fn(task, mean: Stats, std: Stats, threshold: float = 0.5,
                    hu_windows: Sequence[Tuple[float, float]] = ()) -> Callable[[torch.Tensor], torch.Tensor]:
    """(B, H, W, 1) uint8 on the task's device → (B, H, W, 1) uint8 masks.
    The compute dtype is the task's (bf16 autocast, or f32)."""

    def fn(imgs_u8: torch.Tensor) -> torch.Tensor:
        logits = task.logits(normalize_u8(imgs_u8, mean, std, hu_windows))
        return post_process_masks(logits, threshold=threshold).to(torch.uint8)

    return fn
