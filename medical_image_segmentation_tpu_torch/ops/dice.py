"""Dice loss and segmentation metrics. Port of ``ops/dice.py:25-61``.

- ``dice_loss``: sigmoid in f32, the whole batch flattened into one Dice
  score (not per sample), smooth 1 in the numerator and the denominator.
- ``dice_ce``: ``dice_loss`` plus the mean sigmoid binary cross-entropy
  (``train/segmentation_task.py:79-88``).
- ``post_process_masks``: sigmoid > threshold, as f32.
- ``dice_coefficient`` / ``jaccard_index``: on binarized masks, the batch
  flattened, smooth 1 and 1e-6.

Every sum is taken in f32 whatever the input dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dice_loss(logits: torch.Tensor, targets: torch.Tensor, smooth: float = 1.0) -> torch.Tensor:
    probs = torch.sigmoid(logits.float()).reshape(-1)
    targets = targets.float().reshape(-1)
    intersection = (probs * targets).sum()
    denom = probs.sum() + targets.sum()
    return 1.0 - (2.0 * intersection + smooth) / (denom + smooth)


def dice_ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Dice + sigmoid BCE, the "Dice+CE" fine-tune objective."""
    ce = F.binary_cross_entropy_with_logits(logits.float(), targets.float())
    return dice_loss(logits, targets) + ce


def post_process_masks(logits: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    return (torch.sigmoid(logits.float()) > threshold).float()


def dice_coefficient(pred_masks: torch.Tensor, targets: torch.Tensor, smooth: float = 1.0) -> torch.Tensor:
    p = pred_masks.float().reshape(-1)
    t = targets.float().reshape(-1)
    return (2.0 * (p * t).sum() + smooth) / (p.sum() + t.sum() + smooth)


def jaccard_index(pred_masks: torch.Tensor, targets: torch.Tensor, smooth: float = 1e-6) -> torch.Tensor:
    p = pred_masks.float().reshape(-1)
    t = targets.float().reshape(-1)
    intersection = (p * t).sum()
    return (intersection + smooth) / (p.sum() + t.sum() - intersection + smooth)
