"""Dice loss and segmentation metrics. Port of ``ops/dice.py:25-61``.

- ``dice_loss``: sigmoid in f32, the whole batch flattened into one Dice
  score (not per sample), smooth 1 in the numerator and the denominator.
- ``dice_ce``: ``dice_loss`` plus the mean sigmoid binary cross-entropy
  (``train/segmentation_task.py:79-88``).
- ``post_process_masks``: sigmoid > threshold, as f32.
- ``dice_coefficient`` / ``jaccard_index``: on binarized masks, the batch
  flattened, smooth 1 and 1e-6.

Every sum is taken in f32 whatever the input dtype.

``group``: the sums run over the batch of every rank of a data-parallel
group, as the JAX package's run over the whole sharded batch
(``ops/dice.py:25-37,51-60`` there). Averaging each rank's Dice would be
another loss with another gradient. ``dice_loss`` sums through
``all_reduce_sum``, whose backward sums the gradient over the group too:
every rank computes the same loss, and each rank's share of the sums then
gets the gradient of all of them, which the trainer's mean over the group
scales back to the gradient of the one global loss.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from medical_image_segmentation_tpu_torch.parallel.mesh import all_reduce_, all_reduce_sum


def dice_loss(logits: torch.Tensor, targets: torch.Tensor, smooth: float = 1.0, group=None) -> torch.Tensor:
    probs = torch.sigmoid(logits.float()).reshape(-1)
    targets = targets.float().reshape(-1)
    if group is not None:
        intersection, p_sum, t_sum = all_reduce_sum(
            torch.stack([(probs * targets).sum(), probs.sum(), targets.sum()]), group)
        return 1.0 - (2.0 * intersection + smooth) / (p_sum + t_sum + smooth)
    intersection = (probs * targets).sum()
    denom = probs.sum() + targets.sum()
    return 1.0 - (2.0 * intersection + smooth) / (denom + smooth)


def dice_ce(logits: torch.Tensor, targets: torch.Tensor, group=None) -> torch.Tensor:
    """Dice + sigmoid BCE, the "Dice+CE" fine-tune objective. Under a group
    the BCE is this rank's mean, whose mean over the group is the global
    one."""
    ce = F.binary_cross_entropy_with_logits(logits.float(), targets.float())
    return dice_loss(logits, targets, group=group) + ce


def post_process_masks(logits: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    return (torch.sigmoid(logits.float()) > threshold).float()


def _hard_sums(pred_masks: torch.Tensor, targets: torch.Tensor, group):
    p = pred_masks.float().reshape(-1)
    t = targets.float().reshape(-1)
    if group is None:
        return (p * t).sum(), p.sum(), t.sum()
    return tuple(all_reduce_(torch.stack([(p * t).sum(), p.sum(), t.sum()]), group))


def dice_coefficient(pred_masks: torch.Tensor, targets: torch.Tensor, smooth: float = 1.0,
                     group=None) -> torch.Tensor:
    intersection, p_sum, t_sum = _hard_sums(pred_masks, targets, group)
    return (2.0 * intersection + smooth) / (p_sum + t_sum + smooth)


def jaccard_index(pred_masks: torch.Tensor, targets: torch.Tensor, smooth: float = 1e-6,
                  group=None) -> torch.Tensor:
    intersection, p_sum, t_sum = _hard_sums(pred_masks, targets, group)
    return (intersection + smooth) / (p_sum + t_sum - intersection + smooth)
