"""Dice loss and segmentation metrics. Port of ``ops/dice.py:25-61``.

- ``dice_loss``: sigmoid in f32, the whole batch flattened into one Dice
  score (not per sample), smooth 1 in the numerator and the denominator.
- ``dice_ce``: ``dice_loss`` plus the mean sigmoid binary cross-entropy
  (``train/segmentation_task.py:79-88``).
- ``post_process_masks``: sigmoid > threshold, as f32.
- ``dice_coefficient`` / ``jaccard_index``: on binarized masks, the batch
  flattened, smooth 1 and 1e-6.
- ``softmax_dice_ce``: nnU-Net's ``DC_and_CE_loss`` over integer label
  maps: the mean softmax cross-entropy minus the mean over the foreground
  classes of the batch's soft Dice (background left out, smooth 1e-5);
  ``deep_supervised_dice_ce`` weighs it over a network's outputs, each
  against the label map taken at every ``s``-th voxel from ``s // 2``
  (nearest neighbour, ``s`` the output's stride), and skips a weight of 0.
- ``per_class_dice`` / ``per_class_jaccard``: hard scores of the argmax
  against the label map, one a foreground class, smooth 1 and 1e-6.
- ``dice_ce_softmax``: MONAI's ``DiceCELoss(to_onehot_y=True,
  softmax=True, squared_pred=True, smooth_nr=0, smooth_dr=1e-6)`` (Swin
  UNETR's): the Dice of each sample and class, background included, with
  squared denominators, averaged, plus the voxels' mean cross-entropy.

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


def _class_hits(labels: torch.Tensor, n_classes: int) -> torch.Tensor:
    """(..., n_classes − 1) f32 one-hot of the foreground classes of an
    integer-valued (..., 1) label map."""
    fg = torch.arange(1, n_classes, device=labels.device, dtype=torch.float32)
    return (labels.float() == fg).float()


def _class_sums(p: torch.Tensor, t: torch.Tensor, group) -> torch.Tensor:
    """(3, K − 1): Σp·t, Σp and Σt a class over the batch and the voxels
    (every rank's under a group, differentiably)."""
    dims = tuple(range(p.dim() - 1))
    sums = torch.stack([(p * t).sum(dims), p.sum(dims), t.sum(dims)])
    return all_reduce_sum(sums, group) if group is not None else sums


def _dice(sums: torch.Tensor, smooth: float) -> torch.Tensor:
    return (2.0 * sums[0] + smooth) / (sums[1] + sums[2] + smooth).clamp_min(1e-8)


def softmax_dice_ce(logits: torch.Tensor, labels: torch.Tensor, smooth: float = 1e-5, group=None) -> torch.Tensor:
    """``logits`` (B, ..., K) channels-last, ``labels`` (B, ..., 1) with
    values in 0..K−1. Cross-entropy minus the mean foreground soft Dice,
    both in f32. Under a group the Dice sums are the global batch's and
    the cross-entropy this rank's mean, whose mean over the group is the
    global one."""
    z = logits.float()
    k = z.shape[-1]
    logp = torch.log_softmax(z, dim=-1)
    ce = F.nll_loss(logp.reshape(-1, k), labels.reshape(-1).long())
    return ce - _dice(_class_sums(logp[..., 1:].exp(), _class_hits(labels, k), group), smooth).mean()


def dice_ce_softmax(logits: torch.Tensor, labels: torch.Tensor, group=None) -> torch.Tensor:
    """``logits`` (B, ..., K) channels-last, ``labels`` (B, ..., 1) with
    values in 0..K−1: mean over samples and classes of ``1 − 2Σpg / (Σp² +
    Σg² + 1e-6)``, plus the mean cross-entropy, in f32. Each sample's Dice
    is its own, so under a group this is the rank's mean, whose mean over
    the group is the global one: no sum crosses ranks."""
    z = logits.float()
    b, k = z.shape[0], z.shape[-1]
    logp = torch.log_softmax(z, dim=-1).reshape(b, -1, k)
    y = labels.reshape(b, -1).long()
    p = logp.exp()
    g = F.one_hot(y, k).float()
    dice = 1.0 - 2.0 * (p * g).sum(1) / ((p * p).sum(1) + g.sum(1) + 1e-6)
    return dice.mean() + F.nll_loss(logp.reshape(-1, k), y.reshape(-1))


def softmax_dice_loss(logits: torch.Tensor, labels: torch.Tensor, smooth: float = 1e-5, group=None) -> torch.Tensor:
    """1 − the mean foreground soft Dice of the batch (the eval loss)."""
    p = torch.softmax(logits.float(), dim=-1)[..., 1:]
    return 1.0 - _dice(_class_sums(p, _class_hits(labels, logits.shape[-1]), group), smooth).mean()


def downsample_labels(labels: torch.Tensor, shape) -> torch.Tensor:
    """(B, D, H, W, 1) ``labels`` at the spatial ``shape`` (each a whole
    fraction of the full one): every ``s``-th voxel from ``s // 2``."""
    index = [slice(None)]
    for full, out in zip(labels.shape[1:-1], shape):
        s = full // out
        index.append(slice(s // 2, None, s))
    return labels[tuple(index)]


def deep_supervised_dice_ce(outputs, labels: torch.Tensor, weights, group=None) -> torch.Tensor:
    """Σ weight · ``softmax_dice_ce`` over ``outputs`` (full resolution
    first), each against the labels at its size; a weight of 0 computes
    nothing."""
    total = None
    for w, out in zip(weights, outputs):
        if w == 0.0:
            continue
        term = w * softmax_dice_ce(out, downsample_labels(labels, out.shape[1:-1]), group=group)
        total = term if total is None else total + term
    return total


def deep_supervision_weights(n: int) -> tuple:
    """nnU-Net's: 1, 1/2, 1/4, … with the coarsest 0, normalised to sum 1."""
    w = [0.5 ** i for i in range(n)]
    w[-1] = 0.0
    return tuple(x / sum(w) for x in w)


def _hard_class_sums(logits: torch.Tensor, labels: torch.Tensor, group) -> torch.Tensor:
    k = logits.shape[-1]
    return _class_sums(_class_hits(logits.argmax(dim=-1, keepdim=True), k), _class_hits(labels, k), group)


def per_class_dice(logits: torch.Tensor, labels: torch.Tensor, smooth: float = 1.0, group=None) -> torch.Tensor:
    """(K − 1,) hard Dice of the argmax, a foreground class each."""
    return _dice(_hard_class_sums(logits, labels, group), smooth)


def per_class_jaccard(logits: torch.Tensor, labels: torch.Tensor, smooth: float = 1e-6,
                      group=None) -> torch.Tensor:
    inter, p_sum, t_sum = _hard_class_sums(logits, labels, group)
    return (inter + smooth) / (p_sum + t_sum - inter + smooth)
