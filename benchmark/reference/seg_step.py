"""A plain U-Net(resnet18) segmentation training step: the benchmark's
reference for the ``unet_r18.train`` cell.

Per step (the reference repository's ``train_segmentation.py`` as the
port's ``SegmentationTask`` runs it): the network of ``reference/nets.py``
in training mode (BatchNorm on the batch's statistics) on the augmented
slices; the Dice loss of the sigmoid over the whole batch flattened
(``1 − (2·Σpt + 1)/(Σp + Σt + 1)``); LARS on every parameter (as
``reference/byol.py`` states it: trust ratio ``η·‖p‖/(‖g‖ + wd·‖p‖ + ε)``
for a parameter of rank 2 or more, ``buf ← m·buf + g``, ``p ← p − lr·buf``)
at the linear-warmup cosine learning rate of whole epochs ending at
``min_lr``. The encoder and every decoder block are checkpointed: the
same arithmetic, kept within the card's memory at 512 slices in float32.

The augmentation the program's ``ops/augment.py::segmentation_augment``
applies, redrawn from the same generator in the same order (horizontal
flip, vertical flip, brightness, contrast, a uniform each): the slice
resized to the output by two-tap bilinear weights (half-pixel centres,
source clamped), each pass rounded to the configuration's dtype as the
program's matrix products in that dtype round it, the flips reversing
the output's rows or columns; the mask by the nearest source pixel
(``round((i + 0.5)·scale − 0.5)``, half to even); then brightness, clip,
contrast around the sample's mean, clip, normalize.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from benchmark.reference import nets


def lr_at(tr: dict, step: int) -> float:
    epoch = math.floor(step / tr["steps_per_epoch"])
    base, warm, top, low = tr["learning_rate"], tr["warmup_epochs"], tr["max_epochs"], tr["min_lr"]
    if epoch < warm:
        return epoch * base / max(warm - 1, 1)
    return low + 0.5 * (base - low) * (1.0 + math.cos(math.pi * (epoch - warm) / max(top - warm, 1)))


def dice_loss(logits: torch.Tensor, masks: torch.Tensor, smooth: float = 1.0) -> torch.Tensor:
    p, t = torch.sigmoid(logits.float()).reshape(-1), masks.float().reshape(-1)
    return 1.0 - (2.0 * (p * t).sum() + smooth) / (p.sum() + t.sum() + smooth)


# --- the augmentation -----------------------------------------------------------------


def sample_draws(generator: torch.Generator, batch: int) -> dict:
    dev = generator.device
    u = [torch.rand(batch, generator=generator, device=dev, dtype=torch.float32) for _ in range(4)]
    return {"hflip": u[0] < 0.5, "vflip": u[1] < 0.5, "brightness": 0.8 + (1.2 - 0.8) * u[2],
            "contrast": 0.8 + (1.2 - 0.8) * u[3]}


def _taps(in_dim: int, out_dim: int, device):
    """Each output's two source pixels and the second's weight."""
    i = torch.arange(out_dim, device=device, dtype=torch.float32)
    src = ((i + 0.5) * (in_dim / out_dim) - 0.5).clamp(0.0, in_dim - 1)
    lo = torch.floor(src)
    return lo.long(), (lo + 1).clamp(max=in_dim - 1).long(), src - lo


def _resize(x: torch.Tensor, dim: int, out_dim: int, dtype) -> torch.Tensor:
    """Bilinear along ``dim`` of f32 ``x``, the two weights and the result
    rounded to ``dtype``."""
    lo, hi, frac = _taps(x.shape[dim], out_dim, x.device)
    w_hi = frac.to(dtype).float()
    w_lo = (1.0 - frac).to(dtype).float()
    shape = [1] * x.dim()
    shape[dim] = out_dim
    out = x.index_select(dim, lo) * w_lo.view(shape) + x.index_select(dim, hi) * w_hi.view(shape)
    return out.to(dtype).float()


def _nearest(in_dim: int, out_dim: int, device) -> torch.Tensor:
    i = torch.arange(out_dim, device=device, dtype=torch.float32)
    return torch.round((i + 0.5) * (in_dim / out_dim) - 0.5).clamp(0.0, in_dim - 1).long()


def augment(draws: dict, images: torch.Tensor, masks: torch.Tensor, out_size, mean: float, std: float, dtype):
    """(B, H, W, 1) uint8 slices and masks → the image in ``dtype`` and the
    f32 0/1 mask."""
    oh, ow = out_size
    img = _resize(_resize(images.float(), 1, oh, dtype), 2, ow, dtype)
    msk = masks.index_select(1, _nearest(masks.shape[1], oh, masks.device))
    msk = (msk.index_select(2, _nearest(masks.shape[2], ow, masks.device)).float() > 0.5).float()
    v, h = draws["vflip"].view(-1, 1, 1, 1), draws["hflip"].view(-1, 1, 1, 1)
    img, msk = torch.where(v, img.flip(1), img), torch.where(v, msk.flip(1), msk)
    img, msk = torch.where(h, img.flip(2), img), torch.where(h, msk.flip(2), msk)
    img = img * (1.0 / 255.0)
    img = (img * draws["brightness"].view(-1, 1, 1, 1)).clamp(0.0, 1.0)
    m = img.mean(dim=(1, 2, 3), keepdim=True)
    img = (m + draws["contrast"].view(-1, 1, 1, 1) * (img - m)).clamp(0.0, 1.0)
    mean_t = torch.tensor([mean], dtype=torch.float32, device=img.device)
    std_t = torch.tensor([std], dtype=torch.float32, device=img.device)
    return ((img - mean_t) / std_t).to(dtype), msk


# --- the network and the step --------------------------------------------------------------


def _forward(x: torch.Tensor, P: Dict[str, torch.Tensor], arch: str, precision: str) -> torch.Tensor:
    """``nets.unet`` in training mode, checkpointed block by block."""
    def encode(x):
        return tuple(nets.resnet(x, P, "encoder.", arch, True, precision=precision, pyramid=True))

    maps = checkpoint(encode, x, use_reentrant=False)
    skips = list(maps[-2::-1]) + [None]
    y = maps[-1]

    def decode(i, y, skip):
        y = torch.nn.functional.interpolate(y, scale_factor=2, mode="nearest")
        if skip is not None:
            y = torch.cat([y, skip], dim=1)
        for k in (1, 2):
            y = nets.conv(y, P[f"decoder.{i}.conv{k}.weight"], 1, 1, precision=precision)
            y = torch.relu(nets.batch_norm(y, P, f"decoder.{i}.bn{k}", True))
        return y

    for i, skip in enumerate(skips):
        y = checkpoint(decode, i, y, skip, use_reentrant=False)
    y = nets.conv(y, P["head.weight"], 1, 1, P["head.bias"], precision=precision)
    return y.permute(0, 2, 3, 1)


class ReferenceSeg:
    """The parameters (f32 copies by name; the running statistics are
    not followed), the LARS buffers and the step count."""

    def __init__(self, arch: str, tr: dict, weights: Dict[str, torch.Tensor], step: int, precision: str = "f32"):
        self.arch, self.tr, self.precision, self.step_count = arch, tr, precision, step
        self.params = [k for k in weights if not k.endswith(("running_mean", "running_var"))]
        self.P = {k: v.detach().float().clone() for k, v in weights.items()}
        self.buf = {k: torch.zeros_like(self.P[k]) for k in self.params}

    def loss_and_grads(self, x: torch.Tensor, masks: torch.Tensor):
        for k in self.params:
            self.P[k].requires_grad_(True)
        loss = dice_loss(_forward(x.float(), self.P, self.arch, self.precision), masks)
        grads = torch.autograd.grad(loss, [self.P[k] for k in self.params], allow_unused=True)
        for k in self.params:
            self.P[k].requires_grad_(False)
        return loss.detach(), dict(zip(self.params, grads))

    @torch.no_grad()
    def apply(self, grads: Dict[str, torch.Tensor]) -> None:
        tr = self.tr
        lr, wd, m, eta, eps = lr_at(tr, self.step_count), tr["weight_decay"], tr["momentum"], 0.001, 1e-8
        for k in self.params:
            p = self.P[k]
            g = grads[k] if grads[k] is not None else torch.zeros_like(p)
            if p.ndim >= 2 and wd != 0.0:
                pn, gn = p.norm(), g.norm()
                tr_ = torch.where((pn > 0) & (gn > 0), eta * pn / (gn + wd * pn + eps), torch.ones_like(pn))
                g = (g + wd * p) * tr_
            self.buf[k].mul_(m).add_(g)
            p.sub_(lr * self.buf[k])
        self.step_count += 1

    def train_step(self, x: torch.Tensor, masks: torch.Tensor):
        loss, grads = self.loss_and_grads(x, masks)
        self.apply(grads)
        return loss, grads
