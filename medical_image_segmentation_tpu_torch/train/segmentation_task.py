"""U-Net segmentation task. Port of ``train/segmentation_task.py:40-128``.

- ``UNet`` with a ResNet encoder, ``n_classes`` logits;
- Dice loss (or Dice + sigmoid BCE, ``loss="dice_ce"``) for training;
- LARS (rank ≥ 2 parameters decayed and adapted) with the linear-warmup
  cosine LR held for a whole epoch (``interval="epoch"``) and ending at
  ``min_lr``, unlike BYOL's per-step schedule; the reported ``lr`` is the
  schedule at the step count before the increment;
- eval: Dice loss, and hard Dice and IoU at threshold 0.5, on running
  BatchNorm statistics;
- bf16 compute through ``torch.autocast`` when ``dtype`` is bf16; f32
  parameters, loss and metrics.
"""

from __future__ import annotations

from typing import Dict

import torch

from medical_image_segmentation_tpu_torch.models.unet import UNet
from medical_image_segmentation_tpu_torch.ops.dice import (
    dice_ce, dice_coefficient, dice_loss, jaccard_index, post_process_masks,
)
from medical_image_segmentation_tpu_torch.ops.lars import LARS
from medical_image_segmentation_tpu_torch.ops.schedules import linear_warmup_cosine_annealing


class SegmentationTask:
    def __init__(
        self,
        arch: str = "resnet18",
        n_classes: int = 1,
        in_channels: int = 1,
        learning_rate: float = 1.0,
        weight_decay: float = 1e-6,
        momentum: float = 0.9,
        warmup_epochs: int = 10,
        max_epochs: int = 50,
        min_lr: float = 1e-2,
        steps_per_epoch: int = 1,
        loss: str = "dice",
        dtype: torch.dtype = torch.bfloat16,
        device="cpu",
    ):
        if loss not in ("dice", "dice_ce"):
            raise ValueError(f"loss must be 'dice' or 'dice_ce', got {loss!r}")
        self.device = torch.device(device)
        self.dtype = dtype
        self._loss = dice_ce if loss == "dice_ce" else dice_loss
        self._net_kw = dict(arch=arch, n_classes=n_classes, in_channels=in_channels)
        self.model = UNet(**self._net_kw).to(self.device, memory_format=torch.channels_last)
        self.schedule = linear_warmup_cosine_annealing(
            learning_rate, warmup_epochs, max_epochs, eta_min=min_lr, steps_per_epoch=steps_per_epoch)
        self.optimizer = LARS(self.model.parameters(), lr=0.0, weight_decay=weight_decay, momentum=momentum)
        self.step = 0

    def init(self, seed: int) -> None:
        """Fresh weights from ``seed``; optimizer state and step count reset."""
        fresh = UNet(**self._net_kw)
        fresh.reset_parameters(torch.Generator().manual_seed(seed))
        self.model.load_state_dict(fresh.state_dict())
        self.optimizer.state.clear()
        self.step = 0

    def _autocast(self):
        return torch.autocast(self.device.type, dtype=torch.bfloat16, enabled=self.dtype == torch.bfloat16)

    def train_step(self, images: torch.Tensor, masks: torch.Tensor) -> Dict[str, object]:
        """One step on an NHWC batch. ``train/loss`` is a 0-d device tensor
        (no sync), ``lr`` a float."""
        self.model.train()
        with self._autocast():
            loss = self._loss(self.model(images), masks)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1
        return {"train/loss": loss.detach(), "lr": lr}

    @torch.no_grad()
    def logits(self, images: torch.Tensor) -> torch.Tensor:
        """Eval-mode (running-statistics) f32 NHWC logits."""
        self.model.eval()
        try:
            with self._autocast():
                return self.model(images)
        finally:
            self.model.train()

    def eval_step(self, images: torch.Tensor, masks: torch.Tensor) -> Dict[str, torch.Tensor]:
        logits = self.logits(images)
        pred = post_process_masks(logits)
        return {"loss": dice_loss(logits, masks), "dice": dice_coefficient(pred, masks),
                "iou": jaccard_index(pred, masks)}

    def predict_step(self, images: torch.Tensor) -> torch.Tensor:
        """Binarized f32 masks."""
        return post_process_masks(self.logits(images))

    def state_dict(self) -> Dict[str, object]:
        return {"step": self.step, "model": self.model.state_dict(), "optimizer": self.optimizer.state_dict()}
