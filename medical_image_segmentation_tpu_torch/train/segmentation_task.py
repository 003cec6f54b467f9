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
  parameters, loss and metrics;
- ``remat`` checkpoints each residual block of the encoder;
  ``state_dict``/``load_state_dict`` carry the model, optimizer and step;
- Swin UNETR's recipe (``arch="swin_unetr"`` there): ``loss="dice_ce_softmax"``
  (MONAI's squared softmax Dice + CE, no deep supervision) and
  ``optimizer="adamw"`` (torch's AdamW, betas 0.9/0.999, eps 1e-8, every
  parameter decayed) on the warmup-cosine schedule;
- nnU-Net's recipe (``train/seg3d_task.py``'s ``arch="nnunet3d"``):
  ``loss="dice_ce_ds"`` (softmax Dice + CE over the deep-supervision
  outputs, ``ops/dice.py``), ``optimizer="sgd_nesterov"`` (torch's SGD
  with Nesterov momentum and weight decay, the gradient's global norm
  clipped to nnU-Net's 12) and ``schedule="poly"`` (exponent 0.9 over
  ``max_epochs × steps_per_epoch``, per step); eval then reports the soft
  Dice loss and the hard Dice and IoU of the argmax, a foreground class
  each (``dice_class{c}``) and their means;
- under a profiler the step is a ``mis.train.step`` span holding
  ``train.forward`` (with ``seg.loss``), ``train.backward``,
  ``train.grad_exchange``, ``train.update`` and ``train.metrics``, as
  ``train/byol_task.py``'s;
- ``mesh`` (``parallel/mesh.py``) trains over the ``data`` ranks as the
  JAX task does over a sharded batch: each rank passes its rows, the
  BatchNorm statistics and the Dice sums are the global batch's, the
  gradients are averaged over the group by one bucketed all-reduce, and
  the returned loss and eval metrics are the global batch's. Under a
  ``("data", "space")`` mesh (``train/seg3d_task.py``) each rank also holds
  one depth slab: the loss, the BatchNorm statistics and the gradient mean
  then run over every rank (``"all"``), and eval over the ``data`` ranks.
"""

from __future__ import annotations

from typing import Dict

import torch

from medical_image_segmentation_tpu_torch.core.profiling import span
from medical_image_segmentation_tpu_torch.models.batchnorm import set_group
from medical_image_segmentation_tpu_torch.models.unet import UNet
from medical_image_segmentation_tpu_torch.ops.dice import (
    deep_supervised_dice_ce, deep_supervision_weights, dice_ce, dice_ce_softmax, dice_coefficient, dice_loss,
    jaccard_index, per_class_dice, per_class_jaccard, post_process_masks, softmax_dice_loss,
)
from medical_image_segmentation_tpu_torch.ops.lars import LARS
from medical_image_segmentation_tpu_torch.ops.schedules import linear_warmup_cosine_annealing, poly
from medical_image_segmentation_tpu_torch.parallel.mesh import all_reduce_mean_grads, global_mean, replicate
from medical_image_segmentation_tpu_torch.parallel.replicas import Replicas

CLIP_NORM = 12.0  # nnU-Net's bound on the gradient's global norm (SGD only)


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
        device="cuda",
        remat: bool = False,
        mesh=None,
    ):
        self._build(UNet, dict(arch=arch, n_classes=n_classes, in_channels=in_channels, remat=remat),
                    torch.channels_last, learning_rate, weight_decay, momentum, warmup_epochs, max_epochs, min_lr,
                    steps_per_epoch, loss, dtype, device, mesh)

    def _build(self, net_cls, net_kw, memory_format, learning_rate, weight_decay, momentum, warmup_epochs,
               max_epochs, min_lr, steps_per_epoch, loss, dtype, device, mesh=None, optimizer: str = "lars",
               schedule: str = "warmup_cosine") -> None:
        """Everything but the choice of network, which ``train/seg3d_task.py`` makes differently."""
        if loss not in ("dice", "dice_ce", "dice_ce_ds", "dice_ce_softmax"):
            raise ValueError(f"loss must be 'dice', 'dice_ce', 'dice_ce_ds' or 'dice_ce_softmax', got {loss!r}")
        if optimizer not in ("lars", "sgd_nesterov", "adamw"):
            raise ValueError(f"optimizer must be 'lars', 'sgd_nesterov' or 'adamw', got {optimizer!r}")
        if schedule not in ("warmup_cosine", "poly"):
            raise ValueError(f"schedule must be 'warmup_cosine' or 'poly', got {schedule!r}")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{type(self).__name__}: device {device!r} asked for, but CUDA is not "
                               "available (pass device='cpu' explicitly)")
        self.dtype = dtype
        self._net_cls, self._net_kw = net_cls, net_kw
        self.model = net_cls(**net_kw).to(self.device, memory_format=memory_format)
        self.multiclass = loss in ("dice_ce_ds", "dice_ce_softmax")
        if loss == "dice_ce_softmax":
            self._loss = dice_ce_softmax
        elif self.multiclass:
            if not getattr(self.model, "deep_supervision", False):
                raise ValueError(f"loss 'dice_ce_ds' needs a deep-supervised network, not {net_cls.__name__}")
            weights = deep_supervision_weights(len(self.model.features) - 1)
            self._loss = lambda outs, labels, group: deep_supervised_dice_ce(outs, labels, weights, group)
        else:
            self._loss = dice_ce if loss == "dice_ce" else dice_loss
        self.mesh = mesh
        self._axis = "all" if mesh is not None and mesh.size("space") > 1 else "data"
        self._group = mesh.group(self._axis) if mesh is not None else None
        self._eval_group = mesh.group("data") if mesh is not None else None
        set_group((self.model,), self._group)
        if schedule == "poly":
            self.schedule = poly(learning_rate, max_epochs * steps_per_epoch)
        else:
            self.schedule = linear_warmup_cosine_annealing(
                learning_rate, warmup_epochs, max_epochs, eta_min=min_lr, steps_per_epoch=steps_per_epoch)
        self.clip_norm = CLIP_NORM if optimizer == "sgd_nesterov" else None
        if optimizer == "sgd_nesterov":
            self.optimizer = torch.optim.SGD(self.model.parameters(), lr=0.0, momentum=momentum, nesterov=True,
                                             weight_decay=weight_decay, foreach=True)
        elif optimizer == "adamw":
            self.optimizer = torch.optim.AdamW(self.model.parameters(), lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                               weight_decay=weight_decay, foreach=True)
        else:
            self.optimizer = LARS(self.model.parameters(), lr=0.0, weight_decay=weight_decay, momentum=momentum)
        self.step = 0

    def init(self, seed: int) -> None:
        """Fresh weights from ``seed``; optimizer state and step count reset."""
        fresh = self._net_cls(**self._net_kw)
        fresh.reset_parameters(torch.Generator().manual_seed(seed))
        self.model.load_state_dict(fresh.state_dict())
        replicate(self.model.state_dict().values(), self.mesh, self._axis)
        self.optimizer.state.clear()
        self.step = 0

    def _autocast(self):
        return torch.autocast(self.device.type, dtype=torch.bfloat16, enabled=self.dtype == torch.bfloat16)

    def train_step(self, images: torch.Tensor, masks: torch.Tensor) -> Dict[str, object]:
        """One step on a channels-last batch. ``train/loss`` is a 0-d device tensor
        (no sync), ``lr`` a float."""
        self.model.train()
        with span("train.step"):
            with span("train.forward"):
                with self._autocast():
                    out = self.model(images)
                    with span("seg.loss"):
                        loss = self._loss(out, masks, group=self._group)
            with span("train.backward"):
                self.optimizer.zero_grad(set_to_none=True)
                loss.backward()
            with span("train.grad_exchange"):
                all_reduce_mean_grads(self.model.parameters(), self._group)
            with span("train.update"):
                if self.clip_norm is not None:
                    torch.nn.utils.clip_grad_norm_(self.model.parameters(), self.clip_norm, foreach=True)
                lr = self.schedule(self.step)
                for group in self.optimizer.param_groups:
                    group["lr"] = lr
                self.optimizer.step()
            self.step += 1
            with span("train.metrics"):
                loss = global_mean(loss.detach(), self._group)
        return {"train/loss": loss, "lr": lr}

    @torch.no_grad()
    def logits(self, images: torch.Tensor) -> torch.Tensor:
        """Eval-mode (running-statistics) f32 channels-last logits."""
        self.model.eval()
        try:
            return self._eval_forward(self.model, images)
        finally:
            self.model.train()

    def _eval_forward(self, model: torch.nn.Module, images: torch.Tensor) -> torch.Tensor:
        with torch.autocast(images.device.type, dtype=torch.bfloat16, enabled=self.dtype == torch.bfloat16):
            return model(images)

    def replicas(self, devices) -> Replicas:
        """Eval-mode copies of the network on ``devices`` that compute
        ``logits`` with each batch split over them (one process on every
        local card)."""
        return Replicas(self.model, devices, self._eval_forward)

    def eval_step(self, images: torch.Tensor, masks: torch.Tensor) -> Dict[str, torch.Tensor]:
        logits = self.logits(images)
        if self.multiclass:
            g = self._eval_group
            dice, iou = per_class_dice(logits, masks, group=g), per_class_jaccard(logits, masks, group=g)
            out = {"loss": softmax_dice_loss(logits, masks, group=g), "dice": dice.mean(), "iou": iou.mean()}
            out.update({f"dice_class{c + 1}": d for c, d in enumerate(dice)})
            return out
        pred = post_process_masks(logits)
        return {"loss": dice_loss(logits, masks, group=self._eval_group),
                "dice": dice_coefficient(pred, masks, group=self._eval_group),
                "iou": jaccard_index(pred, masks, group=self._eval_group)}

    def predict_step(self, images: torch.Tensor) -> torch.Tensor:
        """Binarized f32 masks."""
        return post_process_masks(self.logits(images))

    def state_dict(self) -> Dict[str, object]:
        return {"step": self.step, "model": self.model.state_dict(), "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: Dict[str, object]) -> None:
        """The inverse of ``state_dict``; other keys are ignored. A
        checkpoint converted from the JAX package holds no ``optimizer``:
        the optimizer then starts fresh."""
        self.model.load_state_dict(state["model"])
        self.optimizer.state.clear()
        if "optimizer" in state:
            self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
