"""BYOL self-supervised pretraining task. Port of ``train/byol_task.py:57-205``.

- Online ``BYOLNet`` (encoder + predictor + detached probe) and a momentum
  ``Encoder`` that starts as an exact copy of the online encoder.
- Symmetric loss by the concat trick: the online branch sees ``[v1; v2]``,
  the target branch ``[v2; v1]``, and one ``2 - 2·cos`` covers both pairings.
- The target forward runs in train mode under ``no_grad``: it updates its
  own BatchNorm running stats and nothing else.
- LARS with the linear-warmup cosine LR per step; then the EMA
  ``target ← τ·target + (1-τ)·online`` over PARAMETERS only (BN buffers of
  the target evolve from its own forwards), τ from the step count before
  the increment.
- bf16 compute through ``torch.autocast`` when ``dtype`` is bf16; f32
  parameters, loss and norms.

``embed_step`` (the KNN probe's feature pass) is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from medical_image_segmentation_tpu_torch.models.byol import BYOLNet, Encoder
from medical_image_segmentation_tpu_torch.ops.byol_loss import cosine_similarity_loss
from medical_image_segmentation_tpu_torch.ops.lars import LARS
from medical_image_segmentation_tpu_torch.ops.schedules import cosine_ema_momentum, linear_warmup_cosine_annealing


class BYOLTask:
    def __init__(
        self,
        arch: str = "resnet18",
        in_channels: int = 3,
        low_res: bool = False,
        hidden_dim: int = 4096,
        proj_dim: int = 256,
        num_classes: int = 10,
        learning_rate: float = 1.0,
        weight_decay: float = 1e-6,
        momentum: float = 0.9,
        warmup_epochs: int = 10,
        max_epochs: int = 100,
        base_ema_momentum: float = 0.99,
        final_ema_momentum: float = 1.0,
        total_steps: int = 10000,
        steps_per_epoch: int = 1,
        probe_loss_weight: float = 1.0,
        dtype: torch.dtype = torch.bfloat16,
        device="cpu",
    ):
        self.device = torch.device(device)
        self.dtype = dtype
        self._net_kw = dict(arch=arch, in_channels=in_channels, low_res=low_res,
                            hidden_dim=hidden_dim, proj_dim=proj_dim)
        self.online = BYOLNet(num_classes=num_classes, **self._net_kw)
        self.target = Encoder(**self._net_kw)
        for m in (self.online, self.target):
            m.to(self.device, memory_format=torch.channels_last)
        self.target.requires_grad_(False)
        self.total_steps = total_steps
        self.probe_loss_weight = probe_loss_weight
        self.schedule = linear_warmup_cosine_annealing(
            learning_rate, warmup_epochs, max_epochs, steps_per_epoch=steps_per_epoch, interval="step")
        self.ema_schedule = cosine_ema_momentum(base_ema_momentum, final_ema_momentum)
        self.optimizer = LARS(self.online.parameters(), lr=0.0, weight_decay=weight_decay, momentum=momentum)
        self._online_enc = list(self.online.encoder.parameters())
        self._target_enc = list(self.target.parameters())
        self.step = 0

    def init(self, seed: int) -> None:
        """Fresh weights from ``seed``; the target becomes an exact copy of
        the online encoder; optimizer state and step count reset."""
        fresh = BYOLNet(num_classes=self.online.probe.out_features, **self._net_kw)
        fresh.reset_parameters(torch.Generator().manual_seed(seed))
        self.online.load_state_dict(fresh.state_dict())
        self.target.load_state_dict(self.online.encoder.state_dict())
        self.optimizer.state.clear()
        self.step = 0

    def _autocast(self):
        return torch.autocast(self.device.type, dtype=torch.bfloat16, enabled=self.dtype == torch.bfloat16)

    def train_step(self, view1: torch.Tensor, view2: torch.Tensor,
                   labels: Optional[torch.Tensor] = None) -> Dict[str, object]:
        """One BYOL step on a two-view NHWC batch (labels optional, for the
        probe). Returns ``loss``/``probe_loss``/``probe_acc`` as 0-d device
        tensors (no sync) and ``lr``/``momentum`` as floats."""
        self.online.train()
        self.target.train()
        x_online = torch.cat([view1, view2], dim=0)
        x_target = torch.cat([view2, view1], dim=0)
        with self._autocast():
            with torch.no_grad():
                z_tgt, _ = self.target(x_target)
            p, _, _, probe_logits = self.online(x_online)
            contrastive = cosine_similarity_loss(p, z_tgt)
        zero = torch.zeros((), device=self.device)
        probe_loss, probe_acc = zero, zero
        if labels is not None:
            y = torch.cat([labels, labels], dim=0).long()
            probe_loss = F.cross_entropy(probe_logits.float(), y)
            probe_acc = (probe_logits.argmax(dim=-1) == y).float().mean()
        total = contrastive + self.probe_loss_weight * probe_loss

        self.optimizer.zero_grad(set_to_none=True)
        total.backward()
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        tau = self.ema_schedule(self.step, self.total_steps)
        with torch.no_grad():
            torch._foreach_lerp_(self._target_enc, self._online_enc, 1.0 - tau)
        self.step += 1
        return {"loss": contrastive.detach(), "probe_loss": probe_loss.detach(),
                "probe_acc": probe_acc, "lr": lr, "momentum": tau}

    @torch.no_grad()
    def val_step(self, images: torch.Tensor, labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Probe top-1/top-5 and CE on eval-mode (running-stat) features."""
        self.online.eval()
        try:
            with self._autocast():
                logits = self.online.classify(images).float()
        finally:
            self.online.train()
        labels = labels.long()
        top1 = (logits.argmax(-1) == labels).float().mean()
        k = min(5, logits.shape[-1])
        top5 = (logits.topk(k, dim=-1).indices == labels[:, None]).any(dim=-1).float().mean()
        return {"val/loss": F.cross_entropy(logits, labels), "val/acc@1": top1, "val/acc@5": top5}

    def state_dict(self) -> Dict[str, object]:
        return {"step": self.step, "online": self.online.state_dict(), "target": self.target.state_dict(),
                "optimizer": self.optimizer.state_dict()}
