"""Linear probe on frozen features. Port of ``eval/linear_probe.py:25-77``.

A Flatten → Dropout → Linear head with its own Adam(1e-4), trained with
cross-entropy on detached encoder features. ``torch.optim.Adam`` makes
optax's ``adam`` update (ε added outside the square root of the
bias-corrected second moment), so both packages take the same steps from
the same head weights (``core/convert.py::probe_flax_to_state_dict``).
Dropout draws its masks from an explicit ``torch.Generator``, the
counterpart of the JAX probe's ``rng`` in its state.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from medical_image_segmentation_tpu_torch.models.mlp import reset_linear


class _Head(nn.Module):
    def __init__(self, feature_dim: int, num_classes: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.linear = nn.Linear(feature_dim, num_classes)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        if generator is not None and self.dropout > 0:
            # flax's Dropout: keep with probability 1 - rate, scale the kept by 1/(1 - rate)
            keep = torch.rand(x.shape, generator=generator, device=x.device) >= self.dropout
            x = torch.where(keep, x / (1.0 - self.dropout), torch.zeros((), device=x.device))
        return self.linear(x)


class LinearProbe:
    def __init__(self, feature_dim: int, num_classes: int, dropout: float = 0.0, lr: float = 1e-4,
                 device="cuda", generator: Optional[torch.Generator] = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{type(self).__name__}: device {device!r} asked for, but CUDA is not "
                               "available (pass device='cpu' explicitly)")
        if dropout > 0 and generator is None:
            raise ValueError("dropout > 0 needs a generator for its masks")
        self.feature_dim = feature_dim
        self.generator = generator
        self.head = _Head(feature_dim, num_classes, dropout).to(self.device)
        self.optimizer = torch.optim.Adam(self.head.parameters(), lr=lr)

    def init(self, seed: int) -> None:
        """Fresh head weights from ``seed`` (flax's ``Dense`` init); the
        optimizer state resets. Drawn on the CPU, so a seed gives the same
        head on every device."""
        linear = self.head.linear
        fresh = nn.Linear(linear.in_features, linear.out_features, device="meta").to_empty(device="cpu")
        reset_linear(fresh, torch.Generator().manual_seed(seed))
        linear.load_state_dict(fresh.state_dict())
        self.optimizer.state.clear()

    def _metrics(self, logits: torch.Tensor, labels: torch.Tensor):
        labels = labels.long()
        return F.cross_entropy(logits, labels), (logits.argmax(dim=-1) == labels).float().mean()

    def train_step(self, feats: torch.Tensor, labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One Adam step on stop-gradient f32 features; metrics as 0-d
        device tensors."""
        logits = self.head(feats.detach().float(), self.generator)
        loss, acc = self._metrics(logits, labels)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return {"online_train_loss": loss.detach(), "online_train_acc": acc}

    @torch.no_grad()
    def eval_step(self, feats: torch.Tensor, labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        loss, acc = self._metrics(self.head(feats.float()), labels)
        return {"online_val_loss": loss, "online_val_acc": acc}
