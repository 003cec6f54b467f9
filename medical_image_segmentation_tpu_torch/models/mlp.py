"""Projection / prediction MLP head: Linear → BatchNorm1d → ReLU → Linear,
with biases. Port of ``models/mlp.py:16-28``."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from medical_image_segmentation_tpu_torch.models.batchnorm import BatchNorm


def reset_linear(linear: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """flax's default ``Dense`` (or biased ``Conv``) init: LeCun truncated
    normal kernel (std 1/√fan_in after the ±2σ truncation), zero bias."""
    std = (1.0 / linear.weight[0].numel()) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(linear.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
    nn.init.zeros_(linear.bias)


class MLP(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int = 4096, out_dim: int = 256):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden_dim)
        self.bn = BatchNorm(hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, out_dim)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        reset_linear(self.fc1, generator)
        reset_linear(self.fc2, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(torch.relu(self.bn(self.fc1(x)))).float()
