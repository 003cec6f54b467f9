"""Projection / prediction MLP head: Linear → BatchNorm1d → ReLU → Linear,
with biases. Port of ``models/mlp.py:16-28``.

With a ``model_group`` of M ranks the head is tensor-parallel
(``parallel/tp.py``): ``fc1`` holds hidden/M output rows, the BatchNorm
hidden/M channels, ``fc2`` hidden/M input columns, and the partial
products of ``fc2`` are summed in f32 over the group before its bias is
added.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from medical_image_segmentation_tpu_torch.models.batchnorm import BatchNorm
from medical_image_segmentation_tpu_torch.parallel.mesh import group_size
from medical_image_segmentation_tpu_torch.parallel.tp import copy_to_group, reduce_from_group


def reset_linear(linear: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """flax's default ``Dense`` (or biased ``Conv``) init: LeCun truncated
    normal kernel (std 1/√fan_in after the ±2σ truncation), zero bias."""
    std = (1.0 / linear.weight[0].numel()) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(linear.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
    nn.init.zeros_(linear.bias)


class MLP(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int = 4096, out_dim: int = 256, model_group=None):
        super().__init__()
        tp = group_size(model_group)
        if hidden_dim % tp:
            raise ValueError(f"hidden_dim {hidden_dim} does not divide {tp} model ranks")
        self.model_group = model_group if tp > 1 else None
        self.fc1 = nn.Linear(in_dim, hidden_dim // tp)
        self.bn = BatchNorm(hidden_dim // tp)
        self.fc2 = nn.Linear(hidden_dim // tp, out_dim)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if self.model_group is not None:
            raise RuntimeError("initialize the whole head and load its slices (parallel/tp.py::shard_state_dict)")
        reset_linear(self.fc1, generator)
        reset_linear(self.fc2, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.model_group is None:
            return self.fc2(torch.relu(self.bn(self.fc1(x)))).float()
        h = torch.relu(self.bn(self.fc1(copy_to_group(x, self.model_group))))
        return reduce_from_group(F.linear(h, self.fc2.weight).float(), self.model_group) + self.fc2.bias.float()
