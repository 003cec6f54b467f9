"""BatchNorm with flax.linen semantics, shared by the ResNet and MLP heads.

flax's ``BatchNorm`` and ``torch.nn.BatchNorm*d`` differ in two ways that
the port must not inherit from torch:

- flax ``momentum=0.9`` keeps 0.9 of the old running stat; torch's
  ``momentum`` is the weight of the new one (0.1 here);
- flax updates the running variance with the biased batch variance, torch
  with the unbiased one (× n/(n-1)).

The normalization itself is ``F.batch_norm`` (cuDNN on the card). For the
running variance we hand it a copy scaled by k = n/(n-1) and scale the
result back: torch then computes ``k·(m·rv + (1-m)·var_biased)``, so the
buffer ends at exactly flax's update, with no second pass over the
activations to recompute the batch statistics.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.Module):
    """Batch norm over dim 1 of (N, C, ...) inputs. ``momentum`` is flax's
    (the share of the old running stat); f32 parameters and buffers."""

    def __init__(self, num_features: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        n = x.numel() // x.shape[1]
        if n < 2:
            raise ValueError(f"BatchNorm needs more than one value per channel in training, got {n}")
        k = n / (n - 1)
        with torch.no_grad():
            scaled_var = self.running_var * k
        y = F.batch_norm(x, self.running_mean, scaled_var, self.weight, self.bias,
                         True, 1.0 - self.momentum, self.eps)
        with torch.no_grad():
            self.running_var.copy_(scaled_var / k)
        return y
