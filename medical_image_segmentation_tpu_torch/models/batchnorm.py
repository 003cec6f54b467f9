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

Under ``--remat`` (``torch.utils.checkpoint`` around each residual block)
the block's forward runs a second time during backward. That run sets
``recomputing``: it normalizes exactly as the first (same kernel, batch
statistics) but into throwaway copies of the running statistics, so the
momentum is applied once per step, as flax's ``nn.remat`` does.
"""

from __future__ import annotations

import contextlib
from typing import Iterable, Iterator

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
        self.recomputing = False

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
            running_mean = self.running_mean.clone() if self.recomputing else self.running_mean
        y = F.batch_norm(x, running_mean, scaled_var, self.weight, self.bias,
                         True, 1.0 - self.momentum, self.eps)
        if not self.recomputing:
            with torch.no_grad():
                self.running_var.copy_(scaled_var / k)
        return y


@contextlib.contextmanager
def recomputing(modules: Iterable[torch.nn.Module]) -> Iterator[None]:
    """Mark every ``BatchNorm`` under ``modules`` as recomputing for the
    duration: their running statistics stay as they are."""
    bns = [m for mod in modules for m in mod.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.recomputing = True
    try:
        yield
    finally:
        for m in bns:
            m.recomputing = False
