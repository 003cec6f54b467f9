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

Data-parallel training sets ``group`` (``set_group``): the statistics are
then the global batch's, as XLA makes them over a sharded batch. The
forward all-reduces the f32 (sum, sum of squares, count) over the group
and takes flax's variance E[x²] − E[x]²; the backward all-reduces
(Σdy, Σdy·x̂) for the input's gradient, while the scale's and bias's
gradients stay this rank's sums (the trainer averages every gradient over
the group afterwards). The running statistics take the global mean and
biased variance. With no group (one card) the cuDNN call above runs as
before. Under a profiler the global path's three parts are spans
(``bn.global_stats``, ``bn.global_normalize``, ``bn.global_backward``, the
last on autograd's thread); the eval and one-card paths have none.
"""

from __future__ import annotations

import contextlib
from typing import Iterable, Iterator

import torch
import torch.nn.functional as F
from torch import nn

from medical_image_segmentation_tpu_torch.core.profiling import span
from medical_image_segmentation_tpu_torch.parallel.mesh import all_reduce_, group_size


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
        self.group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        if self.group is not None:
            return self._global_forward(x)
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

    def _global_forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[1]
        dims = [0, *range(2, x.ndim)]
        with span("bn.global_stats"), torch.no_grad():
            xf = x.float()
            stats = torch.cat([xf.sum(dims), xf.square().sum(dims),
                               torch.full((1,), x.numel() // c, dtype=torch.float32, device=x.device)])
            all_reduce_(stats, self.group)
            n = stats[-1]
            mean = stats[:c] / n
            var = (stats[c:2 * c] / n - mean.square()).clamp_min(0.0)
            if not self.recomputing:
                self.running_mean.mul_(self.momentum).add_(mean, alpha=1.0 - self.momentum)
                self.running_var.mul_(self.momentum).add_(var, alpha=1.0 - self.momentum)
            invstd = torch.rsqrt(var + self.eps)
        return _GlobalNormalize.apply(x, self.weight, self.bias, mean, invstd, n, self.group)


class _GlobalNormalize(torch.autograd.Function):
    """``(x − mean)·invstd·weight + bias`` with global statistics; the
    backward all-reduces the two sums the input's gradient needs."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, invstd, n, group):
        with span("bn.global_normalize"):
            shape = (1, -1) + (1,) * (x.ndim - 2)
            xhat = (x.float() - mean.view(shape)) * invstd.view(shape)
            ctx.save_for_backward(x, weight, mean, invstd, n)
            ctx.group = group
            return (xhat * weight.view(shape) + bias.view(shape)).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        with span("bn.global_backward"):
            x, weight, mean, invstd, n = ctx.saved_tensors
            shape = (1, -1) + (1,) * (x.ndim - 2)
            dims = [0, *range(2, x.ndim)]
            c = x.shape[1]
            dyf = dy.float()
            xhat = (x.float() - mean.view(shape)) * invstd.view(shape)
            local = torch.cat([dyf.sum(dims), (dyf * xhat).sum(dims)])
            grad_bias, grad_weight = local[:c].clone(), local[c:].clone()
            sums = all_reduce_(local, ctx.group)
            dx = (weight * invstd).view(shape) * (dyf - (sums[:c] / n).view(shape) - xhat * (sums[c:] / n).view(shape))
            return dx.to(x.dtype), grad_weight, grad_bias, None, None, None, None


def set_group(modules: Iterable[torch.nn.Module], group) -> None:
    """Take the training statistics of every ``BatchNorm`` under
    ``modules`` over ``group`` (the data-parallel ranks); a group of one
    (or None) keeps the local statistics."""
    group = group if group_size(group) > 1 else None
    for mod in modules:
        for m in mod.modules():
            if isinstance(m, BatchNorm):
                m.group = group


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
