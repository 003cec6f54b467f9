"""BatchNorm with flax.linen semantics, shared by the ResNet and MLP heads.

flax's ``BatchNorm`` and ``torch.nn.BatchNorm*d`` differ in two ways that
the port must not inherit from torch:

- flax ``momentum=0.9`` keeps 0.9 of the old running stat; torch's
  ``momentum`` is the weight of the new one (0.1 here);
- flax updates the running variance with the biased batch variance, torch
  with the unbiased one (× n/(n-1)).

On one card (no ``group``) training BatchNorm runs the hand-written
kernels of ``ops/global_batchnorm.py`` on a CUDA tensor they take
(``takes``: bf16 or float32, 2-D, channels_last or channels_last_3d):
statistics, then normalize with flax's running-statistics update in its
prologue, and in the backward the two sums and dx, with no all-reduce
between them (``_LocalNormalize``). A CPU tensor, or a card tensor in a
layout the kernels refuse, keeps ``F.batch_norm`` (cuDNN on the card).
For its running variance we hand it a copy scaled by k = n/(n-1) and
scale the result back: torch then computes ``k·(m·rv + (1-m)·var_biased)``,
so the buffer ends at exactly flax's update, with no second pass over the
activations to recompute the batch statistics.

Under ``--remat`` (``torch.utils.checkpoint`` around each residual block)
the block's forward runs a second time during backward. That run sets
``recomputing``: it normalizes exactly as the first (same kernels, batch
statistics) but leaves the running statistics alone (or moves throwaway
copies of them), so the momentum is applied once per step, as flax's
``nn.remat`` does.

Data-parallel training sets ``group`` (``set_group``): the statistics are
then the global batch's, as XLA makes them over a sharded batch. The
forward all-reduces the f32 (sum, sum of squares, count) over the group
and takes flax's variance E[x²] − E[x]²; the backward all-reduces
(Σdy, Σdy·x̂) for the input's gradient, while the scale's and bias's
gradients stay this rank's sums (the trainer averages every gradient over
the group afterwards). The running statistics take the global mean and
biased variance. The passes are ``ops/global_batchnorm.py``'s: the
hand-written kernels on the card, their plain float32 versions on the CPU.
Under a profiler the global path's three parts are spans
(``bn.global_stats``, ``bn.global_normalize``, ``bn.global_backward``, the
last on autograd's thread) and the one-card kernels' forward is
``bn.local``; the eval path and ``F.batch_norm`` have none.
"""

from __future__ import annotations

import contextlib
from typing import Iterable, Iterator

import torch
import torch.nn.functional as F
from torch import nn

from medical_image_segmentation_tpu_torch.core.profiling import span
from medical_image_segmentation_tpu_torch.ops import global_batchnorm
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
        if global_batchnorm.takes(x):
            return _LocalNormalize.apply(x, self.weight, self.bias, self)
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
        with span("bn.global_stats"), torch.no_grad():
            stats = all_reduce_(global_batchnorm.batch_stats(x), self.group)
        return _GlobalNormalize.apply(x, self.weight, self.bias, stats, self)


class _GlobalNormalize(torch.autograd.Function):
    """``(x − mean)·invstd·weight + bias`` with the statistics of the
    all-reduced (Σx, Σx², n), which also move ``bn``'s running statistics
    unless it is recomputing; the backward all-reduces the two sums the
    input's gradient needs."""

    @staticmethod
    def forward(ctx, x, weight, bias, stats, bn):
        with span("bn.global_normalize"):
            running = None if bn.recomputing else (bn.running_mean, bn.running_var)
            y, mean, invstd = global_batchnorm.normalize(x, weight, bias, stats, bn.eps, bn.momentum, running)
            ctx.save_for_backward(x, weight, mean, invstd, stats[-1:])
            ctx.group = bn.group
            return y

    @staticmethod
    def backward(ctx, dy):
        with span("bn.global_backward"):
            x, weight, mean, invstd, n = ctx.saved_tensors
            sums, grad_weight, grad_bias = global_batchnorm.backward_reduce(x, dy, mean, invstd)
            all_reduce_(sums, ctx.group)
            dx = global_batchnorm.backward_elemt(x, dy, weight, mean, invstd, sums, n)
            return dx, grad_weight, grad_bias, None, None


class _LocalNormalize(torch.autograd.Function):
    """``_GlobalNormalize`` on one card: the statistics are this batch's,
    with no all-reduce before the normalize or between the backward's
    passes."""

    @staticmethod
    def forward(ctx, x, weight, bias, bn):
        with span("bn.local"):
            stats = global_batchnorm.batch_stats(x, local=True)
            running = None if bn.recomputing else (bn.running_mean, bn.running_var)
            y, mean, invstd = global_batchnorm.normalize(x, weight, bias, stats, bn.eps, bn.momentum, running,
                                                         local=True)
            ctx.save_for_backward(x, weight, mean, invstd, stats[-1:])
            return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd, n = ctx.saved_tensors
        sums, grad_weight, grad_bias = global_batchnorm.backward_reduce(x, dy, mean, invstd, local=True)
        dx = global_batchnorm.backward_elemt(x, dy, weight, mean, invstd, sums, n, local=True)
        return dx, grad_weight, grad_bias, None


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
    """Mark every module under ``modules`` that has a ``recomputing`` flag
    (``BatchNorm``; ``models/plain_unet3d.py``'s InstanceNorm) as
    recomputing for the duration: running statistics and counters stay as
    they are."""
    bns = [m for mod in modules for m in mod.modules() if hasattr(m, "recomputing")]
    for m in bns:
        m.recomputing = True
    try:
        yield
    finally:
        for m in bns:
            m.recomputing = False
