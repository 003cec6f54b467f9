"""Tensor-parallel BYOL heads (``--model_parallel M``). Port of
``parallel/tp.py:1-69``.

The JAX package annotates the MLP heads' leaves with shardings over a
``model`` mesh axis and lets XLA insert the Megatron pattern. Here the
pattern is written out, for the ``projector`` and ``predictor`` heads
(``models/mlp.py``) of the online and the target network:

- ``fc1`` (flax ``Dense_0``) is column-parallel: each rank of a model group
  holds hidden/M of its outputs (weight rows and bias);
- the head's BatchNorm is sharded with it (each rank normalizes its hidden
  slice; statistics reduce over the ``data`` group only);
- ``fc2`` (``Dense_1``) is row-parallel: each rank holds hidden/M of its
  input columns and contracts its slice; one all-reduce over the model
  group (``reduce_from_group``) completes the product, then the bias,
  which every rank holds whole, is added;
- the conjugate of that all-reduce: the column-parallel input's gradient is
  all-reduced over the model group in backward (``copy_to_group``), so the
  encoder below gets the gradient of the whole head on every rank.

``shard_dim`` names the sharded entries of a state dict by suffix, as
``_leaf_spec`` does by path; ``shard_tensor``/``gather_tensor`` cut a
whole tensor to a rank's slice and put the slices back together, which is
how a checkpoint stays laid out as a one-card one and loads at any M.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.distributed as dist

from medical_image_segmentation_tpu_torch.parallel.mesh import all_reduce_, group_size

_TP_MODULES = ("projector.", "predictor.")
_SHARD_DIMS = {"fc1.weight": 0, "fc1.bias": 0, "bn.weight": 0, "bn.bias": 0, "bn.running_mean": 0,
               "bn.running_var": 0, "fc2.weight": 1}


def shard_dim(name: str) -> Optional[int]:
    """The dimension along which the state-dict entry ``name`` is split over
    the model group, or None for an entry every rank holds whole."""
    if not any(m in name for m in _TP_MODULES):
        return None
    for suffix, dim in _SHARD_DIMS.items():
        if name.endswith(suffix):
            return dim
    return None


def check_model_parallel(world_size: int, model_parallel: int, hidden_dim: int) -> None:
    """The JAX trainer's refusals (``train/train_ssl.py:143-149``)."""
    if model_parallel < 1 or world_size % model_parallel:
        raise SystemExit(f"--model_parallel {model_parallel} must divide the device count {world_size}")
    if hidden_dim % model_parallel:
        raise SystemExit(f"--hidden_dim {hidden_dim} must be divisible by --model_parallel {model_parallel}")


def shard_tensor(t: torch.Tensor, dim: int, index: int, size: int) -> torch.Tensor:
    """Slice ``index`` of ``size`` equal slices of ``t`` along ``dim``."""
    if t.shape[dim] % size:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not divide {size} model ranks")
    chunk = t.shape[dim] // size
    return t.narrow(dim, index * chunk, chunk)


def gather_tensor(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The whole tensor of which every rank of ``group`` holds the slice of
    its index along ``dim`` (an all-reduce of a zero-filled buffer)."""
    n = group_size(group)
    if n == 1:
        return t
    shape = list(t.shape)
    shape[dim] *= n
    full = torch.zeros(shape, dtype=t.dtype, device=t.device)
    full.narrow(dim, dist.get_rank(group) * t.shape[dim], t.shape[dim]).copy_(t)
    return all_reduce_(full, group)


def shard_state_dict(state: Mapping[str, torch.Tensor], index: int, size: int) -> Dict[str, torch.Tensor]:
    """A whole state dict cut to the slices of model rank ``index``."""
    return {k: (shard_tensor(v, shard_dim(k), index, size) if shard_dim(k) is not None and size > 1 else v)
            for k, v in state.items()}


def gather_state_dict(state: Mapping[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """The whole state dict of which this rank holds its slices."""
    return {k: (gather_tensor(v, shard_dim(k), group) if shard_dim(k) is not None else v)
            for k, v in state.items()}


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; all-reduce of the gradient over ``group`` in
    backward (Megatron's ``f``)."""
    return x if group_size(group) == 1 else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce over ``group`` forward; identity backward (Megatron's
    ``g``)."""
    return x if group_size(group) == 1 else _ReduceFromGroup.apply(x, group)
