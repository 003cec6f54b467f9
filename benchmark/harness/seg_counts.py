"""Operations and bytes of the segmentation training cells, from the
configuration's shapes alone.

A training step's FLOPs are three forwards (the forward, and a backward of
twice its work: the gradients of the inputs and of the weights), each
forward counted by ``torch.utils.flop_counter.FlopCounterMode`` over the
benchmark's plain networks on the ``meta`` device (convolutions, transposed
convolutions and matrix products; nothing run).

InstanceNorm's forward, with the LeakyReLU after it, needs at the least to
read each convolution's output once and write the activation once, in the
configuration's dtype: two values moved for each value it normalizes.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import counts
from benchmark.reference import nnunet3d


def unet_train_flops(cfg: dict, batch: int) -> float:
    """One U-Net(resnet18) step on ``batch`` slices."""
    return 3.0 * counts.unet_forward_flops(cfg, batch)


def nnunet_forward_flops(cfg: dict, batch: int) -> float:
    """One forward of nnU-Net's network (every deep-supervision head) over
    ``batch`` crops of ``cfg["patch"]``."""
    P = {k: torch.empty(s, device="meta") for k, s in nnunet3d.layout(cfg).items()}
    x = torch.empty(batch, *cfg["patch"], cfg["in_channels"], device="meta")
    with FlopCounterMode(display=False) as counter:
        nnunet3d.forward(x, P)
    return float(counter.get_total_flops())


def nnunet_train_flops(cfg: dict, batch: int) -> float:
    return 3.0 * nnunet_forward_flops(cfg, batch)


def instance_norm_values(cfg: dict, batch: int) -> int:
    """Values the InstanceNorms normalize in one forward: two a block, at
    every encoder stage and every decoder level, batch × width × voxels."""
    total = 0
    for i, f in enumerate(cfg["features"]):
        voxels = 1
        for s in cfg["patch"]:
            voxels *= s // 2 ** i
        levels = 2 if i < len(cfg["features"]) - 1 else 1  # the bottleneck has no decoder level
        total += levels * 2 * batch * f * voxels
    return total


def instance_norm_fwd_bytes(cfg: dict, batch: int) -> int:
    """Bytes InstanceNorm + LeakyReLU's forward needs: each value read and
    written once in the configuration's dtype."""
    return 2 * getattr(torch, cfg["dtype"]).itemsize * instance_norm_values(cfg, batch)
