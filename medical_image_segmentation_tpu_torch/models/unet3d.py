"""Volumetric 3D U-Net. Port of ``models/unet3d.py:39-155``.

- encoder: ``len(features)`` stages of [3³ conv without bias + norm + ReLU]
  × 2 (``enc{i}``), each but the last followed by a stride-2 3³ conv with a
  symmetric pad of 1 (``down{i}``);
- decoder: mirror stages (``dec{i}``) of nearest 2× upsample → concat
  ``[up, skip]`` → the same double conv;
- head: a 1³ conv with bias to ``n_classes`` logits, in f32 on f32 input,
  outside autocast.

``UNet3DEncoder`` is the encoder half alone, with the same block names, so
a volumetric BYOL backbone grafts into a ``UNet3D`` key by key
(``core/checkpoint.py::load_byol3d_encoder_into_unet3d``); it returns the
f32 mean over D, H, W of the bottleneck.

Norm: GroupNorm of ``min(8, filters)`` groups by default, with flax's
epsilon of 1e-6 (torch's default is 1e-5) and flax's dtypes: f32
statistics (the biased variance), the result rounded to the compute dtype
before the ReLU. It is written on the channels-last
view with torch's reductions, so the activations keep one layout from the
first conv to the head; ``F.group_norm`` would return them contiguous in
f32 and every following conv would convert them back. ``norm="batch"`` is
``models/batchnorm.py``.

NDHWC in, NDHWC f32 logits out; ``channels_last_3d`` inside, so put the
module in that format as well. D, H and W must be multiples of
2^(len(features) − 1). ``remat`` checkpoints each double-conv block.

Depth sharding (``set_space_group``): each rank of a ``space`` group holds
one contiguous depth slab of every activation, as the JAX package's
``spatial_sharding`` lays volumes out. The 3³ stride-1 convolutions then
take a halo of one slice on each side from the neighbours
(``parallel/spatial.py``) and run with no depth padding; the stride-2
``down{i}`` convolutions take one slice on the left only (output ``o``
reads inputs 2o−1 … 2o+1 and a slab starts at an even index); GroupNorm
sums (Σx, Σx²) over the group and takes flax's fast variance
max(0, E[x²] − E[x]²), the reference's own formula. The upsample, the skip
concat and the 1³ head are local. Every slab at every level must have an
even depth, so the slab's depth must divide by 2^(len(features) − 1). The
parameter names do not change.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from medical_image_segmentation_tpu_torch.models.batchnorm import BatchNorm
from medical_image_segmentation_tpu_torch.models.mlp import reset_linear
from medical_image_segmentation_tpu_torch.models.resnet import _checkpointed
from medical_image_segmentation_tpu_torch.parallel.mesh import all_reduce_sum, group_size
from medical_image_segmentation_tpu_torch.parallel.spatial import halo_exchange


def nearest_upsample_3d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """NCDHW nearest-neighbour upsample by an integer factor, as the JAX
    broadcast-reshape on the NDHWC view: one copy, in ``x``'s dtype, and
    the result is channels_last_3d."""
    b, c, d, h, w = x.shape
    v = x.permute(0, 2, 3, 4, 1)[:, :, None, :, None, :, None, :]
    v = v.expand(b, d, factor, h, factor, w, factor, c).reshape(b, d * factor, h * factor, w * factor, c)
    return v.permute(0, 4, 1, 2, 3)


def group_norm(x: torch.Tensor, groups: int, weight: torch.Tensor, bias: torch.Tensor, eps: float,
               space_group=None) -> torch.Tensor:
    """flax's GroupNorm over dim 1 of (B, C, ...) ``x``: f32 statistics per
    sample and group, the result in ``x``'s dtype and layout. With
    ``space_group`` ``x`` is a depth slab and the statistics are the whole
    volume's: (Σx, Σx²) summed over the group, fast variance."""
    b, c = x.shape[:2]
    per = c // groups
    with torch.autocast(x.device.type, enabled=False):
        xs = x.movedim(1, -1)  # (B, ..., C): contiguous when x is channels-last
        xg = xs.reshape(b, -1, groups, per).float()
        if space_group is None:
            var, mean = torch.var_mean(xg, dim=(1, 3), correction=0)          # (B, G)
        else:
            sums = all_reduce_sum(torch.stack([xg.sum(dim=(1, 3)), xg.square().sum(dim=(1, 3))], dim=-1),
                                  space_group)                                  # (B, G, 2)
            moments = sums / (xg.shape[1] * per * group_size(space_group))
            mean = moments[..., 0]
            var = (moments[..., 1] - mean.square()).clamp_min(0.0)
        rstd = torch.rsqrt(var + eps)
        scale = rstd.repeat_interleave(per, dim=1) * weight.float()            # (B, C)
        shift = bias.float() - mean.repeat_interleave(per, dim=1) * scale
        bc = (b,) + (1,) * (x.dim() - 2) + (c,)
        return (xs * scale.view(bc) + shift.view(bc)).to(x.dtype).movedim(-1, 1)


class GroupNorm(nn.Module):
    def __init__(self, groups: int, channels: int, eps: float = 1e-6):
        super().__init__()
        if channels % groups:
            raise ValueError(f"{channels} channels do not divide into {groups} groups")
        self.groups = groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.space_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.groups, self.weight, self.bias, self.eps, self.space_group)


def _norm(kind: str, filters: int, groups: int) -> nn.Module:
    if kind == "batch":
        return BatchNorm(filters)
    if kind == "group":
        return GroupNorm(min(groups, filters), filters)
    raise ValueError(f"norm must be 'group' or 'batch', got {kind!r}")


def _conv3(in_ch: int, out_ch: int, stride: int = 1) -> nn.Conv3d:
    return nn.Conv3d(in_ch, out_ch, 3, stride=stride, padding=1, bias=False)


def _sharded_conv(conv: nn.Conv3d, x: torch.Tensor, space_group) -> torch.Tensor:
    """``conv`` (3³, padding 1) on a depth slab: the neighbours' halo, then
    no depth padding. Stride 1 takes one slice on each side, stride 2 one
    on the left only."""
    if space_group is None:
        return conv(x)
    x = halo_exchange(x, space_group, 1, 1 if conv.stride[0] == 1 else 0)
    return F.conv3d(x, conv.weight, conv.bias, conv.stride, (0, 1, 1))


class ConvBlock3D(nn.Module):
    """[Conv3³ + Norm + ReLU] × 2."""

    def __init__(self, in_ch: int, filters: int, norm: str = "group", groups: int = 8):
        super().__init__()
        self.conv1 = _conv3(in_ch, filters)
        self.norm1 = _norm(norm, filters, groups)
        self.conv2 = _conv3(filters, filters)
        self.norm2 = _norm(norm, filters, groups)
        self.space_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, norm in ((self.conv1, self.norm1), (self.conv2, self.norm2)):
            y = _sharded_conv(conv, x, self.space_group)
            x = torch.relu(norm(y).to(y.dtype))  # the conv's dtype is the compute dtype
        return x


def _reset_convs(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """flax's init: Kaiming-normal (fan_out) 3³ convs, unit-scale norms."""
    for m in module.modules():
        if isinstance(m, nn.Conv3d) and m.bias is None:
            nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu", generator=generator)


class _Encoder3D(nn.Module):
    """``enc{i}`` and ``down{i}`` of both networks, and their walk down."""

    def __init__(self, in_channels: int, features: Sequence[int], norm: str, remat: bool):
        super().__init__()
        self.in_channels = in_channels
        self.features = tuple(features)
        self.remat = remat
        self.space_group = None
        in_ch = in_channels
        for i, f in enumerate(self.features):
            setattr(self, f"enc{i}", ConvBlock3D(in_ch, f, norm))
            if i < len(self.features) - 1:
                setattr(self, f"down{i}", _conv3(f, f, stride=2))
            in_ch = f

    def _check_channels(self, x: torch.Tensor) -> None:
        if x.shape[-1] != self.in_channels:
            raise ValueError(f"expected {self.in_channels} input channels, got shape {tuple(x.shape)}")

    def _block(self, name: str, x: torch.Tensor) -> torch.Tensor:
        block = getattr(self, name)
        return _checkpointed(block, x) if self.remat and torch.is_grad_enabled() else block(x)

    def _encode(self, x: torch.Tensor):
        """The bottleneck and the skips (shallowest first) of NDHWC ``x``,
        as NCDHW channels_last_3d tensors."""
        x = x.permute(0, 4, 1, 2, 3)
        skips = []
        for i in range(len(self.features)):
            x = self._block(f"enc{i}", x)
            if i < len(self.features) - 1:
                skips.append(x)
                x = _sharded_conv(getattr(self, f"down{i}"), x, self.space_group)
        return x, skips


class UNet3DEncoder(_Encoder3D):
    """The encoder half as a backbone: NDHWC volumes → (B, features[-1])
    f32 pooled features."""

    def __init__(self, in_channels: int = 1, features: Sequence[int] = (32, 64, 128, 256), norm: str = "group",
                 remat: bool = False):
        super().__init__(in_channels, features, norm, remat)
        self.feature_dim = self.features[-1]

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _reset_convs(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_channels(x)
        return self._encode(x)[0].mean(dim=(2, 3, 4), dtype=torch.float32)


class UNet3D(_Encoder3D):
    def __init__(self, n_classes: int = 1, in_channels: int = 1, features: Sequence[int] = (32, 64, 128, 256),
                 norm: str = "group", remat: bool = False):
        super().__init__(in_channels, features, norm, remat)
        in_ch = self.features[-1]
        for i, f in enumerate(reversed(self.features[:-1])):
            setattr(self, f"dec{i}", ConvBlock3D(in_ch + f, f, norm))
            in_ch = f
        self.head = nn.Conv3d(in_ch, n_classes, 1)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Kaiming-normal 3³ convs; LeCun truncated normal head, zero bias."""
        _reset_convs(self, generator)
        reset_linear(self.head, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_channels(x)
        stride = 2 ** (len(self.features) - 1)
        d, h, w = x.shape[1:4]
        if self.space_group is not None and d % stride:
            raise ValueError(
                f"UNet3D depth slab of {d} over {group_size(self.space_group)} space ranks: the crop depth must "
                f"divide by space ranks x {stride} ({len(self.features) - 1} down/upsample stages), so that every "
                "slab at every level has an even depth")
        if d % stride or h % stride or w % stride:
            raise ValueError(
                f"UNet3D input D/H/W must be divisible by {stride} "
                f"({len(self.features) - 1} down/upsample stages); got {d}x{h}x{w}.")
        y, skips = self._encode(x)
        for i in range(len(self.features) - 1):
            y = nearest_upsample_3d(y, 2)
            y = torch.cat([y, skips[-(i + 1)].to(y.dtype)], dim=1)
            y = self._block(f"dec{i}", y)
        with torch.autocast(y.device.type, enabled=False):
            return self.head(y.float()).permute(0, 2, 3, 4, 1)


def set_space_group(model: nn.Module, group) -> None:
    """Run ``model`` (a ``UNet3D``) on depth slabs sharded over ``group``:
    halo-exchanged convolutions and GroupNorm statistics summed over it. A
    group of one (or None) runs it whole."""
    group = group if group_size(group) > 1 else None
    for m in model.modules():
        if isinstance(m, (_Encoder3D, ConvBlock3D, GroupNorm)):
            m.space_group = group
