"""ResNet encoder family. Port of ``models/resnet.py:40-192``.

- Arch by torchvision name: all nine ``RESNET_CONFIGS``, Bottleneck with
  ``groups``/``base_width`` (ResNeXt, wide ResNet).
- Stems: the grayscale/ImageNet stem (7×7 s2 conv + 3×3 s2 max-pool) and
  the low-res CIFAR stem (3×3 s1 conv, no pool).
- Padding is symmetric, as flax's ``padding=1/3`` and the max-pool's
  ``((1,1),(1,1))``; 1×1 strided convs need none.
- Inputs are NHWC, as in the JAX package. ``x.permute(0, 3, 1, 2)`` of a
  contiguous NHWC tensor is a zero-copy channels_last NCHW view, the layout
  cuDNN wants; put the module in ``torch.channels_last`` as well.
- f32 parameters; bf16 compute comes from ``torch.autocast`` around the
  call. BatchNorm has flax semantics (``models/batchnorm.py``).
- Init: Kaiming normal (fan_out, ReLU gain) for every conv, as flax's
  ``variance_scaling(2.0, "fan_out", "normal")``.
- ``return_pyramid``: the stem output after its ReLU (before the max-pool),
  then each stage's output — strides 2/4/8/16/32, or 1/2/4/8 for
  ``low_res`` — as NHWC views of the channels_last activations, for the
  U-Net decoder (``models/unet.py``).

``remat`` is not ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch
from torch import nn

from medical_image_segmentation_tpu_torch.models.batchnorm import BatchNorm


def _conv(in_ch: int, out_ch: int, k: int, stride: int = 1, padding: int = 0, groups: int = 1) -> nn.Conv2d:
    return nn.Conv2d(in_ch, out_ch, k, stride=stride, padding=padding, groups=groups, bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(in_ch, filters, 3, stride, 1)
        self.bn1 = BatchNorm(filters)
        self.conv2 = _conv(filters, filters, 3, 1, 1)
        self.bn2 = BatchNorm(filters)
        self.has_downsample = stride != 1 or in_ch != filters
        if self.has_downsample:
            self.downsample_conv = _conv(in_ch, filters, 1, stride)
            self.downsample_bn = BatchNorm(filters)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = self.downsample_bn(self.downsample_conv(x)) if self.has_downsample else x
        return torch.relu(y + residual)


class Bottleneck(nn.Module):
    """Bottleneck with torchvision's groups/base_width semantics."""

    expansion = 4

    def __init__(self, in_ch: int, filters: int, stride: int = 1, groups: int = 1, base_width: int = 64):
        super().__init__()
        width = int(filters * (base_width / 64.0)) * groups
        out_ch = filters * self.expansion
        self.conv1 = _conv(in_ch, width, 1)
        self.bn1 = BatchNorm(width)
        self.conv2 = _conv(width, width, 3, stride, 1, groups)
        self.bn2 = BatchNorm(width)
        self.conv3 = _conv(width, out_ch, 1)
        self.bn3 = BatchNorm(out_ch)
        self.has_downsample = stride != 1 or in_ch != out_ch
        if self.has_downsample:
            self.downsample_conv = _conv(in_ch, out_ch, 1, stride)
            self.downsample_bn = BatchNorm(out_ch)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = self.downsample_bn(self.downsample_conv(x)) if self.has_downsample else x
        return torch.relu(y + residual)


# name: (block kind, stage sizes, block kwargs) — torchvision naming
RESNET_CONFIGS = {
    "resnet18": ("basic", (2, 2, 2, 2), {}),
    "resnet34": ("basic", (3, 4, 6, 3), {}),
    "resnet50": ("bottleneck", (3, 4, 6, 3), {}),
    "resnet101": ("bottleneck", (3, 4, 23, 3), {}),
    "resnet152": ("bottleneck", (3, 8, 36, 3), {}),
    "resnext50_32x4d": ("bottleneck", (3, 4, 6, 3), {"groups": 32, "base_width": 4}),
    "resnext101_32x8d": ("bottleneck", (3, 4, 23, 3), {"groups": 32, "base_width": 8}),
    "wide_resnet50_2": ("bottleneck", (3, 4, 6, 3), {"base_width": 128}),
    "wide_resnet101_2": ("bottleneck", (3, 4, 23, 3), {"base_width": 128}),
}


class ResNet(nn.Module):
    """ResNet backbone: NHWC images → (B, feature_dim) f32 pooled features."""

    def __init__(self, arch: str = "resnet18", in_channels: int = 3, low_res: bool = False):
        super().__init__()
        if arch not in RESNET_CONFIGS:
            raise ValueError(f"unknown arch {arch!r}; available: {sorted(RESNET_CONFIGS)}")
        kind, stages, block_kw = RESNET_CONFIGS[arch]
        block_cls = BasicBlock if kind == "basic" else Bottleneck
        self.low_res = low_res
        if low_res:
            self.conv1 = _conv(in_channels, 64, 3, 1, 1)
        else:
            self.conv1 = _conv(in_channels, 64, 7, 2, 3)
            self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        self.bn1 = BatchNorm(64)
        in_ch = 64
        for i, (n_blocks, filters) in enumerate(zip(stages, (64, 128, 256, 512))):
            blocks = []
            for j in range(n_blocks):
                stride = 2 if (i > 0 and j == 0) else 1
                blocks.append(block_cls(in_ch, filters, stride, **block_kw))
                in_ch = filters * block_cls.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.feature_dim = 512 * block_cls.expansion

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's init: Kaiming-normal (fan_out) convs, unit-scale BN."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu", generator=generator)

    def forward(self, x: torch.Tensor, return_pyramid: bool = False) -> Union[torch.Tensor, List[torch.Tensor]]:
        x = x.permute(0, 3, 1, 2)
        x = torch.relu(self.bn1(self.conv1(x)))
        pyramid = [x]
        if not self.low_res:
            x = self.maxpool(x)
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = stage(x)
            pyramid.append(x)
        if return_pyramid:
            return [t.permute(0, 2, 3, 1) for t in pyramid]
        return x.mean(dim=(2, 3)).float()
