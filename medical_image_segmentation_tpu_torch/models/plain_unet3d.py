"""nnU-Net's 3d_fullres network, ``PlainConvUNet`` (Isensee et al., Nature
Methods 18:203-211, 2021; ``dynamic_network_architectures``).

- encoder: ``len(features)`` stages (``enc{i}``) of [3³ conv with bias →
  InstanceNorm (affine, eps 1e-5) → LeakyReLU(0.01)] × 2; the first conv of
  every stage but the first has stride 2, and there is no other
  downsampling;
- decoder: at each level (``up{j}``, ``dec{j}``, deepest first) a 2³
  stride-2 transposed conv with bias to the skip's width, the skip
  concatenated after it, and the same double conv;
- deep supervision: a 1³ conv with bias to ``n_classes`` logits
  (``head{j}``) on every decoder output, in f32 on f32 input, outside
  autocast.

Widths double from ``features[0]`` and stop at the cap that ``features``
states (nnU-Net's 32 … 320, 320; ``nnunet_features``). InstanceNorm and
its LeakyReLU are one autograd function (``ops/instance_norm.py``): f32
statistics per sample and channel, the activation in f32 rounded once to
the compute dtype; on a card, the hand-written kernels of
``csrc/instance_norm.cu``. Under a profiler each norm and its activation is a
``mis.norm.instance`` span, and the counter ``norm.instance_values`` adds
the values it normalizes (not again in a ``remat`` recompute).

NDHWC in; training with ``deep_supervision`` returns the decoder's
outputs as NDHWC f32 logits, full resolution first; eval (or
``deep_supervision=False``) returns the full-resolution logits alone.
``channels_last_3d`` inside, so put the module in that format as well.
D, H and W must be multiples of 2^(len(features) − 1). ``remat``
checkpoints each double-conv block. Depth sharding is not supported.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch
from torch import nn

from medical_image_segmentation_tpu_torch.core.profiling import count, span
from medical_image_segmentation_tpu_torch.models.resnet import _checkpointed
from medical_image_segmentation_tpu_torch.ops.instance_norm import instance_norm_leaky_relu

NEGATIVE_SLOPE = 0.01
INSTANCE_NORM_EPS = 1e-5


def nnunet_features(base: int = 32, stages: int = 6, cap: int = 320) -> tuple:
    """nnU-Net's widths: ``base`` doubled at every stage, capped."""
    return tuple(min(base * 2 ** i, cap) for i in range(stages))


class InstanceNorm3D(nn.Module):
    """InstanceNorm over dim 1 of (B, C, D, H, W), then LeakyReLU of
    ``slope``. ``affine=False`` (MONAI's ``"instance"`` norm) holds the scale
    at 1 and the shift at 0 as buffers outside the state dict; ``slope=1``
    is the norm alone, with no activation."""

    def __init__(self, channels: int, eps: float = INSTANCE_NORM_EPS, affine: bool = True,
                 slope: float = NEGATIVE_SLOPE):
        super().__init__()
        self.eps = eps
        self.slope = slope
        if affine:
            self.weight = nn.Parameter(torch.ones(channels))
            self.bias = nn.Parameter(torch.zeros(channels))
        else:
            self.register_buffer("weight", torch.ones(channels), persistent=False)
            self.register_buffer("bias", torch.zeros(channels), persistent=False)
        self.recomputing = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("norm.instance"):
            if not self.recomputing:
                count("norm.instance_values", x.numel())
            return instance_norm_leaky_relu(x, self.weight, self.bias, self.eps, self.slope)


class PlainBlock3D(nn.Module):
    """[Conv3³ (bias) + InstanceNorm + LeakyReLU] × 2; the first conv of
    ``stride``."""

    def __init__(self, in_ch: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv3d(in_ch, filters, 3, stride=stride, padding=1)
        self.norm1 = InstanceNorm3D(filters)
        self.conv2 = nn.Conv3d(filters, filters, 3, padding=1)
        self.norm2 = InstanceNorm3D(filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm2(self.conv2(self.norm1(self.conv1(x))))


class PlainConvUNet3D(nn.Module):
    def __init__(self, in_channels: int = 1, n_classes: int = 3, features: Sequence[int] = nnunet_features(),
                 deep_supervision: bool = True, remat: bool = False):
        super().__init__()
        self.in_channels = in_channels
        self.features = tuple(features)
        self.deep_supervision = deep_supervision
        self.remat = remat
        in_ch = in_channels
        for i, f in enumerate(self.features):
            setattr(self, f"enc{i}", PlainBlock3D(in_ch, f, stride=1 if i == 0 else 2))
            in_ch = f
        for j, f in enumerate(reversed(self.features[:-1])):
            setattr(self, f"up{j}", nn.ConvTranspose3d(in_ch, f, 2, stride=2))
            setattr(self, f"dec{j}", PlainBlock3D(2 * f, f))
            setattr(self, f"head{j}", nn.Conv3d(f, n_classes, 1))
            in_ch = f

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """nnU-Net's ``InitWeights_He(1e-2)``: every conv and transposed
        conv Kaiming normal (a = 0.01, over torch's fan-in of the weight),
        biases 0; norms unit scale and zero shift."""
        for m in self.modules():
            if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d)):
                nn.init.kaiming_normal_(m.weight, a=NEGATIVE_SLOPE, generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, InstanceNorm3D):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)

    def _block(self, name: str, x: torch.Tensor) -> torch.Tensor:
        block = getattr(self, name)
        return _checkpointed(block, x) if self.remat and torch.is_grad_enabled() else block(x)

    def _head(self, j: int, y: torch.Tensor) -> torch.Tensor:
        with torch.autocast(y.device.type, enabled=False):
            return getattr(self, f"head{j}")(y.float()).permute(0, 2, 3, 4, 1)

    def forward(self, x: torch.Tensor) -> Union[torch.Tensor, List[torch.Tensor]]:
        if x.shape[-1] != self.in_channels:
            raise ValueError(f"expected {self.in_channels} input channels, got shape {tuple(x.shape)}")
        stride = 2 ** (len(self.features) - 1)
        if any(s % stride for s in x.shape[1:4]):
            raise ValueError(f"PlainConvUNet3D input D/H/W must be divisible by {stride} "
                             f"({len(self.features) - 1} stride-2 stages); got {tuple(x.shape[1:4])}")
        y = x.permute(0, 4, 1, 2, 3)
        skips = []
        for i in range(len(self.features)):
            y = self._block(f"enc{i}", y)
            skips.append(y)
        skips.pop()
        supervise = self.deep_supervision and self.training
        outs = []
        last = len(self.features) - 2
        for j in range(last + 1):
            y = getattr(self, f"up{j}")(y)
            y = torch.cat([y, skips[-(j + 1)].to(y.dtype)], dim=1)
            y = self._block(f"dec{j}", y)
            if supervise or j == last:
                outs.append(self._head(j, y))
        return outs[::-1] if supervise else outs[-1]
