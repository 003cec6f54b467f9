"""U-Net with a ResNet encoder. Port of ``models/unet.py:32-99``.

- encoder: any arch of ``RESNET_CONFIGS`` (default resnet18) with the
  grayscale stem, as ``self.encoder`` so that a BYOL backbone grafts
  straight into it (``core/checkpoint.py``);
- decoder: five ``DecoderBlock``s of (256, 128, 64, 32, 16) channels, each
  2× nearest upsample → concat ``[up, skip]`` → (3×3 conv without bias +
  BatchNorm + ReLU) × 2, with the skips at strides 16, 8, 4, 2 and none at
  stride 1;
- head: a 3×3 conv with bias (flax's default init) to ``n_classes``
  logits, no activation.

``remat`` checkpoints the encoder's residual blocks (``models/unet.py:70,88``).
NHWC in, NHWC f32 logits out; channels_last inside. H and W must be
multiples of 32 (five down/upsample stages).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from medical_image_segmentation_tpu_torch.models.batchnorm import BatchNorm
from medical_image_segmentation_tpu_torch.models.mlp import reset_linear
from medical_image_segmentation_tpu_torch.models.resnet import ResNet


def nearest_upsample(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """NCHW nearest-neighbour upsample by an integer factor: output pixel i
    reads input i // factor, as the JAX broadcast-reshape does. For an
    integer factor ``F.interpolate`` computes exactly that, and it keeps
    channels_last. It runs in ``x``'s dtype, as in JAX: CUDA autocast would
    upsample a bf16 activation in f32 and make the concat and the next
    conv convert it back."""
    with torch.autocast(x.device.type, enabled=False):
        return F.interpolate(x, scale_factor=factor, mode="nearest")


class DecoderBlock(nn.Module):
    def __init__(self, in_ch: int, skip_ch: int, filters: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch + skip_ch, filters, 3, padding=1, bias=False)
        self.bn1 = BatchNorm(filters)
        self.conv2 = nn.Conv2d(filters, filters, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(filters)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = nearest_upsample(x, 2)
        if skip is not None:
            x = torch.cat([x, skip.to(x.dtype)], dim=1)
        x = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(self.bn2(self.conv2(x)))


class UNet(nn.Module):
    def __init__(self, arch: str = "resnet18", n_classes: int = 1, in_channels: int = 1,
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16), remat: bool = False):
        super().__init__()
        self.encoder = ResNet(arch, in_channels, low_res=False, remat=remat)
        e = self.encoder.feature_dim // 512
        in_ch, blocks = 512 * e, []
        # skips deepest first: stride 16, 8, 4, the stem at 2, none at 1
        for filters, skip_ch in zip(decoder_channels, (256 * e, 128 * e, 64 * e, 64, 0)):
            blocks.append(DecoderBlock(in_ch, skip_ch, filters))
            in_ch = filters
        self.decoder = nn.ModuleList(blocks)
        self.head = nn.Conv2d(in_ch, n_classes, 3, padding=1)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's init: Kaiming-normal (fan_out) encoder and decoder convs,
        LeCun truncated normal head with a zero bias."""
        self.encoder.reset_parameters(generator)
        for m in self.decoder.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu", generator=generator)
        reset_linear(self.head, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        if h % 32 or w % 32:
            raise ValueError(
                f"U-Net input H/W must be divisible by 32 (5 down/upsample stages); got {h}x{w}. "
                f"Resize or pad the batch (e.g. segmentation_augment out_size).")
        feats = [t.permute(0, 3, 1, 2) for t in self.encoder(x, return_pyramid=True)][::-1]
        y = feats[0]
        for block, skip in zip(self.decoder, feats[1:] + [None]):
            y = block(y, skip)
        return self.head(y).permute(0, 2, 3, 1).float()
