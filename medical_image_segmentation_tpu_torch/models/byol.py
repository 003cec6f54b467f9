"""BYOL network modules. Port of ``models/byol.py:33-117``.

``Encoder`` = ResNet backbone + projector MLP. ``BYOLNet`` = the online
encoder + predictor MLP + a linear probe fed with detached backbone
features, so the probe never trains the backbone. The momentum ("target")
encoder is a second ``Encoder`` that ``train/byol_task.py`` EMA-updates.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from medical_image_segmentation_tpu_torch.models.mlp import MLP, reset_linear
from medical_image_segmentation_tpu_torch.models.resnet import ResNet


class Encoder(nn.Module):
    def __init__(self, arch: str = "resnet18", in_channels: int = 3, low_res: bool = False,
                 hidden_dim: int = 4096, proj_dim: int = 256):
        super().__init__()
        self.backbone = ResNet(arch, in_channels, low_res)
        self.projector = MLP(self.backbone.feature_dim, hidden_dim, proj_dim)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.backbone.reset_parameters(generator)
        self.projector.reset_parameters(generator)

    def forward(self, x: torch.Tensor, return_embedding: bool = False):
        """Projection z and pooled features, or only the features."""
        feats = self.backbone(x)
        if return_embedding:
            return feats
        return self.projector(feats), feats


class BYOLNet(nn.Module):
    """Online side of BYOL: encoder + predictor + (detached) linear probe."""

    def __init__(self, arch: str = "resnet18", in_channels: int = 3, low_res: bool = False,
                 hidden_dim: int = 4096, proj_dim: int = 256, num_classes: int = 10):
        super().__init__()
        self.encoder = Encoder(arch, in_channels, low_res, hidden_dim, proj_dim)
        self.predictor = MLP(proj_dim, hidden_dim, proj_dim)
        self.probe = nn.Linear(self.encoder.backbone.feature_dim, num_classes)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.encoder.reset_parameters(generator)
        self.predictor.reset_parameters(generator)
        reset_linear(self.probe, generator)

    def _probe(self, feats: torch.Tensor) -> torch.Tensor:
        # the probe is an f32 layer in the reference; keep it out of autocast
        with torch.autocast(feats.device.type, enabled=False):
            return self.probe(feats.float())

    def forward(self, x: torch.Tensor):
        """Predictions p, projections z, backbone features, probe logits."""
        z, feats = self.encoder(x)
        p = self.predictor(z)
        return p, z, feats, self._probe(feats.detach())

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """Pooled backbone features."""
        return self.encoder(x, return_embedding=True)

    def classify(self, x: torch.Tensor) -> torch.Tensor:
        """Probe logits, for validation top-1/top-5."""
        return self._probe(self.embed(x))
