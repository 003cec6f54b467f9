"""torch checkpoints and the SSL→segmentation encoder handoff.

Port of ``core/checkpoint.py:49-98, 139-170``. A checkpoint is one
``torch.save`` file ``<dir>/<step>.pt`` (the convention of
``train/train_ssl.py``), written to a temporary name and renamed, so a
run killed mid-save leaves the last complete one.

``load_byol_encoder_into_unet`` grafts the ONLINE encoder's backbone of a
BYOL checkpoint (weights and BatchNorm running statistics; never the
momentum target) into a U-Net's ``encoder``, adapting the stem to the
U-Net's input channels. Any other shape mismatch raises.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Mapping, Optional

import torch

_STEP_FILE = re.compile(r"(\d+)\.pt$")
_BACKBONE = "encoder.backbone."


def save_checkpoint(ckpt_dir: str, state: Mapping[str, object], step: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"{step}.pt")
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(dict(state), tmp)
    os.replace(tmp, path)
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m[1]) for m in map(_STEP_FILE.fullmatch, os.listdir(ckpt_dir)) if m]
    return max(steps, default=None)


def resolve_checkpoint_path(path: str) -> str:
    """``path`` is a checkpoint file (``…/ckpt/5.pt``) or a checkpoint
    directory, in which case its latest step is picked. Raises SystemExit
    when the directory holds no steps."""
    path = os.path.normpath(path)
    if os.path.isdir(path):
        step = latest_step(path)
        if step is None:
            raise SystemExit(f"no checkpoint steps under {path}")
        return os.path.join(path, f"{step}.pt")
    return path


def _adapt_conv1(weight: torch.Tensor, target_in: int, how: str = "sum") -> torch.Tensor:
    """Adapt an OIHW stem kernel to ``target_in`` input channels (dim 1 is
    flax's HWIO axis 2): ``sum`` collapses RGB→1, which keeps the response
    to a gray image replicated over RGB; 1→N tiles and divides by N."""
    cin = weight.shape[1]
    if cin == target_in:
        return weight
    if target_in == 1:
        if how != "sum":
            raise ValueError(f"unsupported conv1 adaptation {how!r} for {cin}->1")
        return weight.sum(dim=1, keepdim=True)
    if cin == 1:
        return weight.repeat(1, target_in, 1, 1) / target_in
    raise ValueError(f"cannot adapt conv1 from {cin} to {target_in} channels")


def extract_byol_backbone(online: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The backbone entries of a ``BYOLNet`` state dict, keys relative to
    the ResNet (``encoder.backbone.conv1.weight`` → ``conv1.weight``)."""
    return {k[len(_BACKBONE):]: v for k, v in online.items() if k.startswith(_BACKBONE)}


def load_byol_encoder_into_unet(unet_state: Mapping[str, torch.Tensor], online: Mapping[str, torch.Tensor],
                                adapt_channels: bool = True) -> Dict[str, torch.Tensor]:
    """A copy of ``unet_state`` (a ``UNet`` state dict) whose ``encoder.*``
    entries are the backbone of ``online`` (the ``"online"`` entry of a BYOL
    checkpoint). Every encoder entry must be covered, and shapes must match
    but for the stem's input channels when ``adapt_channels``."""
    backbone = extract_byol_backbone(online)
    if adapt_channels and "conv1.weight" in backbone:
        backbone["conv1.weight"] = _adapt_conv1(backbone["conv1.weight"],
                                                unet_state["encoder.conv1.weight"].shape[1])
    encoder_keys = {k[len("encoder."):] for k in unet_state if k.startswith("encoder.")}
    if set(backbone) != encoder_keys:
        raise ValueError(f"encoder structure mismatch: only in BYOL {sorted(set(backbone) - encoder_keys)[:5]}, "
                         f"only in U-Net {sorted(encoder_keys - set(backbone))[:5]}")
    mismatches = [(k, tuple(v.shape), tuple(unet_state["encoder." + k].shape)) for k, v in backbone.items()
                  if v.shape != unet_state["encoder." + k].shape]
    if mismatches:
        raise ValueError(f"encoder shape mismatches: {mismatches}")
    new_state = dict(unet_state)
    for k, v in backbone.items():
        new_state["encoder." + k] = v.detach().clone()
    return new_state
