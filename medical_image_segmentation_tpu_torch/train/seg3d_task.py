"""Volumetric segmentation task (3D U-Net + Dice). Port of
``train/seg3d_task.py:43-135``.

The 2D task with another network: ``UNet3D`` of ``features`` and ``norm``
on NDHWC crops, in ``channels_last_3d``. Loss, metrics, LARS, the
warmup-cosine LR held for a whole epoch and ending at ``min_lr``, bf16
through autocast, ``remat`` per double-conv block and the state dict are
``train/segmentation_task.py``'s, which are shape-agnostic. With the
default GroupNorm the state dict holds no running statistics.

Under a ``("data", "space")`` mesh (``--space_shards``, the JAX
``spatial_sharding(mesh, ndim=5)``, ``train/seg3d_task.py:11-17`` there)
``train_step`` takes this rank's rows and depth slab
(``parallel/mesh.py::depth_slab``): the network halo-exchanges and sums its
GroupNorm statistics over the ``space`` group
(``models/unet3d.py::set_space_group``), the Dice sums, BatchNorm
statistics and the gradient mean run over every rank. ``logits`` and
``eval_step`` take whole crops of the rank's rows, replicated over
``space``, as the JAX eval shards on ``data`` only
(``train/train_segmentation3d.py:300-330`` there); so does a rank that
predicts alone.

``arch="nnunet3d"`` builds nnU-Net's ``PlainConvUNet3D``
(``models/plain_unet3d.py``) of ``features`` in place of ``UNet3D`` (``norm``
does not apply: its norm is InstanceNorm), trained on integer label maps
with nnU-Net's optimizer and schedule (SGD-Nesterov with clipping, poly)
and its loss, ``loss="dice_ce_ds"``; it refuses a mesh with more than one
``space`` rank.

``arch="swin_unetr"`` builds Swin UNETR (``models/swin_unetr.py``) at
``feature_size`` with the published depths (2, 2, 2, 2), heads (3, 6, 12,
24) and window 7, trained on integer label maps with its recipe: MONAI's
squared softmax Dice + CE (``ops/dice.py::dice_ce_softmax``), AdamW and
the warmup-cosine schedule ending at 0 (``features``, ``norm``, ``loss``
and ``min_lr`` do not apply); it too refuses a mesh with more than one
``space`` rank.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Sequence

import torch

from medical_image_segmentation_tpu_torch.models.plain_unet3d import PlainConvUNet3D
from medical_image_segmentation_tpu_torch.models.swin_unetr import SwinUNETR3D
from medical_image_segmentation_tpu_torch.models.unet3d import UNet3D, set_space_group
from medical_image_segmentation_tpu_torch.train.segmentation_task import SegmentationTask


class Segmentation3DTask(SegmentationTask):
    def __init__(
        self,
        n_classes: int = 1,
        in_channels: int = 1,
        features: Sequence[int] = (32, 64, 128, 256),
        norm: str = "group",
        learning_rate: float = 1.0,
        weight_decay: float = 1e-6,
        momentum: float = 0.9,
        warmup_epochs: int = 10,
        max_epochs: int = 50,
        min_lr: float = 1e-2,
        steps_per_epoch: int = 1,
        loss: str = "dice",
        dtype: torch.dtype = torch.bfloat16,
        device="cuda",
        remat: bool = False,
        mesh=None,
        arch: str = "unet3d",
        feature_size: int = 48,
    ):
        if arch in ("nnunet3d", "swin_unetr") and mesh is not None and mesh.size("space") > 1:
            raise ValueError(f"arch {arch!r} does not support depth sharding (a space group of "
                             f"{mesh.size('space')} ranks)")
        if arch == "swin_unetr":
            net_cls, net_kw = SwinUNETR3D, dict(in_channels=in_channels, n_classes=n_classes,
                                                feature_size=feature_size, remat=remat)
            loss, optimizer, schedule, min_lr = "dice_ce_softmax", "adamw", "warmup_cosine", 0.0
        elif arch == "nnunet3d":
            if loss != "dice_ce_ds":
                raise ValueError(f"arch 'nnunet3d' trains with loss 'dice_ce_ds', not {loss!r}")
            net_cls, net_kw = PlainConvUNet3D, dict(in_channels=in_channels, n_classes=n_classes,
                                                    features=tuple(features), deep_supervision=True, remat=remat)
            optimizer, schedule = "sgd_nesterov", "poly"
        elif arch == "unet3d":
            net_cls, net_kw = UNet3D, dict(n_classes=n_classes, in_channels=in_channels, features=tuple(features),
                                           norm=norm, remat=remat)
            optimizer, schedule = "lars", "warmup_cosine"
        else:
            raise ValueError(f"arch must be 'unet3d', 'nnunet3d' or 'swin_unetr', got {arch!r}")
        self._build(net_cls, net_kw, torch.channels_last_3d, learning_rate, weight_decay, momentum, warmup_epochs,
                    max_epochs, min_lr, steps_per_epoch, loss, dtype, device, mesh, optimizer, schedule)
        self._space_group = mesh.group("space") if mesh is not None else None
        set_space_group(self.model, self._space_group)

    @contextlib.contextmanager
    def _whole_crops(self) -> Iterator[None]:
        """The network runs unsharded for the duration."""
        set_space_group(self.model, None)
        try:
            yield
        finally:
            set_space_group(self.model, self._space_group)

    def logits(self, images: torch.Tensor) -> torch.Tensor:
        """Eval-mode f32 logits of whole crops: the space group is put
        aside for the call."""
        with self._whole_crops():
            return super().logits(images)

    def replicas(self, devices):
        """The copies run whole crops too."""
        with self._whole_crops():
            return super().replicas(devices)
