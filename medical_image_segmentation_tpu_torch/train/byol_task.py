"""BYOL self-supervised pretraining task. Port of ``train/byol_task.py:57-205``.

- Online ``BYOLNet`` (encoder + predictor + detached probe) and a momentum
  ``Encoder`` that starts as an exact copy of the online encoder.
- Symmetric loss by the concat trick: the online branch sees ``[v1; v2]``,
  the target branch ``[v2; v1]``, and one ``2 - 2·cos`` covers both pairings.
- The target forward runs in train mode under ``no_grad``: it updates its
  own BatchNorm running stats and nothing else.
- LARS with the linear-warmup cosine LR per step; then the EMA
  ``target ← τ·target + (1-τ)·online`` over PARAMETERS only (BN buffers of
  the target evolve from its own forwards), τ from the step count before
  the increment.
- bf16 compute through ``torch.autocast`` when ``dtype`` is bf16; f32
  parameters, loss and norms.

``embed_step`` gives the eval-mode backbone features of the KNN probe and
the linear probe. ``state_dict``/``load_state_dict`` carry the online and
target networks, the optimizer and the step, which is what a resume
restores (the trainer adds the data order and the augmentation stream).
``remat`` checkpoints each residual block of both towers. ``volumetric``
trains a ``UNet3DEncoder`` of ``features3d`` on NDHWC views
(``train/byol_task.py:78-89``); nothing else of the task changes.

``mesh`` (``parallel/mesh.py``) trains one model over several processes,
as the JAX task does over a sharded batch: each rank passes its rows of
the global batch; BatchNorm statistics are the global batch's; after the
backward one bucketed all-reduce averages the online gradients over the
``data`` group; the returned loss and probe metrics are global means. A
``model`` axis of M ranks makes the projector and predictor heads
tensor-parallel (``parallel/tp.py``): the heads' slices average their
gradients over the data group, the replicated parameters over every rank
(equal on model peers in exact arithmetic, but cuDNN's backward may sum in
another order in each process, and the copies must stay equal to the
bit). ``state_dict`` then gathers the heads' slices, so a checkpoint is
laid out as a one-card one, and ``load_state_dict`` keeps the rank's
slices of a whole one. The weights start as the first data rank's
(``replicate``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from medical_image_segmentation_tpu_torch.models.batchnorm import set_group
from medical_image_segmentation_tpu_torch.models.byol import BYOLNet, Encoder
from medical_image_segmentation_tpu_torch.ops.byol_loss import cosine_similarity_loss
from medical_image_segmentation_tpu_torch.ops.lars import LARS
from medical_image_segmentation_tpu_torch.ops.schedules import cosine_ema_momentum, linear_warmup_cosine_annealing
from medical_image_segmentation_tpu_torch.parallel.mesh import all_reduce_mean_grads, global_mean, replicate
from medical_image_segmentation_tpu_torch.parallel.tp import gather_state_dict, shard_dim, shard_state_dict


class BYOLTask:
    def __init__(
        self,
        arch: str = "resnet18",
        in_channels: int = 3,
        low_res: bool = False,
        hidden_dim: int = 4096,
        proj_dim: int = 256,
        num_classes: int = 10,
        learning_rate: float = 1.0,
        weight_decay: float = 1e-6,
        momentum: float = 0.9,
        warmup_epochs: int = 10,
        max_epochs: int = 100,
        base_ema_momentum: float = 0.99,
        final_ema_momentum: float = 1.0,
        total_steps: int = 10000,
        steps_per_epoch: int = 1,
        probe_loss_weight: float = 1.0,
        dtype: torch.dtype = torch.bfloat16,
        device="cuda",
        remat: bool = False,
        volumetric: bool = False,
        features3d: Sequence[int] = (32, 64, 128, 256),
        mesh=None,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{type(self).__name__}: device {device!r} asked for, but CUDA is not "
                               "available (pass device='cpu' explicitly)")
        self.dtype = dtype
        self._net_kw = dict(arch=arch, in_channels=in_channels, low_res=low_res,
                            hidden_dim=hidden_dim, proj_dim=proj_dim, remat=remat, volumetric=volumetric,
                            features3d=tuple(features3d))
        self.mesh = mesh
        self._data_group = mesh.group("data") if mesh is not None else None
        self._model_group = mesh.group("model") if mesh is not None else None
        self.online = BYOLNet(num_classes=num_classes, model_group=self._model_group, **self._net_kw)
        self.target = Encoder(model_group=self._model_group, **self._net_kw)
        for m in (self.online, self.target):
            m.to(self.device, memory_format=torch.channels_last_3d if volumetric else torch.channels_last)
        self.target.requires_grad_(False)
        set_group((self.online, self.target), self._data_group)
        self.total_steps = total_steps
        self.probe_loss_weight = probe_loss_weight
        self.schedule = linear_warmup_cosine_annealing(
            learning_rate, warmup_epochs, max_epochs, steps_per_epoch=steps_per_epoch, interval="step")
        self.ema_schedule = cosine_ema_momentum(base_ema_momentum, final_ema_momentum)
        self._sharded = [p for name, p in self.online.named_parameters() if shard_dim(name) is not None]
        self._replicated = [p for name, p in self.online.named_parameters() if shard_dim(name) is None]
        # every rank holds the replicated parameters: under a model axis their
        # gradients are averaged over all ranks, not only the data group
        self._replica_group = mesh.group("all") if self._model_group is not None else self._data_group
        self.optimizer = LARS(self.online.parameters(), lr=0.0, weight_decay=weight_decay, momentum=momentum,
                              sharded=self._sharded, norm_group=self._model_group)
        self._online_enc = list(self.online.encoder.parameters())
        self._target_enc = list(self.target.parameters())
        self.step = 0

    def init(self, seed: int) -> None:
        """Fresh weights from ``seed``; the target becomes an exact copy of
        the online encoder; optimizer state and step count reset."""
        fresh = BYOLNet(num_classes=self.online.probe.out_features, **self._net_kw)
        fresh.reset_parameters(torch.Generator().manual_seed(seed))
        self.online.load_state_dict(self._local(fresh.state_dict()))
        self.target.load_state_dict(self.online.encoder.state_dict())
        replicate([*self.online.state_dict().values(), *self.target.state_dict().values()], self.mesh)
        self.optimizer.state.clear()
        self.step = 0

    def _local(self, state):
        """This rank's slices of a whole state dict (itself without a
        model axis)."""
        if self._model_group is None:
            return state
        return shard_state_dict(state, self.mesh.index("model"), self.mesh.size("model"))

    def _whole(self, state):
        """The whole state dict of this rank's slices."""
        return state if self._model_group is None else gather_state_dict(state, self._model_group)

    def _autocast(self):
        return torch.autocast(self.device.type, dtype=torch.bfloat16, enabled=self.dtype == torch.bfloat16)

    def train_step(self, view1: torch.Tensor, view2: torch.Tensor,
                   labels: Optional[torch.Tensor] = None) -> Dict[str, object]:
        """One BYOL step on a two-view NHWC batch (labels optional, for the
        probe). Returns ``loss``/``probe_loss``/``probe_acc`` as 0-d device
        tensors (no sync) and ``lr``/``momentum`` as floats."""
        self.online.train()
        self.target.train()
        x_online = torch.cat([view1, view2], dim=0)
        x_target = torch.cat([view2, view1], dim=0)
        with self._autocast():
            with torch.no_grad():
                z_tgt, _ = self.target(x_target)
            p, _, _, probe_logits = self.online(x_online)
            contrastive = cosine_similarity_loss(p, z_tgt)
        zero = torch.zeros((), device=self.device)
        probe_loss, probe_acc = zero, zero
        if labels is not None:
            y = torch.cat([labels, labels], dim=0).long()
            probe_loss = F.cross_entropy(probe_logits.float(), y)
            probe_acc = (probe_logits.argmax(dim=-1) == y).float().mean()
        total = contrastive + self.probe_loss_weight * probe_loss

        self.optimizer.zero_grad(set_to_none=True)
        total.backward()
        all_reduce_mean_grads(self._replicated, self._replica_group)
        all_reduce_mean_grads(self._sharded, self._data_group)
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        tau = self.ema_schedule(self.step, self.total_steps)
        with torch.no_grad():
            torch._foreach_lerp_(self._target_enc, self._online_enc, 1.0 - tau)
        self.step += 1
        if self._data_group is not None:
            contrastive, probe_loss, probe_acc = global_mean(
                torch.stack([contrastive.detach(), probe_loss.detach(), probe_acc.float()]), self._data_group)
        return {"loss": contrastive.detach(), "probe_loss": probe_loss.detach(),
                "probe_acc": probe_acc, "lr": lr, "momentum": tau}

    @torch.no_grad()
    def val_step(self, images: torch.Tensor, labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Probe top-1/top-5 and CE on eval-mode (running-stat) features."""
        self.online.eval()
        try:
            with self._autocast():
                logits = self.online.classify(images).float()
        finally:
            self.online.train()
        labels = labels.long()
        top1 = (logits.argmax(-1) == labels).float().mean()
        k = min(5, logits.shape[-1])
        top5 = (logits.topk(k, dim=-1).indices == labels[:, None]).any(dim=-1).float().mean()
        loss = F.cross_entropy(logits, labels)
        if self._data_group is not None:
            loss, top1, top5 = global_mean(torch.stack([loss, top1, top5]), self._data_group)
        return {"val/loss": loss, "val/acc@1": top1, "val/acc@5": top5}

    @torch.no_grad()
    def embed_step(self, images: torch.Tensor) -> torch.Tensor:
        """Eval-mode (running-statistic) pooled backbone features, f32, for
        the KNN feature bank (``train/byol_task.py:207-215``)."""
        self.online.eval()
        try:
            with self._autocast():
                return self.online.embed(images).float()
        finally:
            self.online.train()

    def state_dict(self) -> Dict[str, object]:
        """Online, target, optimizer and step; under a model axis the heads'
        slices (and their momentum buffers) gathered whole, so every rank
        of a model group must call it."""
        return {"step": self.step, "online": self._whole(self.online.state_dict()),
                "target": self._whole(self.target.state_dict()),
                "optimizer": self._map_momentum(self.optimizer.state_dict(), self._whole)}

    def load_state_dict(self, state: Dict[str, object]) -> None:
        """The inverse of ``state_dict``: online, target, optimizer and step.
        Other keys of a checkpoint (the trainer's) are ignored. A
        checkpoint converted from the JAX package holds no ``optimizer``:
        the optimizer then starts fresh."""
        self.online.load_state_dict(self._local(state["online"]))
        self.target.load_state_dict(self._local(state["target"]))
        self.optimizer.state.clear()
        if "optimizer" in state:
            self.optimizer.load_state_dict(self._map_momentum(state["optimizer"], self._local))
        self.step = int(state["step"])

    def _map_momentum(self, optimizer: Dict[str, object], fn) -> Dict[str, object]:
        """An optimizer state dict whose momentum buffers went through
        ``fn`` (``_whole`` or ``_local``), each under its parameter's name."""
        names = [name for name, _ in self.online.named_parameters()]
        return {**optimizer, "state": {i: {**st, "momentum_buffer": fn({names[i]: st["momentum_buffer"]})[names[i]]}
                                       for i, st in optimizer["state"].items()}}
