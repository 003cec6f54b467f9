"""torch checkpoints and the SSL→segmentation encoder handoff.

Port of ``core/checkpoint.py:49-170``. A checkpoint is one
``torch.save`` file ``<dir>/<step>.pt`` (the convention of
``train/train_ssl.py``), written to a temporary name and renamed, so a
run killed mid-save leaves the last complete one. A trainer's checkpoint
holds its task's ``state_dict`` plus what a resume needs beyond it:
``epoch``, the epoch of the loader's data order that the next step reads,
and ``aug_generator``, the state of the augmentation ``torch.Generator``
(the torch stream cannot be re-derived from the step as JAX's
``fold_in(key(seed+1), step)`` is). Files written before these keys
existed still load; the encoder graft reads only ``online``.

``load_checkpoint`` also reads the JAX package's orbax checkpoints (a step
directory ``<root>/<step>/`` or a root of them,
``core/checkpoint.py:49-68`` there): ``load_orbax_checkpoint`` restores the
saved tree as numpy arrays and ``core/convert.py`` turns its weights and
BatchNorm statistics into the state dicts of this package, so a model
trained there is served, probed, validated or grafted here. The optimizer
state does not cross, so ``--resume`` refuses such a directory.

Several processes: ``save_rank0`` writes on rank 0 only and then holds
every rank until the file is there (a broadcast of a flag), so a later
``--resume`` reads the same file on every rank. A tensor-parallel task's
``state_dict`` gathers its heads, so its checkpoint is laid out as a
one-card one and loads at any ``--model_parallel``; loading keeps each
rank's slices, also of a state converted from the JAX package.

``load_byol_encoder_into_unet`` grafts the ONLINE encoder's backbone of a
BYOL checkpoint (weights and BatchNorm running statistics; never the
momentum target) into a U-Net's ``encoder``, adapting the stem to the
U-Net's input channels. Any other shape mismatch raises.
``load_byol3d_encoder_into_unet3d`` does the same for a volumetric BYOL
backbone and a ``UNet3D``, whose encoder blocks carry the same names.
"""

from __future__ import annotations

import os
import re
import sys
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from medical_image_segmentation_tpu_torch.core.convert import (
    flax_to_state_dict, probe_flax_to_state_dict, unet3d_flax_to_state_dict, unet_flax_to_state_dict,
)
from medical_image_segmentation_tpu_torch.parallel.mesh import barrier

_STEP_FILE = re.compile(r"(\d+)\.pt$")
_BACKBONE = "encoder.backbone."


def save_checkpoint(ckpt_dir: str, state: Mapping[str, object], step: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"{step}.pt")
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(dict(state), tmp)
    os.replace(tmp, path)
    return path


def save_rank0(ckpt_dir: str, state: Mapping[str, object], step: int, mesh=None) -> str:
    """Rank 0 writes ``state`` (which every rank computed, since gathering
    tensor-parallel heads is collective); then every rank waits for it.
    Returns the path on rank 0 and "" elsewhere."""
    path = ""
    if mesh is None or mesh.rank == 0:
        path = save_checkpoint(ckpt_dir, state, step)
        print(f"checkpoint → {path}", file=sys.stderr)
    barrier(mesh)
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m[1]) for m in map(_STEP_FILE.fullmatch, os.listdir(ckpt_dir)) if m]
    return max(steps, default=None)


def trainer_state(task, next_epoch: int, generator: torch.Generator) -> Dict[str, object]:
    """What a trainer saves: ``task.state_dict()`` plus the epoch of the
    data order that the next step reads and the generator's state."""
    return {**task.state_dict(), "epoch": next_epoch, "aug_generator": generator.get_state()}


def resume_latest(ckpt_dir: str, task, loader, generator: torch.Generator,
                  steps_per_epoch: int) -> Optional[Tuple[int, int, int]]:
    """Restore the latest checkpoint of ``ckpt_dir`` into ``task``,
    ``loader.epoch`` and ``generator`` (``train/train_ssl.py:240-258``).
    Returns ``(step, epoch, skip)``: the run goes on from ``epoch`` after
    skipping the ``skip`` batches of it that were already trained; None
    when there is nothing to resume from. A checkpoint without the resume
    keys takes its epoch from its step and leaves the generator alone."""
    step = latest_step(ckpt_dir)
    if step is None:
        if latest_orbax_step(ckpt_dir) is not None:
            raise SystemExit(f"--resume: {ckpt_dir} holds orbax checkpoints of the JAX package; their optimizer "
                             "state is not converted, so a run cannot resume from them. Pass the directory as "
                             "--ssl_checkpoint / --checkpoint to start from its weights")
        return None
    ckpt = load_checkpoint(os.path.join(ckpt_dir, f"{step}.pt"))
    task.load_state_dict(ckpt)
    epoch = int(ckpt.get("epoch", task.step // steps_per_epoch))
    skip = task.step - epoch * steps_per_epoch
    if not 0 <= skip < steps_per_epoch:
        raise SystemExit(f"--resume: checkpoint step {task.step} does not fall in its epoch {epoch} at "
                         f"{steps_per_epoch} steps per epoch; resume with the batch size and step cap it was "
                         "trained with")
    if "aug_generator" in ckpt:
        generator.set_state(ckpt["aug_generator"])
    loader.epoch = epoch  # before the first iter(), which takes the counter and advances it
    print(f"resumed from step {task.step} (epoch {epoch}"
          + (f", skipping {skip} trained batches" if skip else "") + ")", file=sys.stderr)
    return task.step, epoch, skip


def latest_orbax_step(ckpt_dir: str) -> Optional[int]:
    """The largest digit-named subdirectory of ``ckpt_dir``: the JAX
    package's latest step."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d) for d in os.listdir(ckpt_dir) if d.isdigit() and os.path.isdir(os.path.join(ckpt_dir, d))]
    return max(steps, default=None)


_ORBAX_SUBTREES = ("params", "batch_stats", "target_params", "target_batch_stats", "step")


def load_orbax_checkpoint(path: str) -> Dict[str, Any]:
    """The weights, BatchNorm statistics and step that the JAX package's
    ``save_checkpoint`` wrote at the step directory ``path``, as nested
    dicts of numpy arrays; the other entries of the saved state (optimizer
    state, random keys) are left out. ``orbax`` is imported here and
    nowhere else in the package."""
    try:
        import orbax.checkpoint as ocp
    except ImportError as e:
        raise SystemExit(f"{path} is an orbax checkpoint of the JAX package; reading it needs the "
                         f"orbax-checkpoint package, which is not installed here ({e}). Read it where orbax "
                         "is installed and save a .pt with core/checkpoint.py::save_checkpoint") from e
    import numpy as np

    tree = ocp.PyTreeCheckpointer().restore(os.path.abspath(path))

    def to_numpy(node):
        if isinstance(node, Mapping):
            return {k: to_numpy(v) for k, v in node.items()}
        return np.asarray(node)

    return {k: to_numpy(tree[k]) for k in _ORBAX_SUBTREES if tree.get(k) is not None}


def orbax_to_state(tree: Mapping[str, Any]) -> Dict[str, object]:
    """A restored JAX state as this package's checkpoint dict, weights and
    BatchNorm statistics only: a ``BYOLState`` gives ``online`` and
    ``target``, a segmentation ``TrainState`` (2D or 3D) gives ``model``, a
    ``ProbeState`` gives ``head``; ``step`` where the state has one. No
    ``optimizer`` entry: the tasks then keep their fresh optimizer."""
    params = tree["params"]
    stats = tree.get("batch_stats") or {}
    out: Dict[str, object] = {}
    if "step" in tree:
        out["step"] = int(tree["step"])
    if "target_params" in tree:
        out["online"] = flax_to_state_dict(params, stats)
        out["target"] = flax_to_state_dict(tree["target_params"], tree.get("target_batch_stats") or {})
    elif "enc0" in params:
        out["model"] = unet3d_flax_to_state_dict(params, stats)
    elif "encoder" in params:
        out["model"] = unet_flax_to_state_dict(params, stats)
    elif "Dense_0" in params:
        out["head"] = probe_flax_to_state_dict(params)
    else:
        raise ValueError(f"unknown JAX state: params hold {sorted(params)[:5]}")
    return out


def load_checkpoint(path: str, map_location="cpu") -> Dict[str, object]:
    """The checkpoint at ``path``: a ``.pt`` file, an orbax step directory
    of the JAX package, or a directory whose latest step of either kind is
    read."""
    path = resolve_checkpoint_path(path)
    if os.path.isdir(path):
        return orbax_to_state(load_orbax_checkpoint(path))
    return torch.load(path, map_location=map_location, weights_only=True)


def restore_model(task, path: str) -> int:
    """Load the ``model`` weights of the checkpoint at ``path`` (any form
    ``load_checkpoint`` takes) into ``task.model``, as the predict and
    export entry points do; returns the checkpoint's step."""
    ckpt = resolve_checkpoint_path(path)
    state = load_checkpoint(ckpt, map_location=task.device)
    task.model.load_state_dict(state["model"])
    print(f"restored {ckpt} (step {state['step']})", file=sys.stderr)
    return int(state["step"])


def resolve_checkpoint_path(path: str) -> str:
    """``path`` is a checkpoint file (``…/ckpt/5.pt``) or a directory. Of a
    directory its latest ``<step>.pt`` is picked; where it holds none, its
    latest orbax step (a digit-named subdirectory); where it holds neither
    and its own name is a number (``…/ckpt/5``), it is an orbax step
    directory itself. Raises SystemExit for any other directory."""
    path = os.path.normpath(path)
    if not os.path.isdir(path):
        return path
    step = latest_step(path)
    if step is not None:
        return os.path.join(path, f"{step}.pt")
    step = latest_orbax_step(path)
    if step is not None:
        return os.path.join(path, str(step))
    if os.path.basename(path).isdigit():
        return path  # an orbax step directory itself
    raise SystemExit(f"no checkpoint steps under {path}")


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


def load_byol3d_encoder_into_unet3d(unet_state: Mapping[str, torch.Tensor],
                                    online: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A copy of ``unet_state`` (a ``UNet3D`` state dict) whose ``enc{i}``
    and ``down{i}`` entries are the ``UNet3DEncoder`` backbone of ``online``
    (the ``"online"`` entry of a volumetric BYOL checkpoint); the decoder
    and the head stay. Raises on a checkpoint without such a backbone, on a
    block the U-Net lacks (a deeper encoder) and, listing them, on entries
    whose shapes differ or that the U-Net's block does not hold (another
    width or norm)."""
    backbone = extract_byol_backbone(online)
    if not any(k.startswith("enc0.") for k in backbone):
        raise ValueError("the checkpoint's online network holds no volumetric (UNet3DEncoder) backbone")
    missing = sorted({k.split(".")[0] for k in backbone} - {k.split(".")[0] for k in unet_state})
    if missing:
        raise ValueError(f"UNet3D has no blocks {missing} to graft into")
    mismatches = []
    for k, v in backbone.items():
        target = unet_state.get(k)
        if target is None or target.shape != v.shape:
            mismatches.append((k, tuple(v.shape), None if target is None else tuple(target.shape)))
    if mismatches:
        raise ValueError(f"3D encoder shape mismatches: {mismatches}")
    new_state = dict(unet_state)
    for k, v in backbone.items():
        new_state[k] = v.detach().clone()
    return new_state
