"""flax → torch weights for the BYOL network and the 2D and 3D U-Nets.

Turns the JAX package's ``params`` / ``batch_stats`` trees (nested dicts of
arrays, e.g. ``BYOLState.params`` after ``jax.device_get``) into a state
dict for this package's ``BYOLNet`` (paths under ``encoder/``,
``predictor/``, ``probe/``) or its target ``Encoder`` (paths under
``ResNet_0/``, ``projector/``), or, through the ``unet_*`` entry points,
for its ``UNet`` and ``UNet3D``:

- Conv kernel HWIO → OIHW, or DHWIO → OIDHW; Dense kernel (in, out) → Linear weight (out, in);
- BatchNorm ``scale/bias`` (params) and ``mean/var`` (batch_stats) →
  ``weight/bias/running_mean/running_var``;
- flax's auto-names map to ours: ``ResNet_0`` → ``backbone``,
  ``layer{i}_{j}`` → ``layer{i}.{j}``, ``Conv_k``/``BatchNorm_k`` →
  ``conv{k+1}``/``bn{k+1}`` in a block, ``Dense_0/1`` and ``BatchNorm_0``
  → ``fc1/fc2`` and ``bn`` in an MLP;
- in the U-Net the ResNet sits directly under ``encoder/`` (no
  ``ResNet_0/``), ``DecoderBlock_{k}`` → ``decoder.{k}``, and ``head``
  keeps its kernel and bias;
- in the 3D U-Net ``enc{i}`` / ``dec{i}`` hold ``Conv_k`` → ``conv{k+1}`` and
  ``GroupNorm_k`` or ``BatchNorm_k`` → ``norm{k+1}``; ``down{i}`` and
  ``head`` are single convs; under a volumetric BYOL tree the encoder half
  sits at ``encoder/UNet3DEncoder_0/`` → ``encoder.backbone.``;
- the linear probe's head (``eval/linear_probe.py``): ``Dense_0`` →
  ``linear``.

A leaf no rule maps raises, so a model change on either side cannot be
half-converted in silence.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _conv(a: np.ndarray) -> np.ndarray:
    """(*spatial, in, out) → (out, in, *spatial), for 2D and 3D kernels."""
    return a.transpose(a.ndim - 1, a.ndim - 2, *range(a.ndim - 2))


def _dense(a: np.ndarray) -> np.ndarray:
    return a.T


def _same(a: np.ndarray) -> np.ndarray:
    return a


def _resnet_rules(flax_prefix: str, torch_prefix: str):
    """(pattern, torch name, transform) for a ResNet whose leaves sit under
    ``flax_prefix`` in flax and ``torch_prefix`` in torch."""
    p, t = flax_prefix, torch_prefix
    return (
        (p + r"conv1/kernel", lambda m: f"{t}conv1.weight", _conv),
        (p + r"bn1/(scale|bias|mean|var)", lambda m: f"{t}bn1.{_BN[m[1]]}", _same),
        (p + r"layer(\d)_(\d+)/Conv_(\d)/kernel",
         lambda m: f"{t}layer{m[1]}.{m[2]}.conv{int(m[3]) + 1}.weight", _conv),
        (p + r"layer(\d)_(\d+)/BatchNorm_(\d)/(scale|bias|mean|var)",
         lambda m: f"{t}layer{m[1]}.{m[2]}.bn{int(m[3]) + 1}.{_BN[m[4]]}", _same),
        (p + r"layer(\d)_(\d+)/downsample_conv/kernel",
         lambda m: f"{t}layer{m[1]}.{m[2]}.downsample_conv.weight", _conv),
        (p + r"layer(\d)_(\d+)/downsample_bn/(scale|bias|mean|var)",
         lambda m: f"{t}layer{m[1]}.{m[2]}.downsample_bn.{_BN[m[3]]}", _same),
    )


def _unet3d_rules(flax_prefix: str, torch_prefix: str, stages: str):
    """(pattern, torch name, transform) for the double-conv blocks named by
    the ``stages`` alternation (``enc`` or ``enc|dec``) and the ``down``
    convs of a 3D U-Net or its encoder half."""
    p, t = flax_prefix, torch_prefix
    return (
        (p + rf"({stages})(\d+)/Conv_([01])/kernel", lambda m: f"{t}{m[1]}{m[2]}.conv{int(m[3]) + 1}.weight", _conv),
        (p + rf"({stages})(\d+)/(?:GroupNorm|BatchNorm)_([01])/(scale|bias|mean|var)",
         lambda m: f"{t}{m[1]}{m[2]}.norm{int(m[3]) + 1}.{_BN[m[4]]}", _same),
        (p + r"down(\d+)/kernel", lambda m: f"{t}down{m[1]}.weight", _conv),
    )


def _compile(rules) -> Tuple[Tuple[re.Pattern, Callable[[re.Match], str], Callable], ...]:
    return tuple((re.compile(p + "$"), name, fn) for p, name, fn in rules)


# BYOL: patterns on the flax path below encoder/ (BYOLNet) or at the top
# (the target Encoder)
_BACKBONE_RULES = _resnet_rules("ResNet_0/", "backbone.") + _unet3d_rules("UNet3DEncoder_0/", "backbone.", "enc")
_RULES = _compile(_BACKBONE_RULES + (
    (r"(projector|predictor)/Dense_([01])/kernel", lambda m: f"{m[1]}.fc{int(m[2]) + 1}.weight", _dense),
    (r"(projector|predictor)/Dense_([01])/bias", lambda m: f"{m[1]}.fc{int(m[2]) + 1}.bias", _same),
    (r"(projector|predictor)/BatchNorm_0/(scale|bias|mean|var)", lambda m: f"{m[1]}.bn.{_BN[m[2]]}", _same),
    (r"probe/kernel", lambda m: "probe.weight", _dense),
    (r"probe/bias", lambda m: "probe.bias", _same),
))

_UNET_RULES = _compile(_resnet_rules("encoder/", "encoder.") + (
    (r"DecoderBlock_(\d)/Conv_([01])/kernel", lambda m: f"decoder.{m[1]}.conv{int(m[2]) + 1}.weight", _conv),
    (r"DecoderBlock_(\d)/BatchNorm_([01])/(scale|bias|mean|var)",
     lambda m: f"decoder.{m[1]}.bn{int(m[2]) + 1}.{_BN[m[3]]}", _same),
    (r"head/kernel", lambda m: "head.weight", _conv),
    (r"head/bias", lambda m: "head.bias", _same),
))

_UNET3D_RULES = _compile(_unet3d_rules("", "", "enc|dec") + (
    (r"head/kernel", lambda m: "head.weight", _conv),
    (r"head/bias", lambda m: "head.bias", _same),
))

_PROBE_RULES = _compile((
    (r"Dense_0/kernel", lambda m: "linear.weight", _dense),
    (r"Dense_0/bias", lambda m: "linear.bias", _same),
))


def _leaves(tree: Mapping[str, Any], prefix: str = "") -> Iterator[Tuple[str, Any]]:
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            yield from _leaves(v, path + "/")
        else:
            yield path, v


def _match(rules, flax_path: str, shown: str) -> Tuple[str, Callable]:
    for pattern, name, fn in rules:
        m = pattern.match(flax_path)
        if m:
            return name(m), fn
    raise KeyError(f"no torch counterpart for flax leaf {shown!r}")


def torch_name(flax_path: str) -> Tuple[str, Callable]:
    """The torch state-dict key and array transform for one flax leaf of
    ``BYOLNet`` or ``Encoder``."""
    if flax_path.startswith("encoder/"):
        name, fn = _match(_RULES, flax_path[len("encoder/"):], flax_path)
        return "encoder." + name, fn
    return _match(_RULES, flax_path, flax_path)


def unet_torch_name(flax_path: str) -> Tuple[str, Callable]:
    """The torch state-dict key and array transform for one flax leaf of
    ``UNet``."""
    return _match(_UNET_RULES, flax_path, flax_path)


def unet3d_torch_name(flax_path: str) -> Tuple[str, Callable]:
    """The torch state-dict key and array transform for one flax leaf of
    ``UNet3D``."""
    return _match(_UNET3D_RULES, flax_path, flax_path)


def _convert(params, batch_stats, name_of) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for tree in (params, batch_stats):
        for path, leaf in _leaves(tree):
            name, fn = name_of(path)
            out[name] = torch.from_numpy(np.array(fn(np.asarray(leaf, np.float32)), order="C"))
    return out


def flax_to_state_dict(params: Mapping[str, Any], batch_stats: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict (f32 CPU tensors) for ``BYOLNet`` or ``Encoder``."""
    return _convert(params, batch_stats, torch_name)


def unet_flax_to_state_dict(params: Mapping[str, Any], batch_stats: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict (f32 CPU tensors) for ``UNet``."""
    return _convert(params, batch_stats, unet_torch_name)


def unet3d_flax_to_state_dict(params: Mapping[str, Any], batch_stats: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict (f32 CPU tensors) for ``UNet3D``; ``batch_stats`` is empty
    under GroupNorm."""
    return _convert(params, batch_stats, unet3d_torch_name)


def probe_flax_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """State dict (f32 CPU tensors) for the head of ``LinearProbe`` from
    the JAX ``ProbeState.params``."""
    return _convert(params, {}, lambda path: _match(_PROBE_RULES, path, path))
