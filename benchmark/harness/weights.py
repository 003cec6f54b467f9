"""Weights from the seed, made on the device in one draw.

``make_weights`` fills a state dict whose names and shapes are given (the
program's own ``state_dict()`` read for its layout only): convolutions
Kaiming normal over fan-out (ReLU gain), matrices LeCun normal over
fan-in, biases 0, BatchNorm scale 1, shift 0, running mean 0 and running
variance 1. One ``torch.randn`` over every weight element on a generator
of the device, then one multiplication by a per-element standard
deviation, so the same seed gives the same weights on any card.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def _std(shape) -> float:
    if len(shape) == 4:  # (out, in, kh, kw): Kaiming normal, fan_out
        return math.sqrt(2.0 / (shape[0] * shape[2] * shape[3]))
    return 1.0 / math.sqrt(shape[1])  # (out, in): LeCun normal, fan_in


def make_weights(layout: Dict[str, torch.Size], seed: int, device) -> Dict[str, torch.Tensor]:
    """Float32 tensors on ``device`` for every name of ``layout``."""
    drawn = [(k, tuple(s)) for k, s in layout.items() if len(s) >= 2]
    numels = [math.prod(s) for _, s in drawn]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(numels), generator=gen, device=device)
    stds = torch.tensor([_std(s) for _, s in drawn], device=device)
    flat.mul_(torch.repeat_interleave(stds, torch.tensor(numels, device=device)))
    out = {k: t.view(s) for (k, s), t in zip(drawn, flat.split(numels))}
    for k, s in layout.items():
        if k in out:
            continue
        ones = k.endswith(("running_var",)) or (k.endswith(".weight") and len(s) == 1)
        out[k] = (torch.ones if ones else torch.zeros)(tuple(s), device=device)
    return out
