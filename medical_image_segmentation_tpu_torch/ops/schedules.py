"""Learning-rate and EMA-momentum schedules, as host-side closed forms.

Port of ``ops/schedules.py:31-70``. The step count is known on the host, so
each schedule returns a Python float: no device tensor, no sync.
"""

from __future__ import annotations

import math
from typing import Callable


def linear_warmup_cosine_annealing(
    base_lr: float,
    warmup_epochs: int,
    max_epochs: int,
    warmup_start_lr: float = 0.0,
    eta_min: float = 0.0,
    steps_per_epoch: int = 1,
    interval: str = "epoch",
) -> Callable[[int], float]:
    """Linear warmup then cosine annealing, over a fractional epoch
    (``interval="step"``) or a whole one (``interval="epoch"``). Note the
    warmup starts at ``warmup_start_lr``: with the default 0, step 0 has
    lr = 0 and moves no parameter."""
    if interval not in ("epoch", "step"):
        raise ValueError(f"interval must be 'epoch' or 'step', got {interval!r}")
    warm_denom = max(warmup_epochs - 1, 1)
    denom = max(max_epochs - warmup_epochs, 1)

    def schedule(count: int) -> float:
        epoch = count / steps_per_epoch
        if interval == "epoch":
            epoch = math.floor(epoch)
        if epoch < warmup_epochs:
            return warmup_start_lr + epoch * (base_lr - warmup_start_lr) / warm_denom
        cos = math.cos(math.pi * (epoch - warmup_epochs) / denom)
        return eta_min + 0.5 * (base_lr - eta_min) * (1.0 + cos)

    return schedule


def cosine_ema_momentum(base_momentum: float, final_momentum: float = 1.0) -> Callable[[int, int], float]:
    """BYOL EMA momentum: tau anneals from ``base_momentum`` to
    ``final_momentum`` by cosine over ``total_steps``."""

    def schedule(step: int, total_steps: int) -> float:
        frac = math.cos(math.pi * step / max(total_steps, 1))
        return final_momentum - (final_momentum - base_momentum) * (frac + 1.0) / 2.0

    return schedule
