"""The numbers that decide ``correct``, each beside its limit.

Training (per cell, of the set-up's first three steps):

- ``views_mismatch``: view elements of the first step where the kernel's
  output differs from the reference's views rounded to the served dtype;
- ``loss_gap``: the largest ``|loss − loss_ref| / |loss_ref|`` of the steps;
- ``grad_gap_median``: a leaf's gap is the gap between the norm of the
  first step's gradient as the optimizer got it and the reference's, over
  the larger of the reference's norm of that leaf and of the median leaf;
  this is the median leaf's. The worst leaf's has no limit that holds:
  the reference computed at the configuration's own bfloat16 reads
  first-layer gaps as wide as the program's, and no fault reads ten times
  them (PERF.md, PR 14);
- ``change_gap_median`` and ``change_gap_worst``: the median and the
  worst leaf's gap of the norm of each leaf's change over the three
  steps, over the leaves whose reference gradient is not nought to
  rounding (at least a thousandth of the median leaf's): a bias under
  BatchNorm or the unlabelled probe moves by round-off and decay alone.
  The worst leaf catches a leaf left unmoved or moved double where its
  change is at least 0.6 of the median leaf's (at the cells' size 55 of
  69 leaves, not the stem).

Serving: ``mask_gap``, over a sample of the served requests, the widest
reference logit (over the request's logit spread) among the pixels whose
mask disagrees with the reference's sign.

On several ranks each number is the largest over the ranks
(``reduce_numbers``), so every rank's rows are judged.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

NOUGHT_TO_ROUNDING = 1e-3


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], names: Sequence[str], over=max) -> float:
    """``over`` (the largest, or the median) of the leaves' gaps."""
    gaps = [row[3] for row in worst_leaves(prog, ref, names, len(names))]
    return float(over(gaps)) if gaps else 0.0


def worst_leaves(prog: Dict[str, float], ref: Dict[str, float], names: Sequence[str], n: int = 4) -> list:
    """The ``n`` leaves of the largest gap: (name, program norm, reference
    norm, gap), for a look at what sets ``leaf_gap``."""
    floor = float(np.median([ref[k] for k in names])) if names else 0.0
    rows = [(k, prog[k], ref[k], abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-30)) for k in names]
    return sorted(rows, key=lambda r: -r[3])[:n]


def moving_leaves(ref_grad: Dict[str, float]) -> List[str]:
    med = float(np.median(list(ref_grad.values())))
    return [k for k, v in ref_grad.items() if v >= NOUGHT_TO_ROUNDING * med]


def bn_layer_gaps(prog: dict, ref: dict, batch_var: Dict[str, torch.Tensor], share: float) -> dict:
    """``prog``, ``ref``: layer → (running mean, running variance);
    ``batch_var``: layer → the reference's last batch variance; ``share``:
    ``1 − m^steps``. Each layer's (mean gap, variance gap): per channel over
    the batch standard deviation (means) or variance (variances) and over
    the share the steps hold in the running statistics, the root mean
    square over the channels. Not compared: bfloat16 alone moves them as
    far as statistics over one rank's rows do (PERF.md, PR 14); read by
    ``tools/calibrate.py``."""
    out = {}
    for k, (ref_mean, ref_var) in ref.items():
        v = batch_var[k].float() + 1e-5
        mean, var = prog[k][0].float() - ref_mean.float(), prog[k][1].float() - ref_var.float()
        out[k] = (float((mean ** 2 / v).mean().sqrt()) / share, float(((var / v) ** 2).mean().sqrt()) / share)
    return out


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref``: ``losses`` (list), ``grad`` and ``change``
    (leaf name → norm) and ``views`` where the cell has them."""
    moving = moving_leaves(ref["grad"])
    out = {
        "loss_gap": max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"])),
        "grad_gap_median": leaf_gap(prog["grad"], ref["grad"], list(ref["grad"]), np.median),
        "change_gap_median": leaf_gap(prog["change"], ref["change"], moving, np.median),
        "change_gap_worst": leaf_gap(prog["change"], ref["change"], moving),
    }
    if "views" in prog:
        out["views_mismatch"] = float(sum(int((a != b.to(a.dtype)).sum()) for a, b in zip(prog["views"],
                                                                                            ref["views"])))
    return out


def reduce_numbers(numbers: Dict[str, float], group, device) -> Dict[str, float]:
    """Each number the largest over the ranks of ``group`` (as it is
    without one; a number that is not a number reads infinite)."""
    if group is None:
        return numbers
    import torch.distributed as dist

    keys = sorted(numbers)
    t = torch.tensor([numbers[k] for k in keys], dtype=torch.float64, device=device).nan_to_num(nan=float("inf"))
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return dict(zip(keys, t.tolist()))


def mask_gap(masks: torch.Tensor, ref_logits: torch.Tensor) -> float:
    """``masks`` (B, H, W, 1) 0/1 of one request; ``ref_logits`` the
    reference's f32 logits of it."""
    z = ref_logits.float()
    wrong = masks.to(torch.bool) != (z > 0)
    if not bool(wrong.any()):
        return 0.0
    return float(z.abs()[wrong].max() / z.std().clamp_min(1e-30))


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """``{name: {"value", "limit"}}`` for every limited number; a number
    the run could not read is infinite and fails."""
    return {k: {"value": float(numbers.get(k, float("inf"))), "limit": float(lim)} for k, lim in limits.items()}


def passed(checks: Dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
