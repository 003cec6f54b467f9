"""The card a run measures: its name, power limit and published peaks.

``PEAK_FLOPS`` and ``card_fields`` are copies of ``bench_torch.py``'s
``_PEAK_FLOPS`` and ``_card_fields`` (NVIDIA's data sheets, dense bf16
without sparsity; ``nvidia-smi --query-gpu=name,power.limit``). The
memory bandwidth beside them is the same data sheets' HBM figure.
"""

from __future__ import annotations

import contextlib
import subprocess
from typing import Optional

import torch

# name fragment (lower case): (dense bf16 FLOP/s, HBM bytes/s)
PEAKS = {
    "h100 80gb hbm3": (989.4e12, 3.35e12),
    "h100 sxm": (989.4e12, 3.35e12),
    "h100 pcie": (756e12, 2.0e12),
}


def peaks(kind: str):
    """(FLOP/s, bytes/s) of the card named ``kind``; None for a card the
    table does not hold."""
    kind = kind.lower()
    for k, v in sorted(PEAKS.items(), key=lambda kv: -len(kv[0])):
        if k in kind:
            return v
    return None


def card_fields(index: int = 0) -> dict:
    """``kind`` as ``torch.cuda.get_device_name`` gives it, and the name and
    power limit of ``nvidia-smi``'s line for the card (None where it gives
    nothing)."""
    out = {"kind": torch.cuda.get_device_name(index), "smi_name": None, "power_limit_w": None}
    try:
        lines = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                               capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        lines = []
    if index < len(lines):
        name, _, limit = lines[index].rpartition(",")
        out["smi_name"] = name.strip()
        with contextlib.suppress(ValueError):
            out["power_limit_w"] = float(limit.strip().split()[0])
    return out


def peak_memory(device) -> Optional[int]:
    return torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else None
