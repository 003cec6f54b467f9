"""The Swin UNETR cell (``swin_unetr_liver.train``) at a size a CPU test
can hold, and one run of it without the harness's look for a card."""

from __future__ import annotations

import argparse

import torch

from benchmark import run as bench_run
from benchmark.harness import spec

TINY = {
    "swin_unetr_liver": dict(feature_size=12, patch=[32, 32, 32], batch_per_chip=2),
}
TINY_TRAFFIC = {
    "swin_unetr_liver.train": dict(ring_volumes=3, volume=[36, 40, 38]),
}


def tiny_cell(name: str, dtype: str = "float32"):
    """The cell at a tiny size, its program in ``dtype`` (float32 makes a
    sound run agree with the reference to rounding)."""
    cell = spec.find_cell(name)
    cell.config.update(TINY[cell.config_name], dtype=dtype)
    cell.traffic.update(TINY_TRAFFIC[cell.traffic_name])
    return cell


def run_tiny(name: str, seed: int = 2**31 + 41, trace: int = 0, dtype: str = "float32") -> dict:
    """One run of the tiny cell on the CPU."""
    torch.set_num_threads(2)
    args = argparse.Namespace(seed=seed, seconds=0.3, trace=trace)
    return bench_run.run_cell(args, tiny_cell(name, dtype), torch.device("cpu"))
