"""Cells of ``BENCHMARK.json`` at sizes a CPU test can hold, and one run of
them without the harness's look for a card."""

from __future__ import annotations

import argparse

import torch

from benchmark import run as bench_run
from benchmark.harness import spec

TINY = {
    "byol_r18": dict(batch_per_chip=8, image_size=64, crop_size=32, hidden_dim=64, proj_dim=16),
    "unet_r18": dict(image_size=64),
}
TINY_TRAFFIC = {
    "unet_serve": dict(request_slices=4, pool=16, request_ring=4, sample_requests=3, setup_requests=1),
    "byol_train": dict(setup_steps=3),
}


def tiny_cell(name: str, dtype: str = "float32"):
    """The cell at a tiny size, its program in ``dtype`` (float32 makes a
    sound run agree with the reference to rounding)."""
    cell = spec.find_cell(name)
    cell.config.update(TINY[cell.config_name], dtype=dtype)
    cell.traffic.update(TINY_TRAFFIC[cell.traffic["driver"]])
    return cell


def run_tiny(name: str, seed: int = 2**31 + 11, mesh=None) -> dict:
    """One untraced run of the tiny cell on the CPU."""
    torch.set_num_threads(2)
    args = argparse.Namespace(seed=seed, seconds=0.3, trace=0)
    return bench_run.run_cell(args, tiny_cell(name), torch.device("cpu"), mesh)
