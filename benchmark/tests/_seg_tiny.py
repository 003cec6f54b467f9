"""The segmentation training cells at sizes a CPU test can hold, and one
run of them without the harness's look for a card."""

from __future__ import annotations

import argparse

import torch

from benchmark import run as bench_run
from benchmark.harness import spec

TINY = {
    "nnunet3d_liver": dict(features=[4, 8, 16, 16], patch=[16, 16, 16]),
    "unet_r18": dict(image_size=64),
}
TINY_TRAFFIC = {
    "nnunet3d_liver.train": dict(ring_volumes=3, volume=[20, 24, 22]),
    "unet_r18.train": dict(batch_per_chip=6, stored_size=96, ring_batches=2),
}


def tiny_cell(name: str, dtype: str = "float32"):
    """The cell at a tiny size, its program in ``dtype`` (float32 makes a
    sound run agree with the reference to rounding)."""
    cell = spec.find_cell(name)
    cell.config.update(TINY[cell.config_name], dtype=dtype)
    cell.traffic.update(TINY_TRAFFIC[cell.traffic_name])
    return cell


def run_tiny(name: str, seed: int = 2**31 + 29, trace: int = 0, dtype: str = "float32") -> dict:
    """One run of the tiny cell on the CPU."""
    torch.set_num_threads(2)
    args = argparse.Namespace(seed=seed, seconds=0.3, trace=trace)
    return bench_run.run_cell(args, tiny_cell(name, dtype), torch.device("cpu"))
