"""The control comes out not correct: the reference computed with float8
operands (the precision below the configurations' bfloat16), put in the
program's place, fails at least one of a cell's limits. On the card, at a
size a test run holds (the readings at the cells' own sizes are
``tools/calibrate.py``'s); skipped without a card."""

import pytest
import torch

from benchmark import run as bench_run
from benchmark.harness import spec

SMALLER = {"byol_r18": {"batch_per_chip": 256}, "unet_r18": {}}


@pytest.mark.gpu
@pytest.mark.parametrize("cell_name", ["byol_r18.device", "unet_r18.serve"])
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 102, 2**31 + 103])
def test_control_fails_a_limit(cell_name, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs the program's kernels at their sizes")
    bench_run._cache_env()
    cell = spec.find_cell(cell_name)
    cell.config.update(SMALLER[cell.config_name])
    if "request_slices" in cell.traffic:
        cell.traffic.update(request_slices=16, sample_requests=4)
    driver = spec.load_module("drivers", cell.traffic["driver"])
    ctx = bench_run.Context(cell, seed, 1.0, False, torch.device("cuda", 0))
    state = driver.setup(ctx)
    if cell.traffic["driver"] == "unet_serve":
        from benchmark.harness.record import Run

        driver.window(ctx, state, Run(cell=cell, chips=1, kind="serve"))
    driver.release(state)
    numbers = driver.control_numbers(ctx, state)
    limits = cell.traffic["limits"]
    assert any(numbers[k] > limits[k] for k in limits if k in numbers), numbers
