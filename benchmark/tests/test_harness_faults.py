"""A run with the timed path broken underneath comes out not correct.

Each cell runs at a tiny size on the CPU, its program in float32 (where a
sound run agrees with the reference to rounding), without the harness's
look for a card: once sound, which must pass its limits, then once with
each fault it can have (``harness/faults.py``). The data-parallel cell runs
in two gloo ranks."""

import os
import socket
import traceback

import pytest
import torch.multiprocessing as mp

from benchmark.harness import faults

from _bench_tiny import run_tiny

CASES = [("byol_r18.device", None), ("byol_r18.device", "unchanged"), ("byol_r18.device", "half_batch"),
         ("byol_r18.device", "altered"), ("byol_r18.device", "leaf_unmoved"),
         ("unet_r18.serve", None), ("unet_r18.serve", "half_batch"), ("unet_r18.serve", "altered")]


@pytest.mark.parametrize("cell, fault", CASES)
def test_one_chip_cells(cell, fault):
    kind = "serve" if cell.startswith("unet") else "train"
    if fault is None:
        assert run_tiny(cell)["correct"]
        return
    with faults.fault(fault, kind):
        result = run_tiny(cell)
    assert not result["correct"], result["checks"]


def _rank(rank, world, port, fault, out):
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
                       "LOCAL_WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)})
    from medical_image_segmentation_tpu_torch.parallel.mesh import (
        initialize_distributed, make_mesh, shutdown_distributed,
    )

    try:
        initialize_distributed("cpu")
        mesh = make_mesh(("data",))
        if fault:
            with faults.fault(fault, "train"):
                result = run_tiny("byol_r18.ddp4", mesh=mesh)
        else:
            result = run_tiny("byol_r18.ddp4", mesh=mesh)
        out.put((rank, result["correct"], result["checks"]))
    except BaseException:
        out.put((rank, None, traceback.format_exc()))
    finally:
        shutdown_distributed()


@pytest.mark.parametrize("fault", [None, "no_exchange", "half_batch", "unchanged"])
def test_data_parallel_cell_in_two_ranks(fault):
    ctx = mp.get_context("spawn")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, 2, port, fault, out)) for r in range(2)]
    for p in procs:
        p.start()
    results = sorted(out.get(timeout=300) for _ in procs)
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive()
    assert results[0][1] is not None, results[0][2]
    assert results[0][1] is (fault is None), results[0][2]
