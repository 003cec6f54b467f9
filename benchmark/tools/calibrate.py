#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from, at a cell's own size.

    python3 benchmark/tools/calibrate.py --workload <cell> --seeds 11 12 ... [--look] \
        [--control_seeds 21 22 23] [--faults half_batch altered ...] [--fault_seeds 31 32 33] [--seconds 2]

In one process (one a card for a cell on several chips), for each seed:
the cell's set-up as a run makes it (weights and inputs from the seed, the
set-up steps through the program), for serving a short window at the
cell's load, then the comparison with the reference. The control (the
reference at the precision below the configuration's, put in the
program's place) and each planted fault (``harness/faults.py``) are read
the same way; on several ranks each number is the largest over them, as a
run takes it. With ``--look``, each program reading of a training cell
also has the reference computed at bfloat16 read against itself, leaf by
leaf beside the program. One JSON line a reading on standard output, then
a summary: the largest program reading and the smallest control and fault
readings of each number. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import run as bench_run  # noqa: E402


def readings(args, cell, device, mesh) -> list:
    import torch

    from benchmark.harness import checks, faults, record, spec

    driver = spec.load_module("drivers", cell.traffic["driver"])
    kind = "serve" if cell.traffic["driver"].endswith("serve") else "train"
    plan = [("program", s, None) for s in args.seeds] + [("control", s, None) for s in args.control_seeds]
    plan += [(f, s, f) for f in args.faults for s in args.fault_seeds]
    out = []
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark)
    for label, seed, fault in plan:
        # each reading starts as a fresh process would: the reference turned TF32 and the search off
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.benchmark) = flags
        ctx = bench_run.Context(cell, seed, args.seconds, False, device, mesh)
        with faults.fault(fault, kind) if fault else contextlib.nullcontext():
            state = driver.setup(ctx)
            if kind == "serve":
                driver.window(ctx, state, record.Run(cell=cell, chips=ctx.world, kind=kind))
            driver.release(state)
        detail = None
        if label == "control":
            numbers = driver.control_numbers(ctx, state)
        elif kind == "train":
            ref = driver.reference(ctx, state)
            detail = {"program": leaf_detail(checks, driver.program_readings(state), ref)}
            numbers = checks.train_numbers(driver.program_readings(state), ref)
            if args.look and label == "program":
                # the look: the reference at the configuration's bfloat16 against itself in float32
                detail["look"] = leaf_detail(checks, driver.reference(ctx, state, "bf16"), ref)
        else:
            numbers = driver.compare(ctx, state)
        numbers = checks.reduce_numbers(numbers, ctx.group, ctx.device)
        out.append({"reading": label, "seed": seed, "numbers": numbers, "detail": detail})
        if ctx.rank == 0:
            print(json.dumps(out[-1]), flush=True)
        del state
        torch.cuda.empty_cache()
    return out


def leaf_detail(checks, side: dict, ref: dict) -> dict:
    """Every leaf's gap of ``side`` against the reference (gradient and
    change, as ``checks`` takes them), the worst of each, and the
    BatchNorm layers of the widest running-mean and running-variance gaps."""
    moving = checks.moving_leaves(ref["grad"])
    grad = checks.worst_leaves(side["grad"], ref["grad"], list(ref["grad"]), len(ref["grad"]))
    change = checks.worst_leaves(side["change"], ref["change"], moving, len(moving))
    bn = checks.bn_layer_gaps(side["bn"], ref["bn"], ref["bn_batch_var"], ref["bn_share"])
    return {"losses": [side["losses"], ref["losses"]],
            "grad_worst": grad[0][::3], "change_worst": change[0][::3],
            "grad": {r[0]: round(r[3], 5) for r in grad}, "change": {r[0]: round(r[3], 5) for r in change},
            "ref_change": {k: round(v, 7) for k, v in ref["change"].items()},
            "bn_mean": {k: round(v[0], 6) for k, v in sorted(bn.items(), key=lambda kv: -kv[1][0])[:6]},
            "bn_var": {k: round(v[1], 6) for k, v in sorted(bn.items(), key=lambda kv: -kv[1][1])[:6]},
            "left_out_of_change": sorted(set(ref["grad"]) - set(moving))}


def summary(out: list) -> dict:
    names = sorted({k for r in out for k in r["numbers"]})
    res = {}
    for label in sorted({r["reading"] for r in out}):
        rows = [r["numbers"] for r in out if r["reading"] == label]
        pick = max if label == "program" else min
        res[label] = {k: pick(r[k] for r in rows if k in r) for k in names if any(k in r for r in rows)}
    # the worst leaves, program beside the look, a seed a row
    res["worst"] = [[r["seed"], *(r["detail"][side][w][1] for w in ("grad_worst", "change_worst")
                                  for side in ("program", "look"))]
                    for r in out if r["reading"] == "program" and r["detail"] and "look" in r["detail"]]
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control_seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--fault_seeds", type=int, nargs="*", default=[])
    ap.add_argument("--look", action="store_true",
                    help="train cells: beside each program reading, the reference at bfloat16 against itself")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args()
    bench_run._cache_env()
    from benchmark.harness import spec

    cell = spec.find_cell(args.workload)
    import torch

    is_rank = os.environ.get(bench_run.RANK_MARK) == "1"
    if cell.chips > 1 and not is_rank:
        port = bench_run._free_port()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), *sys.argv[1:]],
                                  env={**os.environ, bench_run.RANK_MARK: "1", "RANK": str(r),
                                       "WORLD_SIZE": str(cell.chips), "LOCAL_RANK": str(r),
                                       "LOCAL_WORLD_SIZE": str(cell.chips), "MASTER_ADDR": "127.0.0.1",
                                       "MASTER_PORT": str(port)}) for r in range(cell.chips)]
        return max(p.wait() for p in procs)
    mesh = None
    if is_rank:
        from medical_image_segmentation_tpu_torch.parallel.mesh import initialize_distributed, make_mesh

        proc = initialize_distributed("cuda")
        mesh = make_mesh(("data",), device=proc.device)
        device = proc.device
    else:
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    out = readings(args, cell, device, mesh)
    if mesh is None or mesh.rank == 0:
        print(json.dumps({"summary": summary(out), "limits": cell.traffic["limits"]}), flush=True)
    if is_rank:
        from medical_image_segmentation_tpu_torch.parallel.mesh import shutdown_distributed

        shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
