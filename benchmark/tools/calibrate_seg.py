#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from, for the
segmentation training cells (``drivers/seg_train.py``), at a cell's own size.

    python3 benchmark/tools/calibrate_seg.py --workload <cell> --seeds 11 12 ... [--look] \
        [--control_seeds 21 22] [--faults unchanged half_batch ...] [--fault_seeds 31 32]

In one process on the card, for each seed: the cell's set-up as a run
makes it (weights and data from the seed, the set-up steps through the
program), then the comparison with the reference. The control (the
reference in float8 put in the program's place) and each planted fault
(``harness/seg_faults.py``) are read the same way. With ``--look``, each
program reading also has the reference computed at bfloat16 read against
itself. One JSON line a reading on standard output (with the leaves of the
widest gradient and change gaps), then a summary: the largest program and
look readings and the smallest control and fault readings of each number.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import run as bench_run  # noqa: E402


def readings(args, cell, device) -> list:
    import torch

    from benchmark.harness import checks, seg_faults, spec

    driver = spec.load_module("drivers", cell.traffic["driver"])
    plan = [("program", s, None) for s in args.seeds] + [("control", s, None) for s in args.control_seeds]
    plan += [(f, s, f) for f in args.faults for s in args.fault_seeds]
    out = []
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark)
    for label, seed, fault in plan:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.benchmark) = flags
        ctx = bench_run.Context(cell, seed, 1.0, False, device)
        with seg_faults.fault(fault) if fault else contextlib.nullcontext():
            state = driver.setup(ctx)
        peak = ctx.peak_memory()
        driver.release(state)
        row = {"reading": label, "seed": seed, "memory_peak_bytes": peak}
        if label == "control":
            row["numbers"] = driver.control_numbers(ctx, state)
        else:
            prog = driver.program_readings(state)
            ref = driver.reference(ctx, state)
            row["numbers"] = driver.numbers(ctx, prog, ref)
            moving = checks.moving_leaves(ref["grad"])
            row["grad_worst"] = checks.worst_leaves(prog["grad"], ref["grad"], list(ref["grad"]), 3)
            row["change_worst"] = checks.worst_leaves(prog["change"], ref["change"], moving, 3)
            row["losses"] = [prog["losses"], ref["losses"]]
            if args.look and label == "program":
                row["look"] = driver.numbers(ctx, driver.reference(ctx, state, "bf16"), ref)
        out.append(row)
        print(json.dumps(row), flush=True)
        del state
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    return out


def summary(out: list) -> dict:
    res = {}
    for label in sorted({r["reading"] for r in out}):
        rows = [r["numbers"] for r in out if r["reading"] == label]
        pick = max if label == "program" else min
        res[label] = {k: pick(r[k] for r in rows) for k in rows[0]}
    looks = [r["look"] for r in out if "look" in r]
    if looks:
        res["look"] = {k: max(r[k] for r in looks) for k in looks[0]}
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control_seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--fault_seeds", type=int, nargs="*", default=[])
    ap.add_argument("--look", action="store_true", help="beside each program reading, the reference at bfloat16")
    args = ap.parse_args()
    bench_run._cache_env()
    from benchmark.harness import spec

    cell = spec.find_cell(args.workload)
    import torch

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = readings(args, cell, device)
    print(json.dumps({"summary": summary(out), "limits": cell.traffic["limits"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
