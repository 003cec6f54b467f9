#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from, for the Swin UNETR
training cell (``drivers/swin_train.py``), at the cell's own size.

    python3 benchmark/tools/calibrate_swin.py --workload swin_unetr_liver.train --seeds 11 12 ... [--look] \
        [--control_seeds 21 22 23] [--faults unchanged half_batch leaf_unmoved altered no_shift no_rel_bias] \
        [--fault_seeds 31 32]

``tools/calibrate_seg.py``'s readings with the faults of
``harness/swin_faults.py`` (``unchanged`` extended to AdamW, ``no_shift``,
``no_rel_bias``), and with every leaf's gradient and change norms, the
program's (or the control's, or the fault's) beside the reference's, in
each reading's JSON line, so that a compared number can be weighed leaf by
leaf. Then the summary of ``calibrate_seg``. The benchmark's own runs never
run this.
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
from benchmark.tools.calibrate_seg import summary  # noqa: E402


def reading(driver, ctx, label: str, fault) -> dict:
    """One reading: the numbers and the leaves of one seeded set-up."""
    import torch

    from benchmark.harness import swin_faults
    from benchmark.reference import nets

    with swin_faults.fault(fault) if fault else contextlib.nullcontext():
        state = driver.setup(ctx)
    driver.release(state)
    ref = driver.reference(ctx, state)
    if label == "control":
        side = driver.reference(ctx, state, "fp8")
        x, y = side["inputs"]
        side["inputs"] = (nets.round_fp8(x.float()).to(x.dtype), y)
    else:
        side = driver.program_readings(state)
    row = {"reading": label, "seed": ctx.seed, "numbers": driver.numbers(ctx, side, ref),
           "losses": [side["losses"], ref["losses"]],
           "leaves": {k: [side["grad"][k], ref["grad"][k], side["change"][k], ref["change"][k]] for k in ref["grad"]}}
    del state
    torch.cuda.empty_cache()
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control_seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--fault_seeds", type=int, nargs="*", default=[])
    args = ap.parse_args()
    bench_run._cache_env()
    import torch

    from benchmark.harness import spec

    cell = spec.find_cell(args.workload)
    driver = spec.load_module("drivers", cell.traffic["driver"])
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    plan = [("program", s, None) for s in args.seeds] + [("control", s, None) for s in args.control_seeds]
    plan += [(f, s, f) for f in args.faults for s in args.fault_seeds]
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark)
    out = []
    for label, seed, fault in plan:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.benchmark) = flags
        out.append(reading(driver, bench_run.Context(cell, seed, 1.0, False, device), label, fault))
        print(json.dumps(out[-1]), flush=True)
    print(json.dumps({"summary": summary(out), "limits": cell.traffic["limits"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
