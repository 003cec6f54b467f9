#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs the cell that ``BENCHMARK.json`` names (its configuration, its
traffic mix and the driver the traffic names) on the machine's cards: the
set-up (weights and inputs made from the seed, every shape warmed up),
``--seconds`` of measured window, then the comparison with the plain
reference that decides ``correct``. The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and last ``checks``: each compared
number beside its limit); the checks are also the last lines of standard
error. ``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1``
its per-layer metrics, read from a ``torch.profiler`` trace of the window.

A cell on several chips starts its own ranks (one process a card, joined
over NCCL on a free local port); each compared number is the largest over
the ranks, and rank 0's line is the run's.

Exits non-zero and prints no result without a CUDA card (or with fewer
than the cell asks for), when the program does not import, and when JAX,
the JAX package or its libraries are loaded in the process that prints.
Every build cache of the program (the kernels) lives under ``build/`` of
the checkout.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "build")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "medical_image_segmentation_tpu"}
RANK_MARK = "MIS_BENCHMARK_RANK"


def _cache_env() -> None:
    """Every build and kernel cache at a fixed place inside the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(CACHE, "benchmark", sub)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="One run of one benchmark cell of the PyTorch/CUDA port.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_ranks(args, chips: int) -> int:
    """Start one rank a card and wait for all; print rank 0's line."""
    port = _free_port()
    procs = []
    for r in range(chips):
        env = {**os.environ, RANK_MARK: "1", "RANK": str(r), "WORLD_SIZE": str(chips), "LOCAL_RANK": str(r),
               "LOCAL_WORLD_SIZE": str(chips), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
               "MIS_BENCHMARK_T0": repr(T_START)}
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), *sys.argv[1:]], env=env,
                                      stdout=subprocess.PIPE if r == 0 else subprocess.DEVNULL, text=True))
    try:
        out, _ = procs[0].communicate(timeout=345 - (time.time() - T_START))
        rcs = [procs[0].returncode] + [p.wait(timeout=max(1.0, 350 - (time.time() - T_START))) for p in procs[1:]]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        print("benchmark: a rank did not finish in time", file=sys.stderr)
        return 1
    lines = [ln for ln in (out or "").splitlines() if ln.strip()]
    if any(rcs) or not lines:
        print(f"benchmark: ranks exited {rcs}", file=sys.stderr)
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded: {bad}", file=sys.stderr)
        return 1
    result = json.loads(lines[-1])
    _print_checks(result["checks"])
    print(lines[-1], flush=True)
    return 0


def _print_checks(checks: dict) -> None:
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()


class Context:
    """What a driver needs of the run: the cell, the seed, the window, the
    device and this process's place among the ranks."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool, device, mesh=None, t_start: float = T_START):
        import torch

        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device = torch.device(device)
        self.mesh = mesh
        self.group = mesh.group("data") if mesh is not None else None
        self.rank = mesh.rank if mesh is not None else 0
        self.world = mesh.world_size if mesh is not None else 1
        self.local_world = int(os.environ.get("LOCAL_WORLD_SIZE", "1")) if mesh is not None else 1
        self.t_start = t_start

    def peak_memory(self):
        import torch

        return torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else None


def _reduce(values, op: str, ctx):
    """Every rank's ``values`` reduced (``max`` or ``mean``) over the ranks."""
    import torch
    import torch.distributed as dist

    t = torch.tensor(values, dtype=torch.float64, device=ctx.device)
    if ctx.group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM, group=ctx.group)
        if op == "mean":
            t /= ctx.world
    return t.tolist()


def run_cell(args, cell, device, mesh=None, t_start: float = T_START) -> dict:
    """One run: the driver's window and comparison, the metrics and the
    result's fields."""
    from benchmark.harness import card, checks, spec
    from benchmark.harness.record import log

    ctx = Context(cell, args.seed, args.seconds, bool(args.trace), device, mesh, t_start)
    driver = spec.load_module("drivers", cell.traffic["driver"])
    log(f"cell {cell.name}, seed {args.seed}: program and driver imported")
    run, numbers = driver.run(ctx)
    log("compared with the reference")
    fields = card.card_fields(ctx.device.index or 0) if ctx.device.type == "cuda" else None
    run.peaks = card.peaks(fields["kind"]) if fields else None
    busy = [run.trace.busy_ns() / 1e9 if run.trace is not None else 0.0]
    peak = [float(run.memory_peak_bytes or 0)]
    run.busy_s = _reduce(busy, "mean", ctx)[0] if args.trace else None
    peak = int(_reduce(peak, "max", ctx)[0])
    result = {"correct": False, "attempted": run.steps, "failed": 0,
              "metrics": spec.read_metrics(cell.metrics(bool(args.trace)), run)}
    dev = {"platform": "gpu" if fields else ctx.device.type, "kind": fields["kind"] if fields else "cpu",
           "count": ctx.world, "memory_peak_bytes": peak}
    if args.trace and run.trace is not None:
        dev["busy_s"] = run.busy_s
        dev["window_s"] = (run.trace.hi - run.trace.lo) / 1e9
        result["breakdown"] = {"device_ops": [list(x) for x in run.trace.kinds()[:10]],
                               "idle_gaps": [list(x) for x in run.trace.idle_gaps(10)]}
    result["device"] = dev
    if fields:
        result["card"] = fields
    result["cell"], result["seed"], result["window_s"] = cell.name, args.seed, run.window_s
    verdict = checks.verdict(checks.reduce_numbers(numbers, ctx.group, ctx.device), cell.traffic["limits"])
    result["correct"] = checks.passed(verdict)
    result["checks"] = verdict
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    os.environ.setdefault("MIS_BENCHMARK_T0", repr(T_START))
    _cache_env()
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark.harness import spec

    cell = spec.find_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: cell {cell.name} needs {cell.chips} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()} and {n} card(s) are visible", file=sys.stderr)
        return 2
    is_rank = os.environ.get(RANK_MARK) == "1"
    if cell.chips > 1 and not is_rank:
        return launch_ranks(args, cell.chips)
    mesh, t_start = None, T_START
    if is_rank:
        from medical_image_segmentation_tpu_torch.parallel.mesh import (
            initialize_distributed, make_mesh, shutdown_distributed,
        )

        proc = initialize_distributed("cuda")
        mesh = make_mesh(("data",), device=proc.device)
        t_start = float(os.environ["MIS_BENCHMARK_T0"])
        device = proc.device
    else:
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    try:
        result = run_cell(args, cell, device, mesh, t_start)
    finally:
        if is_rank:
            shutdown_distributed()
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded: {bad}", file=sys.stderr)
        return 1
    if mesh is None or mesh.rank == 0:
        _print_checks(result["checks"])
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
