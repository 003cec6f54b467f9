"""Collective calls a step on rank 0: the program's ``comm.calls`` counter
(every all-reduce and broadcast of ``parallel/mesh.py``: global
BatchNorm's statistics and backward sums, the gradient buckets, the step's
metrics) over the traced window's steps."""

from benchmark.harness.program_trace import counter_per_step


def read(run):
    return counter_per_step(run, "comm.calls") if run.chips > 1 else None
