"""MB (10^6 bytes) a step that rank 0 hands to collectives: the program's
``comm.bytes`` counter (each collective's buffer on this rank, numel ×
element size) over the traced window's steps."""

from benchmark.harness.program_trace import counter_per_step


def read(run):
    per_step = counter_per_step(run, "comm.bytes") if run.chips > 1 else None
    return per_step / 1e6 if per_step is not None else None
