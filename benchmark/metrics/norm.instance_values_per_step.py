"""Values InstanceNorm normalizes a step: the program's
``norm.instance_values`` counter (each norm's input, batch × width × voxels,
counted once a forward, not in a recompute) over the traced window's
steps."""

from benchmark.harness.program_trace import counter_per_step


def read(run):
    return counter_per_step(run, "norm.instance_values") if run.kind == "train" else None
