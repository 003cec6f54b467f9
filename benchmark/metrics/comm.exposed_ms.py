"""Per step, the ms of collective (NCCL) kernels during which no other
kernel ran on rank 0's card, from the trace's intervals."""

from benchmark.harness.trace import exposed_ns


def read(run):
    if run.trace is None or run.chips < 2 or not run.steps:
        return None
    nccl_s, nccl_e = run.trace.arrays(lambda n: "nccl" in n.lower())
    if not len(nccl_s):
        return None
    other_s, other_e = run.trace.arrays(lambda n: "nccl" not in n.lower())
    return exposed_ns(nccl_s, nccl_e, other_s, other_e) / 1e6 / run.steps
