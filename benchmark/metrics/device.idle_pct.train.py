"""The share of the traced window in which no operation ran on the device
(the union of the trace's kernel, copy and fill intervals), averaged over
the chips."""

from benchmark.harness.trace import idle_pct


def read(run):
    return idle_pct(run) if run.kind == "train" else None
