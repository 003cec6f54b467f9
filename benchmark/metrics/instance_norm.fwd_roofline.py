"""InstanceNorm + LeakyReLU forward's share of its roofline: the least time
its bytes need at the card's published bandwidth (each normalized value
read once and its activation written once, in the configuration's dtype,
from the shapes) over the device time a step launched under the program's
``mis.norm.instance`` spans. The norm is bound by bytes: a few operations
a value."""

from benchmark.harness.program_capture import span_ms_per_step


def read(run):
    need = getattr(run, "norm_bytes_per_step", None)
    ms = span_ms_per_step(run, ("mis.norm.instance",))
    if not need or not ms or not run.peaks:
        return None
    return 100.0 * need / run.peaks[1] / (ms / 1e3)
