"""Window attention's share of its roofline: the least time of its work a
step at the card's published peaks (``harness/swin_counts.py``: 4·n·d FLOPs
a padded query token and head at the dense bf16 peak, or q, k, v and the
output moved once in bf16 with the bias tables and shift masks at the
published bandwidth, whichever is longer) over the device time a step
launched under the program's ``mis.swin.attention`` spans. The spans also
hold the qkv and output projections, which the least time leaves out."""

from benchmark.harness.program_capture import span_ms_per_step


def read(run):
    flops = getattr(run, "attention_flops_per_step", None)
    nbytes = getattr(run, "attention_bytes_per_step", None)
    ms = span_ms_per_step(run, ("mis.swin.attention",))
    if not flops or not nbytes or not ms or not run.peaks:
        return None
    least_s = max(flops / run.peaks[0], nbytes / run.peaks[1])
    return 100.0 * least_s / (ms / 1e3)
