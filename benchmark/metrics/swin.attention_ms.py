"""Device ms a step launched under the program's ``mis.swin.attention`` spans
(each Swin block's window attention: the qkv projection, the relative
position bias's gather, the attention and the output projection; forward
only, the backward's kernels fall under ``mis.train.backward``)."""

from benchmark.harness.program_capture import span_ms_per_step


def read(run):
    return span_ms_per_step(run, ("mis.swin.attention",)) if run.kind == "train" else None
