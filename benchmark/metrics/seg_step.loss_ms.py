"""Device ms a step launched under the program's ``mis.seg.loss`` span (the
segmentation loss inside ``train.forward``: the deep-supervision targets'
downsampling and the weighted Dice + CE over every output for nnU-Net,
the sigmoid Dice for the 2D U-Net)."""

from benchmark.harness.program_capture import span_ms_per_step


def read(run):
    return span_ms_per_step(run, ("mis.seg.loss",)) if run.kind == "train" else None
