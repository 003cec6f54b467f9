"""The serving forward's share of the chip's dense bf16 peak: the U-Net
forward FLOPs of one request (counted from the shapes) times the requests,
over the window, over the peak."""


def read(run):
    if run.kind != "serve" or not run.peaks or not run.flops_per_step or run.window_s <= 0:
        return None
    return 100.0 * run.flops_per_step * run.requests / run.window_s / (run.peaks[0] * run.chips)
