"""The whole train step's share of the chips' dense bf16 peak: the model
FLOPs of one global step (counted from the configuration's shapes by the
benchmark's plain networks: online forward and backward and target forward
of both views) times the window's steps, over the window, over the peak
times the chips."""


def read(run):
    if run.kind != "train" or not run.peaks or not run.flops_per_step or run.window_s <= 0:
        return None
    return 100.0 * run.flops_per_step * run.steps / run.window_s / (run.peaks[0] * run.chips)
