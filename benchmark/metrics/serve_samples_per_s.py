"""Slices masked and returned to host memory, over the whole window."""


def read(run):
    if run.kind != "serve" or run.window_s <= 0:
        return None
    return run.samples / run.window_s
