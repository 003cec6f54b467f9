"""Samples finished by train steps over every chip, over the whole window
(which ends in a synchronize). A sample is one image of the global batch."""


def read(run):
    if run.kind != "train" or run.window_s <= 0:
        return None
    return run.samples / run.window_s
