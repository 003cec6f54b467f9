"""Device ms a step launched under the program's ``mis.train.forward`` span
(``program_trace.train_figures``: the network's forward and the loss)."""


def read(run):
    from benchmark.harness.program_trace import train_figures

    pt = getattr(run, "program", None)
    if pt is None or run.kind != "train":
        return None
    return train_figures(pt, run.steps).get("train_step.forward_ms")
