"""Device ms a step launched under the program's ``mis.train.backward`` span
(``program_trace.train_figures``: autograd's kernels, put down to the span
open on the thread that entered ``backward``)."""


def read(run):
    from benchmark.harness.program_trace import train_figures

    pt = getattr(run, "program", None)
    if pt is None or run.kind != "train":
        return None
    return train_figures(pt, run.steps).get("train_step.backward_ms")
