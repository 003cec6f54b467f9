"""``trace.capture`` that also keeps the window's kineto events put down to
the program's spans (``program_trace.attribute``) as ``cap.program``: the
per-layer metrics of a driver that captures with it read the program's
``mis.*`` spans from the run (``run.program``). None when not tracing."""

from __future__ import annotations

from benchmark.harness import program_trace, trace


class capture(trace.capture):
    program = None

    def __exit__(self, *exc):
        super().__exit__(*exc)
        if self._prof is not None and exc[0] is None and self.trace is not None:
            events = self._prof.profiler.kineto_results.events()
            self.program = program_trace.attribute(events, self.trace.lo, self.trace.hi)
        return False


def span_ms_per_step(run, names) -> float:
    """Device ms a step launched under any of the program's spans
    ``names``; None without a program trace or without the spans."""
    pt = getattr(run, "program", None)
    if pt is None or not run.steps or not any(pt.spans_named(n) for n in names):
        return None
    return pt.op_ns_under(names) / 1e6 / run.steps
