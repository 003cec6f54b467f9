#!/usr/bin/env python3
"""A traced run of one cell whose result line also carries the figures the
program's own spans give.

    python3 benchmark/tools/program_spans.py --workload <cell> --seed <n> --seconds <s>

The run is ``benchmark/run.py --trace 1`` in every respect (set-up,
window, comparison, every metric of the cell, the breakdown), with two
additions made in this process only: the window's kineto events are also
put down to the program's ``mis.*`` spans (``harness/program_trace.py``),
and the result's ``metrics`` gain what that attribution reads, rank 0's
figures:

- training: ``train_step.forward_ms``, ``.backward_ms``, ``.update_ms``
  (device ms a step launched under each phase) and, with global BatchNorm,
  ``batchnorm.global_ms``;
- serving: ``serve_request.host_ms``, ``.launches``, ``.syncs``,
  ``device.idle_pct.serve.forward``;
- ``program_span_coverage``: the share of the window's device-op time
  launched under a program span (serving: or under the harness's copies).

Standard error also gets one ``program_breakdown`` line: the window's
device seconds by innermost program span and kind of operation.

A program without the spans gives none of them. The benchmark's own runs
never run this.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import run as bench_run  # noqa: E402
from benchmark.harness import program_trace, spec, trace  # noqa: E402
from benchmark.harness.record import log  # noqa: E402

_last = {}


class _Capture(trace.capture):
    """``trace.capture`` that also keeps the window's attribution."""

    def __exit__(self, *exc):
        super().__exit__(*exc)
        if self._prof is not None and exc[0] is None and self.trace is not None:
            events = self._prof.profiler.kineto_results.events()
            _last["program"] = program_trace.attribute(events, self.trace.lo, self.trace.hi)
        return False


_read_plain = spec.read_metrics


def _read_metrics(metrics, run, bench_dir=spec.BENCH_DIR):
    out = _read_plain(metrics, run, bench_dir)
    pt = _last.pop("program", None)
    if pt is not None:
        log("program_breakdown " + json.dumps(pt.by_span()))
        figures = (program_trace.serve_figures(pt) if run.kind == "serve"
                   else program_trace.train_figures(pt, run.steps))
        out.update({k: {"value": float(v), "unit": program_trace.UNITS[k]} for k, v in figures.items()})
    return out


def install() -> None:
    """Route this process's runs through the attribution."""
    trace.capture = _Capture
    spec.read_metrics = _read_metrics


def main(argv=None) -> int:
    argv = [*(sys.argv[1:] if argv is None else argv), "--trace", "1"]
    install()
    # a cell on several chips starts one rank a card from the file that ``launch_ranks``
    # names: this one, so that each rank is routed through the attribution too
    bench_run.__file__ = os.path.abspath(__file__)
    sys.argv[1:] = argv
    return bench_run.main(argv)


if __name__ == "__main__":
    sys.exit(main())
