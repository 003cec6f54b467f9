"""The device operations of a traced window put down to the program's own
spans, and the per-layer figures that read them.

The program (``medical_image_segmentation_tpu_torch/core/profiling.py``)
opens ``mis.<name>`` ranges of ``torch.profiler`` while a profiler
records: the BYOL step's phases, the augmentation, global BatchNorm, the
served request. They share the device trace's clock, so each device
operation (kernel, copy, fill) is put down to the spans open where it was
launched:

1. the spans that enclose the runtime call that launched it (the call
   with the operation's ``correlation_id``, or failing one, the CPU op its
   ``linked_correlation_id`` names) on that call's own thread, innermost
   first;
2. then the spans open at that instant on the thread that entered
   ``backward``, for a call on autograd's device thread (the thread whose
   operators carry another ``fwd_thread_id``): a kernel that autograd
   launches under ``mis.train.backward`` is put down to it.

Device time is never matched against host time: an operation belongs to
the spans around its launch, wherever it ran. The harness's own spans
(``harness.*``) are kept beside the program's, so the served request's
copies can be counted too.

``attribute`` builds a ``ProgramTrace`` from kineto events (``name()``,
``device_type()``, ``start_ns()``, ``duration_ns()``,
``correlation_id()``, ``linked_correlation_id()``, ``start_thread_id()``,
``fwd_thread_id()``, ``is_user_annotation()``; ``activity_type()`` where
the profiler has it); everything else is arithmetic over it.
"""

from __future__ import annotations

import bisect
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from benchmark.harness.trace import DEVICE_ACTIVITIES, exposed_ns, kind_of

PROGRAM = "mis."
HARNESS = "harness."
RUNTIME_ACTIVITIES = ("cuda_runtime", "cuda_driver")
# runtime calls that block the host until the device (or a copy) is done
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")

Path = Tuple[str, ...]  # span names, innermost first


@dataclass
class ProgramTrace:
    """``ops``: device operations ``(name, start_ns, end_ns, path)`` that
    start in the window; ``calls``: runtime calls ``(name, start_ns,
    end_ns, path)`` that start in it; ``spans``: host spans ``(name,
    start_ns, end_ns, thread)``, the program's and the harness's, that start
    in it. A path is the names of the spans around the launch, innermost
    first (rule 1, then rule 2); ``()`` is an operation under no span."""

    ops: List[Tuple[str, int, int, Path]] = field(default_factory=list)
    calls: List[Tuple[str, int, int, Path]] = field(default_factory=list)
    spans: List[Tuple[str, int, int, int]] = field(default_factory=list)
    lo: int = 0
    hi: int = 0

    def innermost(self, path: Path) -> Optional[str]:
        """The innermost program span of a path (None under none)."""
        return next((n for n in path if n.startswith(PROGRAM)), None)

    def spans_named(self, name: str) -> List[Tuple[str, int, int, int]]:
        return [s for s in self.spans if s[0] == name]

    def by_span(self, n: int = 16) -> List[Tuple[str, str, float]]:
        """Device seconds by innermost program span (``-`` for none) and
        kind of operation, largest first."""
        total = Counter()
        for name, a, b, path in self.ops:
            total[(self.innermost(path) or "-", kind_of(name))] += b - a
        return [(span, kind, ns / 1e9) for (span, kind), ns in total.most_common(n)]

    def op_ns_under(self, names: Sequence[str]) -> int:
        """Summed device time of the operations launched under any of
        ``names`` (at any depth)."""
        want = set(names)
        return sum(b - a for _, a, b, path in self.ops if want.intersection(path))

    def ops_under(self, name: str) -> int:
        return sum(1 for op in self.ops if name in op[3])

    def calls_under(self, name: str, calls: Sequence[str]) -> int:
        want = set(calls)
        return sum(1 for c in self.calls if c[0] in want and name in c[3])

    def coverage(self, also: Sequence[str] = ()) -> Optional[float]:
        """Share of the window's device-op time launched under a program
        span (or under one of the spans ``also``)."""
        total = sum(b - a for _, a, b, _ in self.ops)
        if not total:
            return None
        extra = set(also)
        covered = sum(b - a for _, a, b, path in self.ops
                      if any(n.startswith(PROGRAM) or n in extra for n in path))
        return covered / total


def _device(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


def _activity(e) -> Optional[str]:
    return e.activity_type() if hasattr(e, "activity_type") else None


def _annotation(e) -> bool:
    act = _activity(e)
    if act is not None:
        return act in ("user_annotation", "gpu_user_annotation")
    return bool(e.is_user_annotation())


def _runtime(e) -> bool:
    """A CUDA runtime or driver call (host side)."""
    act = _activity(e)
    if act is not None:
        return act in RUNTIME_ACTIVITIES
    return not _device(e) and not _annotation(e) and e.name().startswith("cu")


class _Timeline:
    """Per thread, the spans open at each instant: boundaries and the path
    (innermost first) that holds from each boundary to the next."""

    def __init__(self, spans: Iterable[Tuple[str, int, int, int]]):
        by_thread = defaultdict(list)
        for name, a, b, tid in spans:
            if b > a:
                by_thread[tid].append((name, a, b))
        self._bounds: Dict[int, List[int]] = {}
        self._paths: Dict[int, List[Path]] = {}
        for tid, ss in by_thread.items():
            # at one instant, ends before starts, and the longer span opens first
            marks = sorted([(a, 1, -b, i) for i, (_, a, b) in enumerate(ss)] +
                           [(b, 0, 0, i) for i, (_, _, b) in enumerate(ss)])
            stack: List[int] = []
            bounds, paths = [], []
            for t, opening, _, i in marks:
                if opening:
                    stack.append(i)
                else:
                    stack.remove(i)
                path = tuple(ss[j][0] for j in reversed(stack))
                if bounds and bounds[-1] == t:
                    paths[-1] = path
                else:
                    bounds.append(t)
                    paths.append(path)
            self._bounds[tid], self._paths[tid] = bounds, paths

    def at(self, tid: int, t: int) -> Path:
        bounds = self._bounds.get(tid)
        if not bounds:
            return ()
        i = bisect.bisect_right(bounds, t) - 1
        return self._paths[tid][i] if i >= 0 else ()


def attribute(events: Iterable, lo: int, hi: int) -> ProgramTrace:
    """The window ``[lo, hi)``'s device operations and runtime calls, each
    with the spans it was launched under."""
    spans, runtime, cpu_ops, device_ops = [], {}, {}, []
    fwd = defaultdict(Counter)
    for e in events:
        name = e.name()
        if _device(e):
            act = _activity(e)
            if act is None and e.is_user_annotation():
                continue
            if act is None or act in DEVICE_ACTIVITIES:
                device_ops.append(e)
            continue
        start = e.start_ns()
        end = start + e.duration_ns()
        tid = e.start_thread_id()
        if _annotation(e):
            if name.startswith((PROGRAM, HARNESS)):
                spans.append((name, start, end, tid))
        elif _runtime(e):
            runtime[e.correlation_id()] = (name, start, end, tid)
        else:
            cpu_ops.setdefault(e.correlation_id(), (start, tid))
            if e.fwd_thread_id() and e.fwd_thread_id() != tid:
                fwd[tid][e.fwd_thread_id()] += 1
    entered = {tid: c.most_common(1)[0][0] for tid, c in fwd.items()}
    timeline = _Timeline(spans)

    def path(tid: int, t: int) -> Path:
        own = timeline.at(tid, t)
        other = entered.get(tid)
        return own + timeline.at(other, t) if other is not None else own

    out = ProgramTrace(lo=lo, hi=hi, spans=[s for s in spans if lo <= s[1] < hi])
    for e in device_ops:
        start = e.start_ns()
        if not lo <= start < hi:
            continue
        launch = runtime.get(e.correlation_id())
        if launch is not None:
            at, tid = launch[1], launch[3]
        else:
            at, tid = cpu_ops.get(e.linked_correlation_id(), (None, None))
        out.ops.append((e.name(), start, start + e.duration_ns(), path(tid, at) if at is not None else ()))
    out.calls = [(name, a, b, path(tid, a)) for name, a, b, tid in runtime.values() if lo <= a < hi]
    return out


# --- the per-layer figures ---------------------------------------------------------

TRAIN_PHASES = {
    "train_step.forward_ms": ("mis.train.forward",),
    "train_step.backward_ms": ("mis.train.backward",),
    "train_step.update_ms": ("mis.train.update",),
    "batchnorm.global_ms": ("mis.bn.global_stats", "mis.bn.global_normalize", "mis.bn.global_backward"),
}
UNITS = {**{k: "ms" for k in TRAIN_PHASES}, "serve_request.host_ms": "ms", "serve_request.launches": "ops",
         "serve_request.syncs": "calls", "device.idle_pct.serve.forward": "%", "program_span_coverage": "%"}


def train_figures(pt: ProgramTrace, steps: int) -> Dict[str, float]:
    """Device ms a step under each phase (global BatchNorm's where the run
    has its spans) and the share of device-op time under a program span;
    nothing from a program without the step's spans."""
    if not steps or not pt.spans_named("mis.train.step"):
        return {}
    out = {k: pt.op_ns_under(names) / 1e6 / steps for k, names in TRAIN_PHASES.items()
           if k != "batchnorm.global_ms" or pt.spans_named(names[0])}
    cov = pt.coverage()
    if cov is not None:
        out["program_span_coverage"] = 100.0 * cov
    return out


def serve_figures(pt: ProgramTrace) -> Dict[str, float]:
    """Per served request: host ms, device operations launched, blocking
    runtime calls; the window's share in which the device idles while the
    forward's span is open; coverage with the harness's copies."""
    requests = pt.spans_named("mis.serve.request")
    if not requests or pt.hi <= pt.lo:
        return {}
    n = len(requests)
    fwd = pt.spans_named("mis.serve.forward")
    ops_s = np.array([o[1] for o in pt.ops], np.int64)
    ops_e = np.array([o[2] for o in pt.ops], np.int64)
    idle = exposed_ns([np.clip(s[1], pt.lo, pt.hi) for s in fwd], [np.clip(s[2], pt.lo, pt.hi) for s in fwd],
                      ops_s, ops_e)
    out = {
        "serve_request.host_ms": float(np.mean([b - a for _, a, b, _ in requests])) / 1e6,
        "serve_request.launches": pt.ops_under("mis.serve.request") / n,
        "serve_request.syncs": pt.calls_under("mis.serve.request", SYNC_CALLS) / n,
        "device.idle_pct.serve.forward": 100.0 * idle / (pt.hi - pt.lo),
    }
    cov = pt.coverage(also=(HARNESS + "copy_in", HARNESS + "copy_out"))
    if cov is not None:
        out["program_span_coverage"] = 100.0 * cov
    return out


def counter_per_step(run, name: str) -> Optional[float]:
    """The program's counter ``name`` (``core/profiling.py::counters``, which
    counts only while a profiler records: in a traced run, the window) over
    the window's steps, on this rank. None for an untraced run or a program
    without the counter."""
    if run.trace is None or not run.steps:
        return None
    from medical_image_segmentation_tpu_torch.core import profiling

    read = getattr(profiling, "counters", None)
    n = read().get(name) if read is not None else None
    return n / run.steps if n else None
