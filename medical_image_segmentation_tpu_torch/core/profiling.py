"""Profiling hooks: ``torch.profiler`` traces and per-stage wall timers.

Port of ``core/profiling.py:23-118``. ``StageTimers`` is a copy of the JAX
package's; the ``Loader`` accumulates its "decode" stage there.
``trace_if`` and ``StepProfiler`` record host activity, and the card's
kernels when the device is CUDA, and write a Chrome trace (viewable in
Perfetto or ``chrome://tracing``) where ``jax.profiler`` wrote an XProf
trace.

Usage:
    with trace_if(log_dir, enabled=args.profile, device=device):
        ... training steps ...

    timers = StageTimers()
    with timers.stage("decode"): ...
    print(timers.report())
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


def _start_trace(device) -> "torch.profiler.profile":
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def _stop_trace(prof: "torch.profiler.profile", device, trace_dir: str) -> str:
    """Wait for the device's queued work, stop ``prof`` and write its
    Chrome trace into ``trace_dir``; returns the file's path."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace_if(log_dir: str, enabled: bool = True, *, device):
    """Trace the block into ``<log_dir>/trace.json`` when ``enabled``; the
    file is written however the block ends. ``device`` has no default: a
    caller that left it out would trace the host only and say nothing."""
    if not enabled:
        yield
        return
    prof = _start_trace(device)
    try:
        yield
    finally:
        _stop_trace(prof, device, log_dir)


class StepProfiler:
    """Trace of the first ``n_steps`` steps into ``<log_dir>/trace/trace.json``,
    written from every exit path: after the last traced step, or at
    ``stop()`` for a run shorter than ``n_steps``, one stopped by a signal,
    or one that raised. ``n_steps = 0`` traces nothing."""

    def __init__(self, n_steps: int, log_dir: str, device):
        self.left = n_steps
        self.device = device
        self.trace_dir = os.path.join(log_dir, "trace")
        self.path: Optional[str] = None
        self._prof = None
        if n_steps:
            self._prof = _start_trace(device)
            print(f"profiling {n_steps} steps → {self.trace_dir}", file=sys.stderr)

    def tick(self) -> None:
        """Count one step; stops the trace when the budget is spent."""
        if self._prof is not None:
            self.left -= 1
            if self.left <= 0:
                self.stop()

    def stop(self) -> None:
        if self._prof is not None:
            prof, self._prof = self._prof, None
            self.path = _stop_trace(prof, self.device, self.trace_dir)
            print(f"profiler trace written → {self.path}", file=sys.stderr)


class StageTimers:
    """Accumulating wall-clock timers for input-pipeline stages."""

    def __init__(self):
        # the prefetch thread writes ('decode') while the main thread
        # reads/resets each epoch — all access goes through this lock
        self._lock = threading.Lock()
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.totals[name] += dt
                self.counts[name] += 1

    def snapshot(self) -> Dict[str, tuple]:
        """Consistent {stage: (total_s, count)} view (lock-guarded copy)."""
        with self._lock:
            return {k: (self.totals[k], self.counts[k]) for k in self.totals}

    def report(self, reset: bool = False) -> str:
        with self._lock:
            items = sorted((k, self.totals[k], self.counts[k]) for k in self.totals)
            if reset:
                self.totals = defaultdict(float)
                self.counts = defaultdict(int)
        lines = []
        for name, tot, n in items:
            lines.append(f"{name}: {tot:.3f}s total, {tot/max(n,1)*1e3:.2f} ms/call × {n}")
        return "\n".join(lines)

    def reset(self) -> None:
        """Zero the accumulators — per-epoch reports must not blend epochs."""
        with self._lock:
            self.totals = defaultdict(float)
            self.counts = defaultdict(int)
