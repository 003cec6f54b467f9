"""The device trace of a traced window, and the arithmetic over it.

``capture`` runs ``torch.profiler`` (CPU and CUDA activity) around the
window; ``Trace.from_profile`` keeps the device operations (kernels,
copies, fills) as intervals and the harness's own host spans
(``torch.profiler.record_function`` names that start with ``harness.``).
Everything else is arithmetic over intervals, testable without a card:

- ``union_ns``: the time covered by at least one interval (the device's
  busy time, where several streams may overlap);
- ``exposed_ns``: the time covered by one set of intervals and by none of
  another (collective kernels that no compute kernel hides);
- ``gaps``: the stretches of a window that no interval covers, longest
  first, each named by the innermost host span open at its start;
- ``KINDS`` / ``kind_of``: the kind table of ``chip_smoke.py::device_breakdown``
  (convolutions and matrix products, reductions, elementwise and copies),
  with the collectives, the hand-written augmentation kernel and the
  BatchNorm kernels (cuDNN's would count as convolutions there) apart.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Iterable, List, Sequence, Tuple

import numpy as np

SPAN_PREFIX = "harness."
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
KINDS = (
    ("nccl", ("nccl",)),
    ("two_view_augment", ("two_view_augment",)),
    ("norm", ("batch_norm", "bn_fw", "bn_bw", "batchnorm", "welford")),
    ("conv", ("conv", "gemm", "cudnn", "cutlass", "xmma", "wgrad", "dgrad", "nchwtonhwc", "nhwctonchw")),
    ("reduce", ("reduce", "var_mean")),
    ("elementwise", ("elementwise", "vectorized", "copy", "cat", "index", "gather", "fill", "memcpy", "memset")),
)


def kind_of(name: str) -> str:
    low = name.lower()
    return next((k for k, words in KINDS if any(w in low for w in words)), "other")


def _merge(starts: np.ndarray, ends: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Disjoint sorted intervals covering the same points."""
    if len(starts) == 0:
        return starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(len(s), dtype=bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    return s[idx], np.maximum.reduceat(e, idx)


def _clip(starts, ends, lo, hi):
    s, e = np.clip(starts, lo, hi), np.clip(ends, lo, hi)
    keep = e > s
    return s[keep], e[keep]


def union_ns(starts: Sequence[int], ends: Sequence[int], lo: int = None, hi: int = None) -> int:
    s, e = np.asarray(starts, np.int64), np.asarray(ends, np.int64)
    if lo is not None:
        s, e = _clip(s, e, lo, hi)
    s, e = _merge(s, e)
    return int((e - s).sum())


def exposed_ns(starts, ends, other_starts, other_ends) -> int:
    """Length of the points in the first intervals that lie in none of the others."""
    s, e = _merge(np.asarray(starts, np.int64), np.asarray(ends, np.int64))
    os_, oe = _merge(np.asarray(other_starts, np.int64), np.asarray(other_ends, np.int64))
    total = 0
    for a, b in zip(s.tolist(), e.tolist()):
        lo_i, hi_i = np.searchsorted(oe, a, "right"), np.searchsorted(os_, b, "left")
        covered = int((np.minimum(oe[lo_i:hi_i], b) - np.maximum(os_[lo_i:hi_i], a)).clip(min=0).sum())
        total += (b - a) - covered
    return total


def gaps(starts, ends, lo: int, hi: int) -> List[Tuple[int, int]]:
    """The uncovered stretches of [lo, hi), longest first."""
    s, e = _merge(*_clip(np.asarray(starts, np.int64), np.asarray(ends, np.int64), lo, hi))
    bounds_s = np.concatenate([[lo], e])
    bounds_e = np.concatenate([s, [hi]])
    keep = bounds_e > bounds_s
    out = list(zip(bounds_s[keep].tolist(), bounds_e[keep].tolist()))
    return sorted(out, key=lambda g: g[0] - g[1])


def span_at(spans: Sequence[Tuple[str, int, int]], t: int) -> str:
    """The innermost (latest-starting) host span open at ``t``."""
    best, best_start = "host", None
    for name, a, b in spans:
        if a <= t < b and (best_start is None or a > best_start):
            best, best_start = name, a
    return best


@dataclass
class Trace:
    """Device operations ``(name, start_ns, end_ns)`` and the harness's host
    spans over the traced window ``[lo, hi)`` (ns, the profiler's clock)."""

    ops: List[Tuple[str, int, int]] = field(default_factory=list)
    spans: List[Tuple[str, int, int]] = field(default_factory=list)
    lo: int = 0
    hi: int = 0

    def arrays(self, select=None):
        sel = [o for o in self.ops if select is None or select(o[0])]
        return (np.array([o[1] for o in sel], np.int64), np.array([o[2] for o in sel], np.int64))

    def busy_ns(self) -> int:
        return union_ns(*self.arrays(), self.lo, self.hi)

    def time_by(self, select) -> Tuple[int, int]:
        """Summed duration and count of the operations ``select`` takes."""
        s, e = self.arrays(select)
        return int((e - s).sum()), len(s)

    def kinds(self) -> List[Tuple[str, float]]:
        total = {}
        for name, a, b in self.ops:
            k = kind_of(name)
            total[k] = total.get(k, 0) + (b - a)
        return sorted(((k, v / 1e9) for k, v in total.items()), key=lambda kv: -kv[1])

    def idle_gaps(self, n: int = 10) -> List[Tuple[str, float]]:
        spans = [s for s in self.spans if s[0].startswith(SPAN_PREFIX)]
        return [(span_at(spans, a)[len(SPAN_PREFIX):] if span_at(spans, a) != "host" else "host", (b - a) / 1e9)
                for a, b in gaps(*self.arrays(), self.lo, self.hi)[:n]]

    @classmethod
    def from_events(cls, events: Iterable, lo: int, hi: int) -> "Trace":
        """From kineto events (``name()``, ``device_type()``,
        ``activity_type()``, ``start_ns()``, ``duration_ns()``)."""
        ops, spans = [], []
        for e in events:
            name = e.name()
            start = e.start_ns()
            end = start + e.duration_ns()
            device = str(e.device_type()).endswith("CUDA")
            act = e.activity_type() if hasattr(e, "activity_type") else None
            if device:
                if act is None and e.is_user_annotation():
                    continue
                if act is None or act in DEVICE_ACTIVITIES:
                    ops.append((name, start, end))
            elif name.startswith(SPAN_PREFIX):
                spans.append((name, start, end))
        return cls(ops, spans, lo, hi)


class capture:
    """``with capture(enabled) as cap: ...``: the profiler over the block;
    ``cap.trace`` after it (None when not enabled). The window's bounds are
    the first and last instants the profiler saw of the harness's
    ``harness.window`` span."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.trace = None
        self._prof = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is None:
            return False
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        events = self._prof.profiler.kineto_results.events()
        window = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
                  if e.name() == SPAN_PREFIX + "window" and not str(e.device_type()).endswith("CUDA")]
        lo, hi = window[0] if window else (0, 0)
        self.trace = Trace.from_events(events, lo, hi)
        return False


def span(enabled: bool, name: str):
    """A host span the trace keeps (a no-op when not tracing)."""
    if not enabled:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(SPAN_PREFIX + name)


def idle_pct(run):
    """The idle share of a traced run's window (the device's busy seconds,
    averaged over the chips, against the window), or None untraced."""
    if run.trace is None or run.busy_s is None or run.trace.hi <= run.trace.lo:
        return None
    return 100.0 * (1.0 - run.busy_s / ((run.trace.hi - run.trace.lo) / 1e9))
