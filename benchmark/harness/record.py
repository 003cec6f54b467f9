"""What a run measured, for the metric readers, and the measured window."""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch

_T0 = time.time()


@dataclass
class Run:
    """One run of one cell, as the metric readers see it.

    ``window_s`` is the host clock over the measured window, which starts
    after a synchronize and ends in one; ``steps`` and ``samples`` are the
    work finished in it over every chip; ``latencies_s`` are the requests'
    (serving). ``flops_per_step`` is counted from the configuration's
    shapes, ``kernel_bytes_per_launch`` from the shapes and the window's
    augmentation draws; ``peaks`` are the card's published (FLOP/s,
    bytes/s). ``trace`` is the device trace of a traced run (rank 0's card)
    and ``busy_s`` the device's busy seconds averaged over the chips."""

    cell: object
    chips: int
    kind: str = ""
    setup_s: float = 0.0
    window_s: float = 0.0
    steps: int = 0
    samples: int = 0
    requests: int = 0
    latencies_s: List[float] = field(default_factory=list)
    flops_per_step: Optional[float] = None
    kernel_bytes_per_launch: Optional[float] = None
    peaks: Optional[tuple] = None
    trace: Optional[object] = None
    busy_s: Optional[float] = None
    memory_peak_bytes: Optional[int] = None


def log(msg: str) -> None:
    """A progress line on standard error, with the seconds since the
    process started."""
    import sys

    if os.environ.get("RANK", "0") != "0":  # one voice for a run over several ranks
        return
    t0 = float(os.environ.get("MIS_BENCHMARK_T0", _T0))
    print(f"benchmark: {time.time() - t0:8.2f} s {msg}", file=sys.stderr, flush=True)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Stopper:
    """When the window ends. One process: once the host clock passes its
    end. Several ranks: every ``every`` steps rank 0's verdict is broadcast
    into a pinned host slot without waiting, and each rank acts on the
    verdict of the boundary before, which has long arrived: every rank
    stops after the same step, with no host synchronisation a step."""

    def __init__(self, seconds: float, device, group=None, every: int = 4):
        import torch.distributed as dist

        self.end = time.perf_counter() + seconds
        self.device, self.group, self.every = torch.device(device), group, every
        self.rank = dist.get_rank() if group is not None else 0
        self._pending = None
        pin = group is not None and self.device.type == "cuda"
        self._slots = [torch.zeros(1, pin_memory=pin) for _ in range(2)] if group is not None else []
        self._k = 0

    def __call__(self, steps_done: int) -> bool:
        if self.group is None:
            return time.perf_counter() >= self.end
        if steps_done % self.every:
            return False
        import torch.distributed as dist

        stop = False
        if self._pending is not None:
            slot, event = self._pending
            if event is not None:
                event.synchronize()
            stop = bool(slot[0] > 0)
        flag = torch.full((1,), float(self.rank == 0 and time.perf_counter() >= self.end), device=self.device)
        dist.broadcast(flag, src=0, group=self.group)
        slot = self._slots[self._k % 2]
        self._k += 1
        slot.copy_(flag, non_blocking=self.device.type == "cuda")
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        self._pending = (slot, event)
        return stop
