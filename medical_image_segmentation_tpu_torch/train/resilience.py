"""SIGTERM/SIGINT → checkpoint and a clean exit, agreed across ranks.

Port of ``train/resilience.py:23-71``. A signal only sets a flag. The
trainer asks ``stop_agreed`` after each step and at each epoch's end; when
it says so, the trainer writes a checkpoint and returns 0, so a scheduler
can requeue the job (``--resume``).

With several ranks the stop must be agreed: a rank that stopped alone
would leave its peers waiting in the next step's all-reduce. Every rank
enters the agreement at the same points whatever its own flag says: every
``MIS_STOP_SYNC_EVERY`` steps (default 20) and at each epoch's end, where
one all-reduce of the flags tells all ranks whether any got the signal.
All of them then stop after the same step. One process stops after the
step the signal came in.
"""

from __future__ import annotations

import os
import signal
import sys

import torch
import torch.distributed as dist

from medical_image_segmentation_tpu_torch.parallel.mesh import all_reduce_


class PreemptionGuard:
    """Installs the SIGTERM/SIGINT handlers on ``__enter__`` and puts the
    previous ones back on ``__exit__``. ``mesh`` spans the ranks that must
    agree (None or one rank: this process alone)."""

    _SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self, mesh=None, sync_every=None):
        self._stop = False
        self._previous = {}
        self.mesh = mesh if mesh is not None and mesh.world_size > 1 else None
        self.sync_every = sync_every if sync_every is not None else int(os.environ.get("MIS_STOP_SYNC_EVERY", "20"))

    def _request_stop(self, signum, frame):
        self._stop = True
        print(f"signal {signum}: will checkpoint and exit after this step", file=sys.stderr)

    @property
    def stop_requested(self) -> bool:
        """This rank's own flag (not the agreement: for logging)."""
        return self._stop

    def stop_agreed(self, step_idx: int = -1, at_epoch_end: bool = False) -> bool:
        """True when any rank got a signal, asked at the lockstep points:
        after step ``step_idx`` of an epoch where it closes a sync
        interval, and at an epoch's end. One process reads its flag."""
        if self.mesh is None:
            return self._stop
        if not at_epoch_end and step_idx % self.sync_every != self.sync_every - 1:
            return False
        flag = torch.tensor([float(self._stop)], device=self.mesh.device)
        return bool(all_reduce_(flag, dist.group.WORLD).item() > 0)

    def __enter__(self) -> "PreemptionGuard":
        for sig in self._SIGNALS:
            self._previous[sig] = signal.signal(sig, self._request_stop)
        return self

    def __exit__(self, *exc) -> None:
        for sig, handler in self._previous.items():
            signal.signal(sig, handler)
        self._previous.clear()
