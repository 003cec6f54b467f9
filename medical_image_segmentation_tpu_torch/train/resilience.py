"""SIGTERM/SIGINT → checkpoint and a clean exit, for one process.

Port of ``train/resilience.py:23-71`` without the multi-host agreement (the
port trains on one card). The JAX module cannot be imported here: its
package's ``__init__`` imports JAX. A signal only sets a flag; the trainer
reads ``stop_requested`` after each step and at each epoch's end, writes a
checkpoint and returns 0, so a scheduler can requeue the job.
"""

from __future__ import annotations

import signal
import sys


class PreemptionGuard:
    """Installs the SIGTERM/SIGINT handlers on ``__enter__`` and puts the
    previous ones back on ``__exit__``."""

    _SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self):
        self._stop = False
        self._previous = {}

    def _request_stop(self, signum, frame):
        self._stop = True
        print(f"signal {signum}: will checkpoint and exit after this step", file=sys.stderr)

    @property
    def stop_requested(self) -> bool:
        return self._stop

    def __enter__(self) -> "PreemptionGuard":
        for sig in self._SIGNALS:
            self._previous[sig] = signal.signal(sig, self._request_stop)
        return self

    def __exit__(self, *exc) -> None:
        for sig, handler in self._previous.items():
            signal.signal(sig, handler)
        self._previous.clear()
