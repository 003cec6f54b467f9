"""One process on every local device: the port's counterpart of the JAX
package's single-process mesh for inference (``make_mesh()`` plus
``shard_batch``, ``train/predict.py:189-209``, and ``mesh=`` in
``eval/sliding_window.py:84-91``), where XLA runs each batch sharded over
every local chip.

- ``local_devices`` lists the devices a ``--device`` name means on this
  host: every visible card for ``cuda``, one card for ``cuda:N``, the CPU
  for ``cpu``.
- ``Replicas`` holds eval-mode copies of a module, one a device, and runs a
  batch split into contiguous row chunks, one chunk a device. The launches
  are asynchronous, so the cards compute at the same time while Python
  walks the list; the results come back to the first device in row order.

Nothing falls back: a device list that names a card where there is none
raises. A list may name one device twice (two replicas on one card): that
runs every line of the split and gather where only one card exists.
"""

from __future__ import annotations

import copy
from typing import Callable, List, Optional, Sequence

import torch
from torch import nn


def local_devices(device="cuda") -> List[torch.device]:
    """Every visible card for a bare ``cuda``, that card for ``cuda:N``,
    the device itself otherwise (``[cpu]``). Raises where a card is named
    and there is none."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return [dev]
    if not torch.cuda.is_available():
        raise SystemExit(f"--device {device}: CUDA is not available (pass --device cpu explicitly)")
    if dev.index is not None:
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Replicas:
    """Eval-mode copies of ``module`` on ``devices``; ``replicas(x)`` runs
    ``forward(copy, rows)`` on each device's contiguous rows of ``x`` (the
    first device takes the first rows; ``torch.tensor_split`` sizes, so a
    batch that does not divide leaves the last chunks one row shorter) and
    returns the results concatenated on the first device. ``forward``
    defaults to calling the copy."""

    def __init__(self, module: nn.Module, devices: Sequence, forward: Optional[Callable] = None):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("Replicas needs at least one device")
        if any(d.type == "cuda" for d in self.devices) and not torch.cuda.is_available():
            raise RuntimeError(f"devices {[str(d) for d in self.devices]} name a card, but CUDA is not available")
        self.modules = [copy.deepcopy(module).to(d).eval() for d in self.devices]
        self.forward = forward if forward is not None else (lambda m, x: m(x))

    def __len__(self) -> int:
        return len(self.devices)

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        chunks = torch.tensor_split(x, len(self.devices))
        outs = [self.forward(m, _to(c, d)) for m, d, c in zip(self.modules, self.devices, chunks) if len(c)]
        return torch.cat([_to(o, self.devices[0]) for o in outs])


def _to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``t`` on ``device``; a copy onto a card does not wait for the host."""
    return t.to(device, non_blocking=device.type == "cuda")
