"""Pre-flight device-memory guard. Port of ``core/hbm.py:61-199`` for CUDA.

The JAX guard reads XLA's static memory plan of the compiled step. PyTorch
has no such plan: it allocates as it goes and fails mid-step. So the guard
runs the step once as a probe, at the run's batch shape, before training,
and reads ``torch.cuda.max_memory_allocated``. A probe that runs out of
memory, or whose peak exceeds the card's memory, refuses the run with the
levers a user can turn (a smaller ``--batch_size``, ``--remat``, a wider
``--space_shards``), unless
``--force_hbm`` turns the refusal into a warning.

The probe must not be a hidden training step: ``preserved`` puts back the
task's weights, BatchNorm buffers, optimizer state and step count and the
augmentation generator's state exactly as they were. On the CPU there is no
capacity, and the guard does nothing. Ranks that share a card each probe
their own batch against their share of it (``rank_hbm_capacity``).
"""

from __future__ import annotations

import contextlib
import sys
from typing import Any, Callable, Dict, Iterator, Optional

import torch


def device_hbm_capacity(device="cuda") -> Optional[int]:
    """The card's memory in bytes (``torch.cuda.mem_get_info``), or None
    for a device that is not a CUDA card."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return int(torch.cuda.mem_get_info(device)[1])


def rank_hbm_capacity(device="cuda", ranks_per_device: int = 1) -> Optional[int]:
    """The card's memory one rank may fill: all of it, or its share when
    ``ranks_per_device`` ranks share the card; None off the card."""
    capacity = device_hbm_capacity(device)
    return capacity // ranks_per_device if capacity is not None else None


def probe_peak(probe: Callable[[], Any], device="cuda") -> Optional[int]:
    """Peak bytes allocated on ``device`` while ``probe()`` runs, or None
    when it ran out of memory."""
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    try:
        probe()
        torch.cuda.synchronize(device)
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        return None
    return int(torch.cuda.max_memory_allocated(device))


def _cpu_copy(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return type(obj)((k, _cpu_copy(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu_copy(v) for v in obj)
    return obj


@contextlib.contextmanager
def preserved(task, generator: Optional[torch.Generator] = None) -> Iterator[None]:
    """Run the block, then put ``task`` (its ``state_dict``: weights,
    buffers, optimizer state, step) and ``generator`` back as they were,
    and drop the gradients the block left."""
    saved = _cpu_copy(task.state_dict())
    gen_state = generator.get_state() if generator is not None else None
    try:
        yield
    finally:
        task.load_state_dict(saved)
        task.optimizer.zero_grad(set_to_none=True)
        if generator is not None:
            generator.set_state(gen_state)


def format_hbm_report(mem: Dict[str, Any], label: str = "step") -> str:
    gb = 1024.0 ** 3
    cap = mem.get("capacity")
    peak = mem["projected_peak"]
    peak_s = f"{peak / gb:.2f} GiB" if peak is not None else "out of memory"
    cap_s = f"{cap / gb:.2f} GiB" if cap else "unknown"
    return f"projected device memory for {label}: {peak_s} (peak of one probe step) vs capacity {cap_s}"


def check_hbm(mem: Optional[Dict[str, Any]], label: str = "step", force: bool = False, file=None) -> None:
    """Print the projection; refuse (SystemExit with the diagnosis) if it
    oversubscribes the device, or warn instead when ``force``. A None
    report is accepted (``core/hbm.py:172-199``)."""
    if mem is None:
        return
    file = file or sys.stderr
    print(format_hbm_report(mem, label), file=file)
    if mem.get("oversubscribed"):
        advice = (
            f"{label}: projected peak exceeds device memory — on the card the step "
            "runs out of memory mid-run. Lower --batch_size, enable --remat, or shard "
            "wider (--space_shards); pass --force_hbm to run anyway."
        )
        if force:
            print(f"WARNING (forced): {advice}", file=file)
        else:
            raise SystemExit(f"REFUSING: {advice}")


def guard_step(probe: Callable[[], Any], label: str = "train step", skip: bool = False, force: bool = False,
               device="cuda", capacity: Optional[int] = None) -> Optional[Dict[str, Any]]:
    """Run ``probe`` (one training step at the run's shapes, wrapped in
    ``preserved`` by the caller) and refuse the run if its peak does not
    fit the card (``check_hbm``). A no-op returning None when ``skip`` or
    when the device has no capacity (the CPU); ``capacity`` overrides the
    card's."""
    if skip:
        return None
    if capacity is None:
        capacity = device_hbm_capacity(device)
    if capacity is None:
        return None
    peak = probe_peak(probe, device)
    mem = {"projected_peak": peak, "capacity": capacity,
           "oversubscribed": peak is None or peak > capacity}
    check_hbm(mem, label=label, force=force)
    return mem
