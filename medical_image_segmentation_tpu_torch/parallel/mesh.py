"""Process layout, process groups and the collectives of multi-process
training. Port of ``parallel/mesh.py:29-145``.

The JAX package trains one model over many chips by sharding the batch on a
``data`` mesh axis: XLA then makes BatchNorm statistics and Dice sums
global and all-reduces the gradients. Here every rank is a process of its
own, so the same training is spelled out:

- ``initialize_distributed`` reads the launcher's environment (torchrun's
  ``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``MASTER_ADDR``/``MASTER_PORT``, or
  SLURM's ``SLURM_PROCID``/``SLURM_NTASKS``/``SLURM_LOCALID`` with the
  job's ``MASTER_ADDR``/``MASTER_PORT``), picks the rank's device and the
  backend by rule, joins the group and prints one ``process r/n`` line.
  No such environment means one process and no group.
- ``make_mesh`` lays the ranks out row-major on named axes (``("data",)``,
  ``("data", "model")`` or ``("data", "space")``) and makes one process
  group per axis, on the joined process's device unless told another.
- ``replicate`` broadcasts the first data rank's tensors, so every replica
  starts from the same weights (``replicated`` there).
- ``data_rows`` gives a rank its rows of a global batch (``shard_batch``
  there), ``depth_slab`` its depth range of a volume split over the
  ``space`` axis (``spatial_sharding`` there; the halo exchange that
  GSPMD inserts is ``parallel/spatial.py``).
- The collectives are ``all_reduce`` and ``broadcast`` only: those are what
  the gloo backend carries on CUDA tensors, and gloo is the backend when
  ranks share a card. ``gather_rows`` is therefore an all-reduce of a
  zero-filled buffer that holds each rank's rows in place, and
  ``all_reduce_sum`` is a differentiable all-reduce written as an autograd
  function (its backward all-reduces the gradient).
- Every collective issued here adds to the profiler counters ``comm.calls``
  and ``comm.bytes`` (this rank's buffer: numel × element size) while a
  profiler records (``core/profiling.py::count``).

Backend rule: ``nccl`` when every rank of a host has a card of its own;
``gloo`` when ranks share a card (NCCL refuses two ranks on one device) or
run on the CPU. A group that fails to form raises; no other backend is
tried.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import re
import sys
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from medical_image_segmentation_tpu_torch.core.profiling import count


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where a process sits in a launch: its rank among ``world_size``, its
    rank among the ``local_world_size`` processes of its host, and the
    rendezvous address."""

    rank: int
    world_size: int
    local_rank: int
    local_world_size: int
    master_addr: str
    master_port: int
    launcher: str


def _slurm_tasks_per_node(env: Mapping[str, str], world: int) -> int:
    """Tasks on this node: ``SLURM_NTASKS_PER_NODE``, else the first count
    of ``SLURM_TASKS_PER_NODE`` (``"4(x2),3"`` → 4), else all of them."""
    if env.get("SLURM_NTASKS_PER_NODE"):
        return int(env["SLURM_NTASKS_PER_NODE"])
    m = re.match(r"(\d+)", env.get("SLURM_TASKS_PER_NODE", ""))
    return int(m[1]) if m else world


def _rendezvous(env: Mapping[str, str], launcher: str) -> Tuple[str, int]:
    addr, port = env.get("MASTER_ADDR"), env.get("MASTER_PORT")
    if not addr or not port:
        raise SystemExit(f"{launcher} launch: MASTER_ADDR and MASTER_PORT must name rank 0's host and a free port")
    return addr, int(port)


def layout_from_env(env: Optional[Mapping[str, str]] = None) -> Optional[Layout]:
    """The launch layout that ``env`` names, or None for a plain process.

    torchrun's variables (``RANK`` and ``WORLD_SIZE``) name a group even at
    ``WORLD_SIZE=1``; SLURM's name one when the job has more than one task
    (``SLURM_NTASKS > 1``), as ``jax.distributed`` reads them."""
    env = os.environ if env is None else env
    if "RANK" in env and "WORLD_SIZE" in env:
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        local = int(env.get("LOCAL_RANK", rank))
        local_world = int(env.get("LOCAL_WORLD_SIZE", world))
        launcher = "torchrun"
    elif int(env.get("SLURM_NTASKS", "1")) > 1 and "SLURM_PROCID" in env:
        rank, world = int(env["SLURM_PROCID"]), int(env["SLURM_NTASKS"])
        local = int(env.get("SLURM_LOCALID", "0"))
        local_world = _slurm_tasks_per_node(env, world)
        launcher = "slurm"
    else:
        return None
    if not 0 <= rank < world or not 0 <= local < local_world:
        raise SystemExit(f"{launcher} launch: rank {rank} of {world} (local {local} of {local_world}) is out of range")
    addr, port = _rendezvous(env, launcher)
    return Layout(rank, world, local, local_world, addr, port, launcher)


def choose_backend(device: torch.device, local_world_size: int, device_count: int) -> str:
    """``nccl`` when each of the host's ranks has a card of its own,
    ``gloo`` when ranks share one or run on the CPU."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if local_world_size <= device_count else "gloo"


@dataclasses.dataclass(frozen=True)
class Process:
    """This process's place in the run: rank, world size, device, backend
    (None without a group) and how many ranks share its card."""

    rank: int
    world_size: int
    device: torch.device
    backend: Optional[str]
    ranks_per_device: int = 1

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def rank_device(name: str, layout: Optional[Layout]) -> torch.device:
    """``name`` as a device; a bare ``cuda`` becomes the card
    ``LOCAL_RANK % device_count`` of the rank. Raises without a card."""
    device = torch.device(name)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: CUDA is not available (pass --device cpu explicitly)")
    if device.index is None:
        device = torch.device("cuda", (layout.local_rank if layout else 0) % torch.cuda.device_count())
    return device


_joined: Optional[Process] = None  # what initialize_distributed joined, for make_mesh's default device


def initialize_distributed(device: str = "cuda", env: Optional[Mapping[str, str]] = None,
                           timeout: Optional[datetime.timedelta] = None) -> Process:
    """Join the launch's process group (once per process) and return this
    process's place in it. Without a launch environment, one process and
    no group. Must run before anything else touches the card."""
    global _joined
    layout = layout_from_env(env)
    dev = rank_device(device, layout)
    if layout is None:
        return Process(0, 1, dev, None)
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 1
    sharing = math.ceil(layout.local_world_size / n_cards) if dev.type == "cuda" else 1
    if dist.is_initialized():
        if (dist.get_rank(), dist.get_world_size()) != (layout.rank, layout.world_size):
            raise RuntimeError(f"a process group of rank {dist.get_rank()}/{dist.get_world_size()} is already "
                               f"initialized; the environment names {layout.rank}/{layout.world_size}")
        _joined = Process(layout.rank, layout.world_size, dev, dist.get_backend(), sharing)
        return _joined
    backend = choose_backend(dev, layout.local_world_size, n_cards)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {"timeout": timeout} if timeout is not None else {}
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method=f"tcp://{layout.master_addr}:{layout.master_port}",
                            rank=layout.rank, world_size=layout.world_size, **kw)
    print(f"process {layout.rank}/{layout.world_size}: local {layout.local_rank}/{layout.local_world_size} "
          f"({layout.launcher}), device {dev}, backend {backend}"
          + (f", {sharing} ranks share the card" if sharing > 1 else ""), file=sys.stderr)
    _joined = Process(layout.rank, layout.world_size, dev, backend, sharing)
    return _joined


def shutdown_distributed() -> None:
    """Leave the process group, if this process joined one."""
    global _joined
    _joined = None
    if dist.is_initialized():
        dist.destroy_process_group()


def default_device() -> torch.device:
    """The device of the joined process (``initialize_distributed``'s
    ``Process``), or the launch's card by ``rank_device`` without a group."""
    if dist.is_initialized() and _joined is not None:
        return _joined.device
    return rank_device("cuda", layout_from_env())


class Mesh:
    """The ranks on named axes, row-major (the last axis varies fastest, so
    a ``model`` group is consecutive ranks, as ``make_mesh`` reshapes the
    JAX device list), with one process group per axis once a process group
    exists. An axis of one rank still has its group: a one-rank run under a
    launcher sends every collective through the backend (with NCCL, on the
    card), where a plain process has no group and calls none."""

    def __init__(self, axis_names: Sequence[str], axis_sizes: Sequence[int], rank: int,
                 groups: Mapping[str, object], device: torch.device):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in axis_sizes)))
        self.rank = rank
        self.device = device
        self._groups = dict(groups)
        self.coords: Dict[str, int] = {}
        rest = rank
        for name in reversed(self.axis_names):
            self.coords[name] = rest % self.shape[name]
            rest //= self.shape[name]

    @property
    def world_size(self) -> int:
        return math.prod(self.shape.values())

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        """The process group along ``axis`` that holds this rank (``"all"``:
        every rank of the mesh); None in a plain process (no process group)
        or for an axis the mesh lacks."""
        return self._groups.get(axis)

    def shard(self, axis: str = "data") -> Tuple[int, int]:
        """``(index, size)`` along ``axis``: the ``shard`` of this rank's
        loaders and augmentation draws."""
        return self.index(axis), self.size(axis)

    def ranks(self, axis: str) -> List[int]:
        """Global ranks of this rank's group along ``axis``, in axis order
        (``"all"``: every rank)."""
        if axis == "all":
            return list(range(self.world_size))
        return _axis_ranks(self.axis_names, tuple(self.shape.values()), self.coords, axis)


def _axis_ranks(names, sizes, coords: Mapping[str, int], axis: str) -> List[int]:
    if axis not in names:
        return [_flat_rank(names, sizes, coords)]
    return [_flat_rank(names, sizes, {**coords, axis: i}) for i in range(sizes[names.index(axis)])]


def _flat_rank(names, sizes, coords: Mapping[str, int]) -> int:
    r = 0
    for name, size in zip(names, sizes):
        r = r * size + coords[name]
    return r


def make_mesh(axis_names: Sequence[str] = ("data",), axis_sizes: Optional[Sequence[int]] = None,
              device=None) -> Mesh:
    """A mesh over every rank of the process group (one rank without one).
    Default: all ranks on the first axis; ``device`` None is the joined
    process's device (``default_device``), so a card rank's collectives
    carry card tensors. Every rank must call this with the same arguments:
    each axis group is created on all ranks in one order
    (``dist.new_group`` is collective)."""
    device = default_device() if device is None else device
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    names = tuple(axis_names)
    sizes = tuple(axis_sizes) if axis_sizes is not None else (world,) + (1,) * (len(names) - 1)
    if math.prod(sizes) != world:
        raise ValueError(f"axis_sizes {sizes} != world size {world}")
    groups = {}
    if not dist.is_initialized():
        return Mesh(names, sizes, rank, groups, torch.device(device))
    groups["all"] = dist.group.WORLD
    for axis, size in zip(names, sizes):
        if size == world:
            groups[axis] = dist.group.WORLD
            continue
        others = [n for n in names if n != axis]
        for combo in _product([sizes[names.index(n)] for n in others]):
            members = _axis_ranks(names, sizes, {**dict(zip(others, combo)), axis: 0}, axis)
            g = dist.new_group(members)
            if rank in members:
                groups[axis] = g
    return Mesh(names, sizes, rank, groups, torch.device(device))


def _product(sizes: Sequence[int]) -> Iterable[Tuple[int, ...]]:
    if not sizes:
        yield ()
        return
    for i in range(sizes[0]):
        for rest in _product(sizes[1:]):
            yield (i,) + rest


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def data_rows(mesh: Optional[Mesh], batch: int) -> slice:
    """This rank's rows of a global batch of ``batch`` rows split over the
    ``data`` axis."""
    n = mesh.size("data") if mesh else 1
    if batch % n:
        raise ValueError(f"global batch {batch} does not divide the {n} data ranks")
    per = batch // n
    i = mesh.index("data") if mesh else 0
    return slice(i * per, (i + 1) * per)


def depth_slab(mesh: Optional[Mesh], depth: int) -> slice:
    """This rank's contiguous range of a depth of ``depth`` split over the
    ``space`` axis, in ``space``-index order (the whole depth without a
    ``space`` axis)."""
    n = mesh.size("space") if mesh else 1
    if depth % n:
        raise ValueError(f"depth {depth} does not divide the {n} space ranks")
    per = depth // n
    i = mesh.index("space") if mesh else 0
    return slice(i * per, (i + 1) * per)


# --- collectives --------------------------------------------------------------


def _counted(tensor: torch.Tensor) -> torch.Tensor:
    """``tensor``, counted as one collective's buffer."""
    count("comm.calls")
    count("comm.bytes", tensor.numel() * tensor.element_size())
    return tensor


def all_reduce_(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """In-place sum over ``group``; nothing to do without a group."""
    if group is not None:
        dist.all_reduce(_counted(tensor), group=group)
    return tensor


def _coalesced(tensors: Sequence[torch.Tensor], op) -> None:
    """Apply the in-place collective ``op`` to one flat buffer per dtype and
    device of ``tensors`` and copy the results back."""
    buckets: Dict[Tuple[torch.dtype, torch.device], List[torch.Tensor]] = {}
    for t in tensors:
        buckets.setdefault((t.dtype, t.device), []).append(t)
    for ts in buckets.values():
        flat = _flatten_dense_tensors(ts)
        op(flat)
        for t, v in zip(ts, _unflatten_dense_tensors(flat, ts)):
            t.copy_(v)


def all_reduce_mean_grads(params: Iterable[torch.nn.Parameter], group) -> None:
    """Average the gradients of ``params`` over ``group``: one bucketed
    all-reduce, then a division by the group's size. Parameters without a
    gradient are left alone (the same ones on every rank)."""
    if group is None:
        return
    n = group_size(group)

    def mean_(flat: torch.Tensor) -> None:
        dist.all_reduce(_counted(flat), group=group)
        flat.div_(n)

    grads = [p.grad for p in params if p.grad is not None]
    if grads:
        _coalesced(grads, mean_)


def replicate(tensors: Iterable[torch.Tensor], mesh: Optional[Mesh], axis: str = "data") -> None:
    """Broadcast the tensors of the first rank along ``axis`` to the other
    ranks of its group (the JAX package's ``replicated`` placement)."""
    if mesh is None or mesh.group(axis) is None:
        return
    src, group = mesh.ranks(axis)[0], mesh.group(axis)
    _coalesced([t.data if isinstance(t, torch.nn.Parameter) else t for t in tensors],
               lambda flat: dist.broadcast(_counted(flat), src=src, group=group))


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every rank: a broadcast of one flag from rank 0 (a collective
    that gloo carries on a card's tensors too)."""
    if mesh is None or not dist.is_initialized():
        return
    dist.broadcast(_counted(torch.zeros(1, device=mesh.device)), src=0)


def global_mean(values: torch.Tensor, group) -> torch.Tensor:
    """The mean over ``group`` of each rank's ``values`` (equal shards), as
    a new tensor; ``values`` itself without a group."""
    if group is None:
        return values
    return all_reduce_(values.detach().clone(), group) / group_size(group)


def gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """The rows of every rank of ``group``, in rank order: an all-reduce of
    a zero-filled buffer in which each rank wrote its rows at its offset.
    Ranks may hold different row counts."""
    if group is None:
        return t
    n = group_size(group)
    me = dist.get_rank(group)
    counts = torch.zeros(n, dtype=torch.int64, device=t.device)
    counts[me] = t.shape[0]
    all_reduce_(counts, group)
    counts = counts.tolist()
    start = sum(counts[:me])
    buf = torch.zeros((sum(counts), *t.shape[1:]), dtype=t.dtype, device=t.device)
    buf[start:start + t.shape[0]] = t
    return all_reduce_(buf, group)


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group whose backward sums the gradient over it too: each
    rank's share feeds every rank's copy of the result."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_(t.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``t`` over ``group`` (``t`` itself without a
    group)."""
    if group is None:
        return t
    return _AllReduceSum.apply(t, group)
