"""The port's own profiler spans and counters (``core/profiling.py``).

- With no profiler recording, ``span`` is one shared no-op context, no
  ``mis.*`` range is opened and no counter moves.
- Under ``torch.profiler`` on the CPU, a BYOL step is a ``mis.train.step``
  range holding its five phases in order, a served request a
  ``mis.serve.request`` range holding its three, and the augmentation call
  a ``mis.augment`` range.
- In two gloo ranks, global BatchNorm's ranges lie in the step's forward
  and backward, and one step's ``comm.calls`` and ``comm.bytes`` are the
  figures the parameter shapes and the BatchNorm widths give.

Imports no JAX: the spawned ranks start fast.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import _torch_dist as td
from medical_image_segmentation_tpu_torch.core import profiling
from medical_image_segmentation_tpu_torch.models.batchnorm import BatchNorm
from medical_image_segmentation_tpu_torch.ops.augment import ViewConfig
from medical_image_segmentation_tpu_torch.ops.fused_augment import fused_two_view_augment
from medical_image_segmentation_tpu_torch.serve import make_predict_fn
from medical_image_segmentation_tpu_torch.train.byol_task import BYOLTask
from medical_image_segmentation_tpu_torch.train.segmentation_task import SegmentationTask

BYOL_KW = dict(arch="resnet18", in_channels=1, hidden_dim=32, proj_dim=16, num_classes=5, learning_rate=0.1,
               warmup_epochs=0, max_epochs=2, total_steps=2, steps_per_epoch=1, dtype=torch.float32, device="cpu")
STEP_PHASES = ["train.forward", "train.backward", "train.grad_exchange", "train.update", "train.metrics"]
REQUEST_PHASES = ["serve.normalize", "serve.forward", "serve.post_process"]
BATCH, SIZE = 4, 32


def _views(seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(BATCH, SIZE, SIZE, 1, generator=g), torch.randn(BATCH, SIZE, SIZE, 1, generator=g))


def _byol_step():
    task = BYOLTask(**BYOL_KW)
    task.init(0)
    return lambda: task.train_step(*_views())


def _predict():
    torch.manual_seed(0)
    fn = make_predict_fn(SegmentationTask(dtype=torch.float32, device="cpu"), (0.2,), (0.3,))
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 64, 64, 1), dtype=np.uint8))
    return lambda: fn(x)


def _augment():
    cfg = ViewConfig(out_size=(16, 16))
    imgs = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (BATCH, SIZE, SIZE), dtype=np.uint8))
    return lambda: fused_two_view_augment(imgs, cfg, cfg, generator=torch.Generator().manual_seed(1))


CALLS = {"train_step": _byol_step, "predict": _predict, "augment": _augment}


def _ranges(prof):
    """``(name, start_ns, end_ns, thread)`` of every ``mis.*`` range, in
    order of start."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith(profiling.SPAN_PREFIX) and not str(e.device_type()).endswith("CUDA")]
    return sorted(out, key=lambda r: (r[1], -r[2]))


def _inside(r, outer) -> bool:
    return outer[1] <= r[1] and r[2] <= outer[2]


@pytest.mark.parametrize("call", sorted(CALLS))
def test_without_a_profiler_nothing_is_opened_or_counted(call, monkeypatch):
    fn = CALLS[call]()
    profiling.reset_counters()
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: opened.append(name))
    fn()
    profiling.count("comm.calls", 3)
    assert opened == [] and profiling.counters() == {}
    assert all(profiling.span(n) is profiling._NO_SPAN for n in ("train.step", "serve.request", "x"))


def test_counters_count_only_under_a_profiler_and_reset():
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("comm.calls")
        profiling.count("comm.bytes", 12)
        profiling.count("comm.bytes", 4)
    profiling.count("comm.calls")
    got = profiling.counters()
    assert got == {"comm.calls": 1, "comm.bytes": 16}
    got["comm.calls"] = 99  # a copy
    assert profiling.counters()["comm.calls"] == 1
    profiling.reset_counters()
    assert profiling.counters() == {}


@pytest.mark.parametrize("call, parent, children", [
    ("train_step", "train.step", STEP_PHASES),
    ("predict", "serve.request", REQUEST_PHASES),
    ("augment", "augment", []),
])
def test_a_profiled_call_opens_its_span_and_children_in_order(call, parent, children):
    fn = CALLS[call]()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    ranges = _ranges(prof)
    (top,) = [r for r in ranges if r[0] == "mis." + parent]
    inner = [r for r in ranges if r is not top and _inside(r, top) and r[3] == top[3]]
    direct = [r for r in inner if not any(o is not r and _inside(r, o) for o in inner)]
    assert [r[0] for r in direct] == ["mis." + c for c in children]
    # no BatchNorm range on one process: a CPU tensor keeps F.batch_norm, which has none
    assert not [r for r in ranges if r[0].startswith("mis.bn.")]


def _two_rank_step():
    from medical_image_segmentation_tpu_torch.parallel.mesh import make_mesh
    from medical_image_segmentation_tpu_torch.parallel.tp import shard_dim

    mesh = make_mesh(("data",), device="cpu")
    task = BYOLTask(mesh=mesh, **BYOL_KW)
    task.init(0)
    v1, v2 = _views(1 + mesh.rank)
    task.train_step(v1, v2)  # a first step outside the profiler
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        task.train_step(v1, v2)
    widths = {name: [m.weight.numel() for m in net.modules() if isinstance(m, BatchNorm)]
              for name, net in (("online", task.online), ("target", task.target))}
    grads = [(shard_dim(n) is None, p.numel()) for n, p in task.online.named_parameters()
             if not n.startswith("probe.")]
    return {"ranges": _ranges(prof), "counters": profiling.counters(), "widths": widths, "grads": grads,
            "with_grad": sum(p.numel() for p in task.online.parameters() if p.grad is not None)}


@pytest.fixture(scope="module")
def two_ranks():
    return td.launch(_two_rank_step, 2)


def test_global_batchnorm_spans_lie_in_the_forward_and_the_backward(two_ranks):
    for rank in two_ranks:
        ranges, widths = rank["ranges"], rank["widths"]
        (fwd,) = [r for r in ranges if r[0] == "mis.train.forward"]
        (bwd,) = [r for r in ranges if r[0] == "mis.train.backward"]
        n_fwd = len(widths["online"]) + len(widths["target"])
        for name, phase, n in (("mis.bn.global_stats", fwd, n_fwd), ("mis.bn.global_normalize", fwd, n_fwd),
                               ("mis.bn.global_backward", bwd, len(widths["online"]))):
            got = [r for r in ranges if r[0] == name]
            assert len(got) == n and all(_inside(r, phase) for r in got), name


@pytest.mark.parametrize("counter", ["comm.calls", "comm.bytes"])
def test_one_step_s_collectives_are_the_shapes_figure(two_ranks, counter):
    for rank in two_ranks:
        online, target = rank["widths"]["online"], rank["widths"]["target"]
        grads = sum(n for _, n in rank["grads"])
        assert rank["with_grad"] == grads  # the probe alone has no gradient
        expected = {
            # BatchNorm: (Σx, Σx², n) in every forward; (Σdy, Σdy·x̂) in the online backward; one
            # bucket of f32 gradients for the replicated and one for the shardable (head) parameters;
            # the step's three metrics
            "comm.calls": len(target) + 2 * len(online) + len({r for r, _ in rank["grads"]}) + 1,
            "comm.bytes": 4 * (sum(2 * c + 1 for c in target + online) + sum(2 * c for c in online) + grads + 3),
        }
        assert rank["counters"][counter] == expected[counter]


@pytest.mark.parametrize("prefetch", [0, 1, 2])
def test_the_loader_queue_times_the_consumer_s_wait(prefetch):
    import time

    from medical_image_segmentation_tpu_torch.core.profiling import StageTimers
    from medical_image_segmentation_tpu_torch.data.loader import prefetch_iter

    def slow_items():
        for i in range(3):
            time.sleep(0.02)
            yield i

    timers = StageTimers()
    assert list(prefetch_iter(slow_items, prefetch, timers=timers)) == [0, 1, 2]
    stages = timers.snapshot()
    if prefetch == 0:  # no queue: the consumer runs the producer itself
        assert stages == {}
    else:  # one blocking get an item and one for the end
        total, n = stages["wait"]
        assert n == 4 and total >= 0.02
