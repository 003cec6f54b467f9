"""The arithmetic over a trace's intervals, on synthetic intervals."""

from types import SimpleNamespace

import pytest

from benchmark.harness import trace
from benchmark.harness.trace import Trace


def test_union_merges_overlaps_and_clips_to_the_window():
    assert trace.union_ns([0, 5, 20], [10, 15, 30]) == 25
    assert trace.union_ns([0, 5, 20], [10, 15, 30], lo=8, hi=25) == 7 + 5
    assert trace.union_ns([], []) == 0


def test_exposed_is_what_no_other_interval_covers():
    # collective [10, 40) under compute [0, 15) and [30, 35): exposed 15..30 and 35..40
    assert trace.exposed_ns([10], [40], [0, 30], [15, 35]) == 15 + 5
    assert trace.exposed_ns([10, 50], [20, 60], [], []) == 20
    assert trace.exposed_ns([10], [20], [0], [100]) == 0


def test_gaps_longest_first_and_named_by_the_open_span():
    t = Trace(ops=[("k1", 10, 20), ("k2", 30, 70), ("k3", 60, 80)],
              spans=[("harness.window", 0, 100), ("harness.wait_batch", 20, 30), ("harness.sync", 80, 100)],
              lo=0, hi=100)
    assert trace.gaps(*t.arrays(), 0, 100) == [(80, 100), (0, 10), (20, 30)]
    assert t.idle_gaps() == [("sync", 20e-9), ("window", 10e-9), ("wait_batch", 10e-9)]
    assert t.busy_ns() == 60


@pytest.mark.parametrize("busy_s, window_ns, idle", [(0.75, 1_000_000_000, 25.0), (1.0, 1_000_000_000, 0.0)])
def test_idle_share(busy_s, window_ns, idle):
    run = SimpleNamespace(trace=Trace(lo=0, hi=window_ns), busy_s=busy_s)
    assert trace.idle_pct(run) == pytest.approx(idle)


def test_idle_share_of_an_untraced_run_is_nothing():
    assert trace.idle_pct(SimpleNamespace(trace=None, busy_s=None)) is None


@pytest.mark.parametrize("name, kind", [
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "nccl"),
    ("two_view_augment_kernel<unsigned char, __nv_bfloat16>", "two_view_augment"),
    ("cudnn::bn_fw_tr_1C11_kernel_NCHW", "norm"),
    ("void at::native::batch_norm_collect_statistics_channels_last_kernel", "norm"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16", "conv"),
    ("void at::native::vectorized_elementwise_kernel<4>", "elementwise"),
    ("Memcpy HtoD (Pageable -> Device)", "elementwise"),
    ("something_else", "other"),
])
def test_kind_table(name, kind):
    assert trace.kind_of(name) == kind


def test_events_keep_device_work_and_harness_spans():
    def ev(name, dev, act, start, dur, ann=False):
        return SimpleNamespace(name=lambda: name, device_type=lambda: f"DeviceType.{dev}",
                               activity_type=lambda: act, start_ns=lambda: start, duration_ns=lambda: dur,
                               is_user_annotation=lambda: ann)

    t = Trace.from_events([ev("harness.window", "CPU", "user_annotation", 0, 100, True),
                           ev("aten::mm", "CPU", "cpu_op", 5, 5),
                           ev("gemm", "CUDA", "kernel", 10, 20),
                           ev("harness.window", "CUDA", "gpu_user_annotation", 0, 100, True),
                           ev("Memset (Device)", "CUDA", "gpu_memset", 40, 2)], 0, 100)
    assert t.ops == [("gemm", 10, 30), ("Memset (Device)", 40, 42)]
    assert t.spans == [("harness.window", 0, 100)]
