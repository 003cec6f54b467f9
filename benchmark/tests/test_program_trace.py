"""The program spans' attribution and the figures that read it, on
synthetic kineto-like events; the counters' readers on synthetic runs; and
the trace's existing readers unmoved by ``mis.*`` spans."""

from types import SimpleNamespace

import pytest

from benchmark.harness import program_trace, spec
from benchmark.harness.program_trace import ProgramTrace, attribute
from benchmark.harness.trace import Trace

ACTS = {"span": "user_annotation", "op": "cpu_op", "call": "cuda_runtime", "kernel": "kernel",
        "memcpy": "gpu_memcpy", "dev_span": "gpu_user_annotation"}


def ev(kind, name, start, dur, tid=1, corr=0, link=0, fwd=0, flavour="activity"):
    """A kineto event as torch 2.13 gives it (``activity_type``) or as 2.11
    does (no ``activity_type``: told apart by device, annotation and name)."""
    dev = "CUDA" if kind in ("kernel", "memcpy", "dev_span") else "CPU"
    e = SimpleNamespace(name=lambda: name, device_type=lambda: f"DeviceType.{dev}", start_ns=lambda: start,
                        duration_ns=lambda: dur, start_thread_id=lambda: tid, correlation_id=lambda: corr,
                        linked_correlation_id=lambda: link, fwd_thread_id=lambda: fwd,
                        is_user_annotation=lambda: kind in ("span", "dev_span"))
    if flavour == "activity":
        e.activity_type = lambda: ACTS[kind]
    return e


def step_events(flavour):
    """One training step: spans on the main thread (1); a launch on it under
    ``mis.train.forward``; autograd's thread (2) launching one kernel under
    its own ``mis.bn.global_backward`` and one under none of its own; a
    kernel with no runtime call found, put down through its CPU op; a copy
    under no span; a kernel before the window."""
    e = lambda *a, **k: ev(*a, flavour=flavour, **k)  # noqa: E731
    return [
        e("span", "harness.window", 0, 1000),
        e("span", "mis.train.step", 100, 800),
        e("span", "mis.train.forward", 110, 200),
        e("span", "mis.bn.global_stats", 150, 50),
        e("call", "cudaLaunchKernel", 120, 5, corr=501),
        e("kernel", "gemm_fwd", 130, 40, corr=501),
        e("call", "cudaLaunchKernel", 160, 5, corr=502),
        e("kernel", "reduce_kernel", 180, 30, corr=502),
        e("span", "mis.train.backward", 320, 300),
        e("op", "autograd::engine::evaluate_function: X", 330, 200, tid=2, corr=40, fwd=1),
        e("span", "mis.bn.global_backward", 340, 60, tid=2),
        e("call", "cudaLaunchKernel", 350, 5, tid=2, corr=503),
        e("kernel", "bn_backward_elementwise", 360, 100, corr=503, tid=2),
        e("call", "cuLaunchKernel", 450, 5, tid=2, corr=504),
        e("kernel", "wgrad", 470, 80, corr=504, tid=2),
        e("op", "aten::add_", 700, 20, corr=41),
        e("kernel", "vectorized_elementwise_kernel", 710, 10, corr=999, link=41),
        e("call", "cudaMemcpyAsync", 950, 5, corr=505),
        e("memcpy", "Memcpy DtoH (Device -> Pageable)", 960, 20, corr=505),
        e("call", "cudaStreamSynchronize", 956, 30, corr=506),
        e("kernel", "before_window", -50, 10, corr=507),
        e("call", "cudaLaunchKernel", -60, 5, corr=507),
        e("dev_span", "mis.train.step", 130, 400),
    ]


@pytest.fixture(params=["activity", "no_activity"])
def step(request):
    return attribute(step_events(request.param), 0, 1000)


def _path(pt, name):
    (op,) = [o for o in pt.ops if o[0] == name]
    return op[3]


@pytest.mark.parametrize("op, innermost, path", [
    # a launch on the span's own thread, nested spans: the innermost first
    ("gemm_fwd", "mis.train.forward", ("mis.train.forward", "mis.train.step", "harness.window")),
    ("reduce_kernel", "mis.bn.global_stats",
     ("mis.bn.global_stats", "mis.train.forward", "mis.train.step", "harness.window")),
    # autograd's worker thread: its own span, then the spans of the thread that entered backward
    ("bn_backward_elementwise", "mis.bn.global_backward",
     ("mis.bn.global_backward", "mis.train.backward", "mis.train.step", "harness.window")),
    ("wgrad", "mis.train.backward", ("mis.train.backward", "mis.train.step", "harness.window")),
    # no runtime call with its id: the CPU op it is linked to
    ("vectorized_elementwise_kernel", "mis.train.step", ("mis.train.step", "harness.window")),
    # under no program span
    ("Memcpy DtoH (Device -> Pageable)", None, ("harness.window",)),
])
def test_each_operation_is_put_down_to_the_spans_around_its_launch(step, op, innermost, path):
    assert _path(step, op) == path
    assert step.innermost(_path(step, op)) == innermost


def test_the_window_keeps_its_own_operations_and_device_annotations_are_no_operations(step):
    assert sorted(o[0] for o in step.ops) == sorted([
        "gemm_fwd", "reduce_kernel", "bn_backward_elementwise", "wgrad", "vectorized_elementwise_kernel",
        "Memcpy DtoH (Device -> Pageable)"])
    assert {c[0] for c in step.calls} == {"cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync",
                                          "cudaStreamSynchronize"}


def test_an_operation_under_no_span_at_all():
    pt = attribute([ev("call", "cudaLaunchKernel", 10, 5, corr=1), ev("kernel", "k", 20, 5, corr=1)], 0, 100)
    assert pt.ops == [("k", 20, 25, ())] and pt.coverage() == 0.0


def test_train_figures(step):
    f = program_trace.train_figures(step, steps=2)
    assert f["train_step.forward_ms"] == pytest.approx((40 + 30) / 1e6 / 2)
    assert f["train_step.backward_ms"] == pytest.approx((100 + 80) / 1e6 / 2)
    assert f["train_step.update_ms"] == 0.0
    # global BatchNorm's three spans, the backward's on autograd's thread included
    assert f["batchnorm.global_ms"] == pytest.approx((30 + 100) / 1e6 / 2)
    assert f["program_span_coverage"] == pytest.approx(100.0 * 260 / 280)


def test_train_figures_leave_out_what_has_no_span():
    no_bn = [e for e in step_events("activity") if "bn." not in e.name()]
    assert "batchnorm.global_ms" not in program_trace.train_figures(attribute(no_bn, 0, 1000), 1)
    parent = [e for e in step_events("activity") if not e.name().startswith("mis.")]
    assert program_trace.train_figures(attribute(parent, 0, 1000), 1) == {}


def serve_events(flavour):
    """Two requests; each: a blocking copy under ``normalize``, two kernels
    under ``forward``, one under ``post_process``; the harness's copies
    outside the request."""
    out = [ev("span", "harness.window", 0, 2000, flavour=flavour)]
    for r, t0 in enumerate((0, 1000)):
        c = 100 * (r + 1)
        out += [ev(k, n, t0 + s, d, corr=c + i if k in ("call", "kernel", "memcpy") else 0, flavour=flavour)
                for k, n, s, d, i in [
                    ("span", "harness.copy_in", 10, 40, 0),
                    ("call", "cudaMemcpyAsync", 20, 5, 1), ("memcpy", "Memcpy HtoD", 30, 10, 1),
                    ("span", "mis.serve.request", 100, 600, 0),
                    ("span", "mis.serve.normalize", 110, 100, 0),
                    ("call", "cudaMemcpyAsync", 120, 5, 2), ("memcpy", "Memcpy HtoD", 126, 2, 2),
                    ("call", "cudaStreamSynchronize", 130, 20, 3),
                    ("span", "mis.serve.forward", 300, 300, 0),
                    ("call", "cudaLaunchKernel", 310, 5, 4), ("kernel", "conv", 320, 100, 4),
                    ("call", "cudaLaunchKernel", 330, 5, 5), ("kernel", "relu", 420, 20, 5),
                    ("span", "mis.serve.post_process", 600, 90, 0),
                    ("call", "cudaLaunchKernel", 610, 5, 6), ("kernel", "threshold", 620, 10, 6),
                    ("span", "harness.copy_out", 700, 200, 0),
                    ("call", "cudaMemcpyAsync", 710, 5, 7), ("memcpy", "Memcpy DtoH", 720, 30, 7),
                ]]
    return out


@pytest.mark.parametrize("flavour", ["activity", "no_activity"])
def test_serve_figures(flavour):
    f = program_trace.serve_figures(attribute(serve_events(flavour), 0, 2000))
    assert f["serve_request.host_ms"] == pytest.approx(600 / 1e6)
    assert f["serve_request.launches"] == 4  # a copy and three kernels a request
    assert f["serve_request.syncs"] == 1
    # the forward's span [300, 600): the device busy over [320, 440) of it
    assert f["device.idle_pct.serve.forward"] == pytest.approx(100.0 * 2 * (300 - 120) / 2000)
    assert f["program_span_coverage"] == 100.0
    assert program_trace.serve_figures(attribute(
        [e for e in serve_events(flavour) if not e.name().startswith("mis.")], 0, 2000)) == {}


def _run(**kw):
    base = dict(trace=Trace(lo=0, hi=10), chips=4, steps=5, kind="train")
    return SimpleNamespace(**{**base, **kw})


@pytest.mark.parametrize("metric, counters, run, value", [
    ("comm.calls_per_step", {"comm.calls": 340, "comm.bytes": 10}, {}, 68.0),
    ("comm.bytes_per_step", {"comm.calls": 340, "comm.bytes": 330_160_280}, {}, 66.032056),
    ("comm.calls_per_step", {"comm.calls": 340}, {"trace": None}, None),  # untraced
    ("comm.calls_per_step", {"comm.calls": 340}, {"chips": 1}, None),
    ("comm.bytes_per_step", {}, {}, None),  # nothing counted
])
def test_counter_readers(monkeypatch, metric, counters, run, value):
    from medical_image_segmentation_tpu_torch.core import profiling

    monkeypatch.setattr(profiling, "counters", lambda: dict(counters))
    got = spec.load_module("metrics", metric).read(_run(**run))
    assert got == (pytest.approx(value) if value is not None else None)


@pytest.mark.parametrize("metric", ["comm.calls_per_step", "comm.bytes_per_step"])
def test_counter_readers_read_nothing_from_a_program_without_counters(monkeypatch, metric):
    from medical_image_segmentation_tpu_torch.core import profiling

    monkeypatch.delattr(profiling, "counters")
    assert spec.load_module("metrics", metric).read(_run()) is None


def _with_program_spans(events):
    """The same events with the program's spans (host and device) added."""
    return events + [ev("span", "mis.train.step", 5, 80), ev("span", "mis.train.forward", 6, 30),
                     ev("dev_span", "mis.train.step", 10, 60), ev("span", "mis.serve.request", 90, 5, tid=2)]


@pytest.mark.parametrize("flavour", ["activity", "no_activity"])
@pytest.mark.parametrize("kind", ["train", "serve"])
def test_existing_readers_and_breakdown_are_unmoved_by_program_spans(flavour, kind):
    base = [ev("span", "harness.window", 0, 100, flavour=flavour),
            ev("span", "harness.train_step", 5, 85, flavour=flavour),
            ev("kernel", "ncclDevKernel_AllReduce", 10, 20, corr=1, flavour=flavour),
            ev("kernel", "sm90_xmma_fprop", 25, 30, corr=2, flavour=flavour),
            ev("kernel", "two_view_augment_kernel", 60, 5, corr=3, flavour=flavour),
            ev("memcpy", "Memcpy DtoH", 80, 4, corr=4, flavour=flavour)]
    spanned = _with_program_spans(base)
    plain, traced = Trace.from_events(base, 0, 100), Trace.from_events(spanned, 0, 100)
    assert (traced.ops, traced.spans) == (plain.ops, plain.spans)
    assert traced.kinds() == plain.kinds() and traced.idle_gaps() == plain.idle_gaps()
    cell = spec.find_cell("byol_r18.ddp4" if kind == "train" else "unet_r18.serve")

    def read(t):
        run = SimpleNamespace(trace=t, chips=cell.chips, steps=3, samples=3, kind=kind, busy_s=t.busy_ns() / 1e9,
                              window_s=1.0, peaks=(989.4e12, 3.35e12), flops_per_step=1e12,
                              kernel_bytes_per_launch=1e6, latencies_s=[0.01], requests=3, setup_s=1.0)
        return {m["name"]: spec.load_module("metrics", m["name"]).read(run) for m in cell.per_layer
                if not m["source"].startswith("program_")}

    assert read(traced) == read(plain)


def test_the_new_entries_keep_to_the_contract():
    entries = {m["name"]: m for m in spec.load_spec()["per_layer"]}
    for name in ("comm.calls_per_step", "comm.bytes_per_step"):
        m = entries[name]
        assert (m["source"], m["layer"], m["moves"], m["workloads"]) == (
            "program_counter", "collectives", "train_samples_per_s", ["byol_r18.ddp4"])
    assert [m["name"] for m in spec.load_spec()["per_layer"]][-2:] == ["comm.calls_per_step", "comm.bytes_per_step"]


def test_an_empty_program_trace_reads_nothing():
    pt = ProgramTrace(lo=0, hi=100)
    assert pt.coverage() is None and program_trace.serve_figures(pt) == {}
    assert program_trace.train_figures(pt, 3) == {}


def test_device_time_by_innermost_span_and_kind(step):
    assert step.by_span() == [("mis.bn.global_backward", "elementwise", 100e-9), ("mis.train.backward", "conv", 80e-9),
                              ("mis.train.forward", "conv", 40e-9), ("mis.bn.global_stats", "reduce", 30e-9),
                              ("-", "elementwise", 20e-9), ("mis.train.step", "elementwise", 10e-9)]
