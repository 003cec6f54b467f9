"""The segmentation training cells (``unet_r18.train``, ``nnunet3d_liver.train``):
found by name, their counts against hand counts, their driver at a tiny
size on the CPU (sound, then under each planted fault), the readers of
their per-layer metrics on synthetic traces."""

import json
import os
from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import program_trace, seg_counts, seg_faults, spec
from benchmark.harness.program_trace import ProgramTrace
from benchmark.reference import nnunet3d

from _seg_tiny import run_tiny

CELLS = ("unet_r18.train", "nnunet3d_liver.train")
NEW_METRICS = ("instance_norm.fwd_roofline", "seg_step.loss_ms", "train_step.forward_ms", "train_step.backward_ms",
               "norm.instance_values_per_step")


def _config(name):
    with open(os.path.join(spec.BENCH_DIR, "configs", f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("cell", CELLS)
def test_the_cells_resolve_by_name(cell):
    c = spec.find_cell(cell)
    assert c.chips == 1 and c.traffic["driver"] == "seg_train" and c.traffic["limits"]
    assert {m["name"] for m in c.end_to_end} == {"train_samples_per_s", "setup_s"}
    names = {m["name"] for m in c.per_layer}
    assert {"train_step.mfu", "device.idle_pct.train", "seg_step.loss_ms", "train_step.forward_ms",
            "train_step.backward_ms"} <= names
    assert ({"instance_norm.fwd_roofline", "norm.instance_values_per_step"} <= names) == (cell.startswith("nnunet"))
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.load_module("metrics", m["name"]).read)


def test_the_configuration_holds_the_published_widths():
    cfg = _config("nnunet3d_liver")
    entry = next(c for c in spec.load_spec()["configs"] if c["name"] == "nnunet3d_liver")
    assert entry["reduced"] == [] and len(entry["source"]) <= 200
    assert cfg["features"] == [32, 64, 128, 256, 320, 320] and cfg["strides"] == [1, 2, 2, 2, 2, 2]
    assert (cfg["kernel_size"], cfg["n_conv_per_stage"], cfg["n_conv_per_stage_decoder"]) == (3, 2, 2)
    assert cfg["patch"] == [128, 128, 128] and cfg["batch_per_chip"] == 2 and cfg["classes"] == 3
    assert {"patch", "batch_per_chip", "target_downsampling", "batch_dice", "volumes"} <= set(cfg["assumed"])
    assert cfg["deep_supervision_weights"] == pytest.approx(nnunet3d.ds_weights(5))


def test_the_layout_is_the_programs_state_dict():
    from medical_image_segmentation_tpu_torch.models.plain_unet3d import PlainConvUNet3D

    cfg = _config("nnunet3d_liver")
    with torch.device("meta"):
        model = PlainConvUNet3D(cfg["in_channels"], cfg["classes"], cfg["features"])
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == nnunet3d.layout(cfg)
    assert sum(torch.Size(s).numel() for s in nnunet3d.layout(cfg).values()) == 31_196_399


def _hand_conv(cin, cout, k, voxels):
    return 2 * cin * cout * k ** 3 * voxels


def test_flops_against_a_hand_count():
    cfg = _config("nnunet3d_liver")
    f, n = cfg["features"], 128
    total = 0
    cin = 1
    for i, c in enumerate(f):  # the encoder: the first conv at the stage's output size
        vox = (n // 2 ** i) ** 3
        total += _hand_conv(cin, c, 3, vox) + _hand_conv(c, c, 3, vox)
        cin = c
    for i in range(len(f) - 2, -1, -1):  # the decoder: transposed conv, double conv, head
        vox = (n // 2 ** i) ** 3
        total += 2 * cin * f[i] * 8 * (vox // 8)  # each of the vox / 8 input voxels writes 2³ outputs
        total += _hand_conv(2 * f[i], f[i], 3, vox) + _hand_conv(f[i], f[i], 3, vox) + _hand_conv(f[i], 3, 1, vox)
        cin = f[i]
    assert seg_counts.nnunet_forward_flops(cfg, 1) == pytest.approx(total, rel=1e-9)
    assert 954e9 < total < 956e9
    assert seg_counts.nnunet_train_flops(cfg, 2) == pytest.approx(6 * total)
    unet = _config("unet_r18")
    assert seg_counts.unet_train_flops(unet, 1) == pytest.approx(3 * 8.108e9, rel=1e-3)


def test_instance_norm_values_and_bytes():
    cfg = _config("nnunet3d_liver")
    assert seg_counts.instance_norm_values(cfg, 1) == 357_212_160
    assert seg_counts.instance_norm_values(cfg, 2) == 714_424_320
    assert seg_counts.instance_norm_fwd_bytes(cfg, 2) == 4 * 714_424_320  # bf16 in and out


CASES = [(c, None) for c in CELLS] + [(c, f) for c in CELLS for f in ("unchanged", "half_batch", "leaf_unmoved",
                                                                       "altered")]
CASES += [("nnunet3d_liver.train", "ds_dropped")]


@pytest.mark.parametrize("cell, fault", CASES)
def test_the_driver_is_sound_and_catches_each_fault(cell, fault):
    if fault is None:
        result = run_tiny(cell)
        assert result["correct"], result["checks"]
        assert result["attempted"] >= 1 and result["metrics"]["train_samples_per_s"]["value"] > 0
        return
    with seg_faults.fault(fault):
        result = run_tiny(cell)
    assert not result["correct"], result["checks"]


def test_a_traced_tiny_run_reads_the_counter_and_the_spans():
    result = run_tiny("nnunet3d_liver.train", trace=1)
    m = result["metrics"]
    assert m["norm.instance_values_per_step"]["value"] == seg_counts.instance_norm_values(
        {"features": [4, 8, 16, 16], "patch": [16, 16, 16]}, 2)
    for name in ("seg_step.loss_ms", "train_step.forward_ms", "train_step.backward_ms", "device.idle_pct.train"):
        assert name in m  # no device operation on the CPU: each reads 0 ms / 100% idle


def _ev(kind, name, start, dur, corr=0, tid=1):
    device = kind in ("kernel",)
    act = {"kernel": "kernel", "span": "user_annotation", "runtime": "cuda_runtime"}[kind]
    return SimpleNamespace(
        name=lambda: name, device_type=lambda: "DeviceType.CUDA" if device else "DeviceType.CPU",
        activity_type=lambda: act, start_ns=lambda: start, duration_ns=lambda: dur, correlation_id=lambda: corr,
        linked_correlation_id=lambda: 0, start_thread_id=lambda: tid, fwd_thread_id=lambda: 0,
        is_user_annotation=lambda: kind == "span")


def _synthetic():
    """A step: the forward (one norm and the loss inside), the backward."""
    events = [
        _ev("span", "mis.train.step", 0, 100), _ev("span", "mis.train.forward", 1, 50),
        _ev("span", "mis.norm.instance", 2, 10), _ev("span", "mis.seg.loss", 30, 10),
        _ev("span", "mis.train.backward", 60, 30),
        _ev("runtime", "cudaLaunchKernel", 3, 1, corr=1), _ev("kernel", "norm_kernel", 5, 8, corr=1),
        _ev("runtime", "cudaLaunchKernel", 31, 1, corr=2), _ev("kernel", "loss_kernel", 40, 4, corr=2),
        _ev("runtime", "cudaLaunchKernel", 61, 1, corr=3), _ev("kernel", "conv_dgrad", 70, 20, corr=3),
    ]
    return program_trace.attribute(events, 0, 100)


def _run(pt, **kw):
    base = dict(program=pt, steps=2, kind="train", peaks=(989.4e12, 3.35e12), trace=None, norm_bytes_per_step=3.35e3)
    return SimpleNamespace(**{**base, **kw})


def test_the_new_readers_on_a_synthetic_trace():
    pt = _synthetic()
    read = {n: spec.load_module("metrics", n).read for n in NEW_METRICS}
    run = _run(pt)
    assert read["seg_step.loss_ms"](run) == pytest.approx(4 / 1e6 / 2)
    assert read["train_step.forward_ms"](run) == pytest.approx(12 / 1e6 / 2)
    assert read["train_step.backward_ms"](run) == pytest.approx(20 / 1e6 / 2)
    # 3.35 kB at 3.35 TB/s is 1 ns; the norm's kernels take 8 ns over 2 steps: 4 ns a step
    assert read["instance_norm.fwd_roofline"](run) == pytest.approx(25.0)


def test_the_new_readers_read_nothing_without_the_programs_spans():
    read = {n: spec.load_module("metrics", n).read for n in NEW_METRICS}
    empty = ProgramTrace(lo=0, hi=100)
    for n, r in read.items():
        assert r(_run(None)) is None, n
        if n != "norm.instance_values_per_step":
            assert r(_run(empty)) is None, n
    assert read["instance_norm.fwd_roofline"](_run(_synthetic(), norm_bytes_per_step=None)) is None


@pytest.mark.parametrize("metric", ["norm.instance_values_per_step"])
def test_the_counter_reader_reads_nothing_from_a_program_without_counters(monkeypatch, metric):
    from medical_image_segmentation_tpu_torch.core import profiling

    monkeypatch.delattr(profiling, "counters")
    assert spec.load_module("metrics", metric).read(_run(None, trace=object())) is None
