"""The Swin UNETR training cell (``swin_unetr_liver.train``): found by name,
its configuration at the published widths, its counts against hand
counts, its driver at a tiny size on the CPU (sound, then under each of
the new planted faults), the readers of its per-layer metrics on synthetic
traces and without their spans."""

import json
import os
from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import program_trace, spec, swin_counts, swin_faults
from benchmark.harness.program_trace import ProgramTrace
from benchmark.reference import swin_unetr

from _swin_tiny import run_tiny, tiny_cell

CELL = "swin_unetr_liver.train"
NEW_METRICS = ("swin.attention_ms", "swin.attention_roofline", "swin.attention_tokens_per_step")


def _config():
    with open(os.path.join(spec.BENCH_DIR, "configs", "swin_unetr_liver.json")) as f:
        return json.load(f)


def test_the_cell_resolves_by_name():
    c = spec.find_cell(CELL)
    assert c.chips == 1 and c.traffic["driver"] == "swin_train" and c.traffic["limits"]
    assert {m["name"] for m in c.end_to_end} == {"train_samples_per_s", "setup_s"}
    assert {"train_step.mfu", "device.idle_pct.train", "seg_step.loss_ms", "train_step.forward_ms",
            "train_step.backward_ms", "instance_norm.fwd_roofline", "norm.instance_values_per_step",
            *NEW_METRICS} == {m["name"] for m in c.per_layer}
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.load_module("metrics", m["name"]).read)


def test_the_configuration_holds_the_published_widths():
    cfg = _config()
    entry = next(c for c in spec.load_spec()["configs"] if c["name"] == "swin_unetr_liver")
    assert entry["reduced"] == [] and len(entry["source"]) <= 200
    assert (cfg["feature_size"], cfg["depths"], cfg["heads"], cfg["window"]) == (48, [2, 2, 2, 2], [3, 6, 12, 24], 7)
    assert cfg["patch"] == [96, 96, 96] and cfg["batch_per_chip"] == 4 and cfg["classes"] == 3
    assert (cfg["optimizer"], cfg["learning_rate"], cfg["weight_decay"]) == ("adamw", 1e-4, 1e-5)
    assert (cfg["warmup_epochs"], cfg["max_epochs"], cfg["steps_per_epoch"], cfg["start_step"]) == (50, 5000, 26, 1300)
    assert swin_unetr.lr_at(cfg, cfg["start_step"]) == pytest.approx(1e-4) and swin_unetr.lr_at(cfg, 0) == 0.0
    assert {"steps_per_epoch", "start_step", "init", "precision", "crops", "augmentation"} <= set(cfg["assumed"])


def test_the_layout_is_the_programs_state_dict():
    from medical_image_segmentation_tpu_torch.models.swin_unetr import SwinUNETR3D

    cfg = _config()
    with torch.device("meta"):
        model = SwinUNETR3D(cfg["in_channels"], cfg["classes"], cfg["feature_size"])
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == swin_unetr.layout(cfg)
    assert sum(torch.Size(s).numel() for k, s in swin_unetr.layout(cfg).items()
               if not k.endswith("relative_position_index")) == 62_186_757


def _hand_forward_flops(cfg, batch):
    """Convolutions, transposed convolutions, linears and the two attention
    products of one forward, counted from the shapes by hand."""
    f, side = cfg["feature_size"], cfg["patch"][0]

    def vox(level):
        return (side // 2 ** level) ** 3

    def conv(cin, cout, k, level):
        return 2 * cin * cout * k ** 3 * vox(level)

    def res(cin, cout, level):
        skip = conv(cin, cout, 1, level) if cin != cout else 0
        return conv(cin, cout, 3, level) + conv(cout, cout, 3, level) + skip

    total = 2 * cfg["in_channels"] * f * 8 * vox(1)  # the patch embedding, a 2³ kernel a token
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["heads"])):
        c, dims = f * 2 ** i, side // 2 ** (i + 1)
        w = min(dims, cfg["window"])
        n, tokens = w ** 3, (-(-dims // w) * w) ** 3
        attn = 2 * tokens * 3 * c * c + 2 * tokens * c * c + 2 * (2 * tokens * n * c)  # qkv, proj, q·kᵀ and ·v
        total += depth * (attn + 2 * dims ** 3 * 8 * c * c)  # the MLP on the real tokens
        total += 2 * (dims // 2) ** 3 * 8 * c * 2 * c  # patch merging's reduction
    total += res(cfg["in_channels"], f, 0) + res(f, f, 1) + res(2 * f, 2 * f, 2) + res(4 * f, 4 * f, 3)
    total += res(16 * f, 16 * f, 5)
    for cin, cout, level in ((16 * f, 8 * f, 4), (8 * f, 4 * f, 3), (4 * f, 2 * f, 2), (2 * f, f, 1), (f, f, 0)):
        total += 2 * cin * cout * 8 * vox(level + 1) + res(2 * cout, cout, level)
    total += conv(f, cfg["classes"], 1, 0)
    return batch * total


def test_flops_and_bytes_against_a_hand_count():
    small = {**_config(), "feature_size": 12, "patch": [32, 32, 32]}
    assert swin_counts.forward_flops(small, 2) == pytest.approx(_hand_forward_flops(small, 2), rel=1e-12)
    assert swin_counts.train_flops(small, 2) == pytest.approx(6 * _hand_forward_flops(small, 1), rel=1e-12)
    # attention at 32³ crops, F = 12: stage 1 21³ tokens in 27 windows of 343 (3 heads), stage 2 14³ in 8
    # (6 heads), stage 3 one 4³ window (12 heads), stage 4 one 2³ window (24 heads); head width 4
    tokens = [(21 ** 3, 343, 3, 27, True), (14 ** 3, 343, 6, 8, True), (64, 64, 12, 1, False),
              (8, 8, 24, 1, False)]
    flops = sum(2 * 2 * t * h * 4 * n * 4 for t, n, h, _, _ in tokens)  # two blocks, two crops
    assert swin_counts.attention_flops(small, 2) == flops
    table = 13 ** 3 * 4
    moved = sum(2 * (4 * 2 * t * h * 4 * 2 + table * h) for t, n, h, _, _ in tokens)  # q, k, v, o in bf16
    assert swin_counts.attention_bytes(small, 2) == moved  # the shift mask is no traffic: it can be computed
    assert [b.name for b in swin_counts.blocks(small) if b.shifted] == \
        ["swinViT.layers1.0.blocks.1", "swinViT.layers2.0.blocks.1"]


def test_the_cells_derived_counts():
    cfg = _config()
    assert swin_counts.attention_tokens(cfg, 4) == 4 * 2 * (49 ** 3 + 28 ** 3 + 14 ** 3 + 6 ** 3) == 1_140_488
    assert swin_counts.attention_pad_tokens(cfg, 4) == 129_608
    f = 48
    per_crop = (3 * f * 96 ** 3 + 2 * f * 48 ** 3 + 2 * 2 * f * 24 ** 3 + 2 * 4 * f * 12 ** 3 + 2 * 16 * f * 3 ** 3
                + 3 * 8 * f * 6 ** 3 + 3 * 4 * f * 12 ** 3 + 3 * 2 * f * 24 ** 3 + 3 * f * 48 ** 3 + 3 * f * 96 ** 3)
    assert swin_counts.instance_norm_values(cfg, 4) == 4 * per_crop == 1_159_723_008
    assert swin_counts.instance_norm_fwd_bytes(cfg, 4) == 4 * 1_159_723_008
    assert swin_counts.train_flops(cfg, 4) == pytest.approx(6 * _hand_forward_flops(cfg, 2), rel=1e-12)


@pytest.mark.parametrize("fault", [None, "unchanged", "no_shift", "no_rel_bias"])
def test_the_driver_is_sound_and_catches_each_new_fault(fault):
    if fault is None:
        result = run_tiny(CELL)
        assert result["correct"], result["checks"]
        assert result["attempted"] >= 1 and result["metrics"]["train_samples_per_s"]["value"] > 0
        return
    with swin_faults.fault(fault):
        result = run_tiny(CELL)
    assert not result["correct"], result["checks"]


def test_a_traced_tiny_run_reads_the_counters_and_the_spans():
    result = run_tiny(CELL, trace=1)
    m = result["metrics"]
    tiny = tiny_cell(CELL).config
    assert m["swin.attention_tokens_per_step"]["value"] == swin_counts.attention_tokens(tiny, 2) == 48_308
    assert m["norm.instance_values_per_step"]["value"] == swin_counts.instance_norm_values(tiny, 2)
    for name in ("swin.attention_ms", "seg_step.loss_ms", "train_step.forward_ms", "train_step.backward_ms",
                 "device.idle_pct.train"):
        assert name in m  # no device operation on the CPU: each reads 0 ms / 100% idle
    assert "swin.attention_roofline" not in m  # no card, no peaks


def _ev(kind, name, start, dur, corr=0, tid=1):
    act = {"kernel": "kernel", "span": "user_annotation", "runtime": "cuda_runtime"}[kind]
    return SimpleNamespace(
        name=lambda: name, device_type=lambda: "DeviceType.CUDA" if kind == "kernel" else "DeviceType.CPU",
        activity_type=lambda: act, start_ns=lambda: start, duration_ns=lambda: dur, correlation_id=lambda: corr,
        linked_correlation_id=lambda: 0, start_thread_id=lambda: tid, fwd_thread_id=lambda: 0,
        is_user_annotation=lambda: kind == "span")


def _synthetic():
    """A step: the forward holds two attention spans and the loss."""
    events = [
        _ev("span", "mis.train.step", 0, 100), _ev("span", "mis.train.forward", 1, 50),
        _ev("span", "mis.swin.attention", 2, 10), _ev("span", "mis.swin.attention", 14, 10),
        _ev("span", "mis.seg.loss", 30, 10),
        _ev("runtime", "cudaLaunchKernel", 3, 1, corr=1), _ev("kernel", "fmha_cutlassF", 5, 6, corr=1),
        _ev("runtime", "cudaLaunchKernel", 15, 1, corr=2), _ev("kernel", "fmha_cutlassF", 16, 2, corr=2),
        _ev("runtime", "cudaLaunchKernel", 31, 1, corr=3), _ev("kernel", "loss_kernel", 40, 4, corr=3),
    ]
    return program_trace.attribute(events, 0, 100)


def _run(pt, **kw):
    base = dict(program=pt, steps=2, kind="train", peaks=(989.4e12, 3.35e12), trace=None,
                attention_flops_per_step=989.4e3, attention_bytes_per_step=3.35e3 / 2)
    return SimpleNamespace(**{**base, **kw})


def test_the_new_readers_on_a_synthetic_trace():
    read = {n: spec.load_module("metrics", n).read for n in NEW_METRICS}
    run = _run(_synthetic())
    assert read["swin.attention_ms"](run) == pytest.approx(8 / 1e6 / 2)
    # 989.4 kFLOP at 989.4 TFLOP/s is 1 ns, more than the bytes' 0.5 ns; the spans' kernels take 4 ns a step
    assert read["swin.attention_roofline"](run) == pytest.approx(25.0)
    assert read["swin.attention_roofline"](_run(_synthetic(), attention_bytes_per_step=3.35e3 * 2)) == \
        pytest.approx(50.0)


def test_the_new_readers_read_nothing_without_their_spans(monkeypatch):
    read = {n: spec.load_module("metrics", n).read for n in NEW_METRICS}
    empty = ProgramTrace(lo=0, hi=100)
    for n, r in read.items():
        assert r(_run(None)) is None, n
        if n != "swin.attention_tokens_per_step":
            assert r(_run(empty)) is None, n
    assert read["swin.attention_roofline"](_run(_synthetic(), attention_flops_per_step=None)) is None
    from medical_image_segmentation_tpu_torch.core import profiling

    monkeypatch.delattr(profiling, "counters")
    assert read["swin.attention_tokens_per_step"](_run(None, trace=object())) is None
