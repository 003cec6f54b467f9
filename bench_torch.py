#!/usr/bin/env python3
"""End-to-end benchmark of the PyTorch/CUDA port on one NVIDIA GPU. Port of
``bench.py``.

    python bench_torch.py [--task byol|seg|seg3d|predict|predict3d] [flags]

Tasks, each on random weights from a seed and inputs from a seed:

- ``byol`` (the default): the two-view augmentation (the hand-written
  kernel ``csrc/two_view_augment.cu`` behind
  ``ops/fused_augment.py::fused_two_view_augment``) and the BYOL train step,
  ResNet-18 with hidden 4096 and projection 256, stored uint8 256² →
  two 112² bf16 views. Two modes: ``device`` (one resident uint8 batch: the
  ceiling of aug + train) and ``store`` (``--store PATH``, or ``--store
  auto`` to write a synthetic one, read by the port's ``Loader`` through
  ``data/device_feed.py::device_batches``: the whole input pipeline in the
  loop). ``--precrop`` crops on the host and runs only the elementwise
  tail (``ops/augment.py::two_view_tail_augment``) on the card.
- ``seg``: the U-Net segmentation train step with the paired
  augmentation on resident uint8 images and masks (batch 128, 224²).
- ``seg3d``: the 3D U-Net train step on resident f32 volumes of
  ``--volume_size`` with random ``--crop3d`` crops (batch 4).
- ``predict``: the serving function ``serve.py::make_predict_fn`` (uint8
  in, masks out), with per-batch latency percentiles; ``--exported`` also
  times the loaded ``torch.export`` program of one bucket of
  ``--batch_size`` (what a ``.misx`` artifact serves), leaving out
  ``torch.export.load``'s time, which goes to stderr.
- ``predict3d``: whole-volume sliding-window inference, the captured
  predictor ``eval/sliding_window.py::make_fused_predictor_3d`` by default
  and the loop ``sliding_window_predict_3d`` with ``--sw_loop``.

Timing: warmup steps first (cuDNN's autotune runs on the first calls), then
the throughput loop, unfenced, ending in one ``torch.cuda.synchronize``;
then a probe of ``min(steps, 12)`` steps, each synchronised, whose
percentiles feed the contention tripwire. The predict tasks synchronise
every call. FLOPs come from ``torch.utils.flop_counter.FlopCounterMode``
over one more whole step, outside the timed loop: it counts the
convolutions and matmuls of forward and backward, not the hand kernel
(called through ctypes) nor elementwise work. ``mfu`` is against the card's
dense bf16 peak (H100 SXM 989.4 TFLOP/s, H100 PCIe 756), None for another
card or the CPU. ``--profile DIR`` writes a ``torch.profiler`` Chrome trace
of the timed loop of any task to ``DIR/trace.json``.

Memory: PyTorch has no static memory plan. ``projected_hbm_gb`` of ``seg``
and ``seg3d`` is the peak allocated over the timed run, and ``--hbm_check``
(seg, seg3d, predict) runs ONE step at the run's shapes, putting the
task's state back, reads its peak against the card's memory, prints one
JSON line and exits: 2 when the step does not fit, 0 when it does, 4 where
the device has no memory capacity to compare against (the CPU).

Prints ONE JSON line last, with bench.py's metric names and fields
(``aug_train_images_per_sec_per_chip``, ``seg_train_images_per_sec_per_chip``,
``seg3d_train_volumes_per_sec_per_chip``, ``predict_images_per_sec_per_chip``,
``predict3d_volumes_per_sec_per_chip``), changed three ways:

- ``vs_baseline`` is dropped: its 5,000 img/s is a TPU target;
- ``device_name`` and ``power_limit_w`` are added, as ``nvidia-smi
  --query-gpu=name,power.limit`` gives them (``torch.cuda.get_device_name``
  and None without ``nvidia-smi``), so every number carries its card;
- in store mode ``reader`` is added, ``native`` or ``python``: the
  ``Loader`` reads in Python when the native library does not build.

One card a process: ``--device cuda:N`` picks it and the line says
``"gpus": 1``. ``--device`` defaults to ``cuda`` and the run exits 3 where
there is no card; ``--device cpu`` is for the tests, and its numbers are
no device metric.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# dense bf16 peak FLOP/s by card name (NVIDIA's data sheets, without sparsity)
_PEAK_FLOPS = {
    "h100 80gb hbm3": 989.4e12,
    "h100 sxm": 989.4e12,
    "h100 pcie": 756e12,
}
# DECATHLON_LIVER registry statistics on the 0-1 scale
LIVER_MEAN, LIVER_STD = 0.2089, 0.2109


def _peak_flops_per_chip(device: torch.device) -> float | None:
    if device.type != "cuda":
        return None
    kind = torch.cuda.get_device_name(device).lower()
    for k, v in sorted(_PEAK_FLOPS.items(), key=lambda kv: -len(kv[0])):
        if k in kind:
            return v
    return None


def _card_fields(device: torch.device) -> dict:
    """``device_name`` and ``power_limit_w`` of the card from its line of
    ``nvidia-smi --query-gpu=name,power.limit`` ("cpu" and None on the
    CPU; the CUDA name and None where ``nvidia-smi`` gives nothing)."""
    if device.type != "cuda":
        return {"device_name": "cpu", "power_limit_w": None, "gpus": 0}
    index = device.index if device.index is not None else torch.cuda.current_device()
    fields = {"device_name": torch.cuda.get_device_name(index), "power_limit_w": None, "gpus": 1}
    try:
        lines = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                               capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        lines = []
    if index < len(lines):
        name, _, limit = lines[index].rpartition(",")
        fields["device_name"] = name.strip()
        with contextlib.suppress(ValueError):
            fields["power_limit_w"] = float(limit.strip().split()[0])
    return fields


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _step_flops(fn) -> float | None:
    """FLOPs of one call of ``fn`` (``FlopCounterMode``: convolutions and
    matmuls, forward and backward; nothing called through ctypes)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    f = float(counter.get_total_flops())
    return f if f > 0 else None


def _mfu(flops, n_calls: int, seconds: float, device: torch.device):
    peak = _peak_flops_per_chip(device)
    return round(flops * n_calls / seconds / peak, 4) if flops and peak else None


def _memory_report(peak, device: torch.device) -> dict | None:
    """The JAX bench's memory report from a measured peak (None: out of
    memory); None off the card."""
    from medical_image_segmentation_tpu_torch.core.hbm import device_hbm_capacity

    cap = device_hbm_capacity(device)
    if cap is None:
        return None
    return {"projected_peak": peak, "capacity": cap, "oversubscribed": peak is None or peak > cap}


def _hbm_json_fields(mem) -> dict:
    """JSON-line fields for the memory report (None-safe)."""
    if not mem:
        return {}
    peak = mem["projected_peak"]
    out = {"projected_hbm_gb": None if peak is None else round(peak / 1024**3, 3)}
    if mem.get("capacity"):
        out["hbm_capacity_gb"] = round(mem["capacity"] / 1024**3, 3)
        out["hbm_oversubscribed"] = mem["oversubscribed"]
    return out


def _hbm_check_exit(probe, task: str, device: torch.device, extra: dict | None = None) -> int:
    """--hbm_check: run ``probe`` (ONE step at the run's shapes, which puts
    back what it changes) and read its peak device memory against the
    card's, print the diagnosis and one JSON line, and return 2 when the
    step does not fit, 0 when it does, 4 where the device has no capacity
    to compare against. Unlike bench.py, which only compiles, this runs the
    step: PyTorch has no static memory plan."""
    from torch.utils.flop_counter import FlopCounterMode

    from medical_image_segmentation_tpu_torch.core.hbm import device_hbm_capacity, format_hbm_report, probe_peak

    if device_hbm_capacity(device) is None:
        print(f"hbm_check: backend exposes no memory analysis (device {device} has no memory capacity)",
              file=sys.stderr)
        return 4
    with FlopCounterMode(display=False) as counter:
        peak = probe_peak(probe, device)
    mem = _memory_report(peak, device)
    print(format_hbm_report(mem, label=f"{task} step"), file=sys.stderr)
    if mem["oversubscribed"]:
        print(f"WARNING: {task} step does not fit the card's memory — lower --batch_size, use --remat, "
              "or shard wider", file=sys.stderr)
    fields = _hbm_json_fields(mem)
    out = {"metric": f"{task}_projected_hbm_gb", "value": fields.pop("projected_hbm_gb"), "unit": "GiB",
           "task": task, "hbm_check": True, **fields, **_card_fields(device)}
    if counter.get_total_flops():
        out["step_gflops"] = round(counter.get_total_flops() / 1e9, 1)
    if extra:
        out.update(extra)
    print(json.dumps(out))
    return 2 if mem["oversubscribed"] else 0


def _dispersion_fields(probe_lat, loop_ms_mean: float, label: str) -> dict:
    """Contention tripwire: per-step latency percentiles from a short
    FENCED probe run after the throughput loop, compared against the loop's
    unfenced mean. A contended card (another process running on it) shows
    up as p99/p50 dispersion inside the probe and/or a loop mean far above
    the probe's p50. Prints a LOUD warning so a dirty capture can't pass
    silently; the fields land in the JSON line either way."""
    lat = np.asarray(probe_lat, dtype=np.float64) * 1e3  # ms
    p50 = float(np.percentile(lat, 50))
    p99 = float(np.percentile(lat, 99))
    fields = {"step_ms_p50": round(p50, 2), "step_ms_p99": round(p99, 2),
              "step_ms_loop_mean": round(loop_ms_mean, 2)}
    contended = []
    if p50 > 0 and p99 / p50 > 1.4:
        contended.append(f"probe p99/p50 = {p99 / p50:.2f} (> 1.4)")
    # the fenced probe pays one host round-trip per step, so its p50 sits
    # slightly ABOVE the pipelined loop mean on a quiet card; the loop mean
    # exceeding the fenced p50 by >20% means something else ran DURING the loop
    if p50 > 0 and loop_ms_mean > 1.2 * p50:
        contended.append(
            f"loop mean {loop_ms_mean:.1f} ms vs fenced p50 {p50:.1f} ms")
    if contended:
        fields["contention_suspected"] = True
        print(f"WARNING: {label} step-latency dispersion suggests a CONTENDED "
              f"chip ({'; '.join(contended)}) — another process may hold the "
              "GPU; this measurement is NOT a clean capture", file=sys.stderr)
    return fields


def _time_steps(step, args, device: torch.device):
    """Warmup, the throughput loop (one sync at its end; traced under
    ``--profile``), then the fenced probe of ``min(steps, 12)`` steps.
    Returns (loop seconds, probe latencies, the loop's last result)."""
    from medical_image_segmentation_tpu_torch.core.profiling import trace_if

    for _ in range(args.warmup):
        step()
    _sync(device)
    with trace_if(args.profile or "", enabled=bool(args.profile), device=device):
        t0 = time.perf_counter()
        for _ in range(args.steps):
            out = step()
        _sync(device)
        dt = time.perf_counter() - t0
    probe_lat = []
    for _ in range(min(args.steps, 12)):
        t0 = time.perf_counter()
        step()
        _sync(device)
        probe_lat.append(time.perf_counter() - t0)
    return dt, probe_lat, out


def _time_calls(call, args, device: torch.device) -> np.ndarray:
    """Per-call latencies of ``args.steps`` synchronised calls after one
    call and the warmup (traced under ``--profile``)."""
    from medical_image_segmentation_tpu_torch.core.profiling import trace_if

    call()
    for _ in range(args.warmup):
        call()
    _sync(device)
    lat = []
    with trace_if(args.profile or "", enabled=bool(args.profile), device=device):
        for _ in range(args.steps):
            t0 = time.perf_counter()
            call()
            _sync(device)
            lat.append(time.perf_counter() - t0)
    return np.array(lat)


def _steps_run(args) -> int:
    """Steps a train task takes: warmup, timed, probe and the FLOP count's."""
    return args.warmup + args.steps + min(args.steps, 12) + 1


def _reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _run_peak(device: torch.device):
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None


def _resident(rng, shape, device: torch.device, dtype=np.uint8) -> torch.Tensor:
    if dtype == np.uint8:
        return torch.from_numpy(rng.integers(0, 256, size=shape).astype(np.uint8)).to(device)
    return torch.from_numpy(rng.random(shape).astype(dtype)).to(device)


def _make_auto_store(path: str, n: int, size: int, codec_name: str) -> None:
    from medical_image_segmentation_tpu_torch.data.store import CODEC_JPEG, CODEC_RAW, StoreWriter

    codec = CODEC_JPEG if codec_name == "jpeg" else CODEC_RAW
    rng = np.random.default_rng(0)
    with StoreWriter(path, channels=1) as w:
        for _ in range(n):
            w.add(rng.integers(0, 256, size=(size, size, 1)).astype(np.uint8), codec=codec)


def _seg_bench(args, device: torch.device) -> int:
    """U-Net segmentation train-step throughput (the reference's canonical
    seg config: U-Net(resnet18), 224², batch 128 a card). Resident uint8
    batch + the device-side paired augmentation the trainer runs."""
    from medical_image_segmentation_tpu_torch.core.hbm import preserved
    from medical_image_segmentation_tpu_torch.ops.augment import segmentation_augment
    from medical_image_segmentation_tpu_torch.train.segmentation_task import SegmentationTask

    if args.store is not None or args.precrop:
        raise SystemExit("--task seg benchmarks device-resident batches "
                         "(paired stores are exercised by the trainer tests)")
    size = (args.image_size, args.image_size)
    task = SegmentationTask(
        arch=args.arch, n_classes=1, in_channels=1, learning_rate=1.0,
        warmup_epochs=10, max_epochs=50, steps_per_epoch=100, remat=args.remat, device=device,
    )
    task.init(0)
    gen = torch.Generator(device=device).manual_seed(1)
    rng = np.random.default_rng(0)
    imgs = _resident(rng, (args.batch_size, *size, 1), device)
    msks = torch.from_numpy((rng.random((args.batch_size, *size, 1)) < 0.2).astype(np.uint8)).to(device)

    def step():
        x, y = segmentation_augment(gen, imgs, msks, size, (LIVER_MEAN,), (LIVER_STD,), train=True,
                                    dtype=torch.bfloat16)
        return task.train_step(x, y)

    if args.hbm_check:
        def probe():
            with preserved(task, gen):
                step()

        return _hbm_check_exit(probe, "seg", device, {"batch_size": args.batch_size,
                                                      "image_size": args.image_size})
    _reset_peak(device)
    dt, probe_lat, metrics = _time_steps(step, args, device)
    mem = _memory_report(_run_peak(device), device)
    final_loss = float(metrics["train/loss"])
    per_chip = args.batch_size * args.steps / dt
    disp = _dispersion_fields(probe_lat, dt / args.steps * 1e3, "seg")
    flops = _step_flops(step)
    print(f"[seg] loss={final_loss:.4f} total={per_chip:.0f} img/s "
          f"({dt/args.steps*1e3:.1f} ms/step)", file=sys.stderr)
    print(json.dumps({
        "metric": "seg_train_images_per_sec_per_chip",
        "value": round(per_chip, 1),
        "unit": "images/sec/chip",
        "mode": "device", "task": "seg", "mfu": _mfu(flops, args.steps, dt, device),
        "image_size": args.image_size, "batch_size": args.batch_size, "steps_run": _steps_run(args),
        **disp,
        **_hbm_json_fields(mem),
        **_card_fields(device),
    }))
    return 0


def _seg3d_bench(args, device: torch.device) -> int:
    """3D U-Net volumetric train-step throughput (``train_segmentation3d``
    defaults: stored (64,96,96) volumes → random (32,64,64) crops). The
    network runs in ``channels_last_3d``; shapes are given as (D, H, W)."""
    from medical_image_segmentation_tpu_torch.core.hbm import preserved
    from medical_image_segmentation_tpu_torch.ops.augment3d import segmentation_augment_3d
    from medical_image_segmentation_tpu_torch.train.seg3d_task import Segmentation3DTask

    if args.store is not None or args.precrop:
        raise SystemExit("--task seg3d benchmarks device-resident batches")
    vol = tuple(args.volume_size)
    crop = tuple(args.crop3d)
    task = Segmentation3DTask(
        features=tuple(args.features3d),
        learning_rate=1.0, warmup_epochs=10, max_epochs=50, steps_per_epoch=100,
        remat=args.remat, device=device,
    )
    task.init(0)
    gen = torch.Generator(device=device).manual_seed(1)
    rng = np.random.default_rng(0)
    vols = _resident(rng, (args.batch_size, *vol, 1), device, np.float32)
    msks = torch.from_numpy((rng.random((args.batch_size, *vol, 1)) < 0.2).astype(np.float32)).to(device)

    def step():
        x, y = segmentation_augment_3d(gen, vols, msks, out_size=crop, train=True, dtype=torch.bfloat16)
        return task.train_step(x, y)

    if args.hbm_check:
        def probe():
            with preserved(task, gen):
                step()

        return _hbm_check_exit(probe, "seg3d", device, {"batch_size": args.batch_size,
                                                        "features": list(args.features3d)})
    _reset_peak(device)
    dt, probe_lat, metrics = _time_steps(step, args, device)
    mem = _memory_report(_run_peak(device), device)
    final_loss = float(metrics["train/loss"])
    per_chip = args.batch_size * args.steps / dt
    disp = _dispersion_fields(probe_lat, dt / args.steps * 1e3, "seg3d")
    flops = _step_flops(step)
    print(f"[seg3d] loss={final_loss:.4f} total={per_chip:.1f} vol/s "
          f"({dt/args.steps*1e3:.1f} ms/step, crop {crop})", file=sys.stderr)
    print(json.dumps({
        "metric": "seg3d_train_volumes_per_sec_per_chip",
        "value": round(per_chip, 2),
        "unit": "volumes/sec/chip",
        "mode": "device", "task": "seg3d", "mfu": _mfu(flops, args.steps, dt, device),
        "features": list(args.features3d), "volume": list(vol), "crop": list(crop),
        "batch_size": args.batch_size, "steps_run": _steps_run(args),
        **disp,
        **_hbm_json_fields(mem),
        **_card_fields(device),
    }))
    return 0


def _predict_bench(args, device: torch.device) -> int:
    """Serving-path inference throughput: the SAME function
    ``train/predict.py`` runs and ``mis-export-torch`` captures
    (``serve.make_predict_fn``: uint8 in → normalize → U-Net eval forward →
    sigmoid-threshold mask out), batched, bf16 (``--fp32``: f32). Reports
    img/s plus per-batch latency percentiles, each batch synchronised (the
    masks stay on the card: their copy to the host is not an inference
    cost)."""
    from medical_image_segmentation_tpu_torch.serve import export_predictor, make_predict_fn
    from medical_image_segmentation_tpu_torch.train.segmentation_task import SegmentationTask

    if args.store is not None or args.precrop:
        raise SystemExit("--task predict benchmarks device-resident batches")
    task = SegmentationTask(
        arch=args.arch, n_classes=1, in_channels=1, learning_rate=1.0,
        warmup_epochs=0, max_epochs=1, steps_per_epoch=1,
        dtype=torch.float32 if args.fp32 else torch.bfloat16, device=device,
    )
    task.init(0)
    predict = make_predict_fn(task, LIVER_MEAN, LIVER_STD)
    rng = np.random.default_rng(0)
    shape = (args.batch_size, args.image_size, args.image_size, 1)
    imgs = _resident(rng, shape, device)
    if args.hbm_check:
        return _hbm_check_exit(lambda: predict(imgs), "predict", device,
                               {"batch_size": args.batch_size, "image_size": args.image_size})
    lat = _time_calls(lambda: predict(imgs), args, device)
    dt = float(lat.sum())
    per_chip = args.batch_size * args.steps / dt
    out_extra = {}
    if args.exported:
        # the same weights captured at this batch bucket (a .misx bucket's
        # program), saved, loaded and called directly, as ServingPredictor
        # calls it, without its numpy copies
        program = export_predictor(task, args.image_size, LIVER_MEAN, LIVER_STD,
                                   batch_sizes=(args.batch_size,))[args.batch_size]
        buf = io.BytesIO()
        torch.export.save(program, buf)
        t0 = time.perf_counter()
        ex_call = torch.export.load(io.BytesIO(buf.getvalue())).module()
        print(f"[predict --exported] torch.export.load + module(): {time.perf_counter() - t0:.2f} s "
              "(not in the timed calls)", file=sys.stderr)
        ex_imgs = _resident(rng, shape, device)
        with torch.no_grad():
            ex_lat = _time_calls(lambda: ex_call(ex_imgs), args, device)
        out_extra = {
            "exported_images_per_sec_per_chip": round(args.batch_size * args.steps / float(ex_lat.sum()), 1),
            "exported_batch": args.batch_size,
            "exported_latency_ms_p50": round(float(np.percentile(ex_lat, 50)) * 1e3, 2),
            "exported_latency_ms_p99": round(float(np.percentile(ex_lat, 99)) * 1e3, 2),
        }
        print(f"[predict --exported] {out_extra['exported_images_per_sec_per_chip']:.0f} img/s "
              f"(batch {args.batch_size}, p50 {out_extra['exported_latency_ms_p50']:.1f} ms, "
              f"p99 {out_extra['exported_latency_ms_p99']:.1f} ms)", file=sys.stderr)
    flops = _step_flops(lambda: predict(imgs))
    print(f"[predict] total={per_chip:.0f} img/s "
          f"(batch {args.batch_size} @ {args.image_size}², "
          f"p50 {np.percentile(lat,50)*1e3:.1f} ms, p99 {np.percentile(lat,99)*1e3:.1f} ms)",
          file=sys.stderr)
    print(json.dumps({
        "metric": "predict_images_per_sec_per_chip",
        "value": round(per_chip, 1),
        "unit": "images/sec/chip",
        "mode": "device", "task": "predict", "mfu": _mfu(flops, args.steps, dt, device),
        "image_size": args.image_size, "fp32": args.fp32, "batch_size": args.batch_size,
        "batch_latency_ms_p50": round(float(np.percentile(lat, 50)) * 1e3, 2),
        "batch_latency_ms_p99": round(float(np.percentile(lat, 99)) * 1e3, 2),
        **out_extra,
        **_card_fields(device),
    }))
    return 0


def _predict3d_bench(args, device: torch.device) -> int:
    """Volumetric serving-path throughput: whole-volume masks by overlapped
    sliding-window blending, END-TO-END per volume (window extraction +
    batched 3D U-Net forwards + Hann blend, all on the card): vol/s and
    p50/p99 per-volume latency. The captured predictor (the serving
    default) runs its first call eagerly, captures on the second and
    replays after; it holds the volume's shape and the card."""
    from medical_image_segmentation_tpu_torch.eval.sliding_window import (
        count_windows_3d,
        make_fused_predictor_3d,
        make_unet_window_fn,
        sliding_window_predict_3d,
    )
    from medical_image_segmentation_tpu_torch.train.seg3d_task import Segmentation3DTask

    if args.store is not None or args.precrop:
        raise SystemExit("--task predict3d benchmarks device-resident volumes")
    if args.hbm_check:
        raise SystemExit("--hbm_check is for train steps (seg/seg3d) and "
                         "predict; sliding-window inference is many small "
                         "programs, not one")
    vol = tuple(args.volume_size)
    window = tuple(args.crop3d)
    task = Segmentation3DTask(features=tuple(args.features3d),
                              learning_rate=1.0, warmup_epochs=0, max_epochs=1, steps_per_epoch=1,
                              dtype=torch.float32 if args.fp32 else torch.bfloat16, device=device)
    task.init(0)
    window_fn = make_unet_window_fn(task)
    rng = np.random.default_rng(0)
    volume = _resident(rng, (*vol, 1), device, np.float32)

    if args.sw_loop:
        def run():
            return sliding_window_predict_3d(window_fn, volume, window=window, batch_windows=args.batch_size)
    else:
        fused = make_fused_predictor_3d(window_fn, tuple(volume.shape), window, batch_windows=args.batch_size,
                                        device=device)

        def run():
            return fused(volume)

    lat = _time_calls(run, args, device)
    dt = float(lat.sum())
    vols_per_sec = args.steps / dt
    flops = _step_flops(lambda: window_fn(torch.zeros((args.batch_size, *window, 1), device=device)))
    n_win = count_windows_3d(vol, window)
    n_batches = math.ceil(n_win / args.batch_size)
    print(f"[predict3d] {vols_per_sec:.2f} vol/s (volume {vol}, window {window}, "
          f"{n_win} windows/{n_batches} batches, p50 {np.percentile(lat,50)*1e3:.0f} ms, "
          f"p99 {np.percentile(lat,99)*1e3:.0f} ms)", file=sys.stderr)
    print(json.dumps({
        "metric": "predict3d_volumes_per_sec_per_chip",
        "value": round(vols_per_sec, 2),
        "unit": "volumes/sec/chip",
        "mode": "device", "task": "predict3d", "mfu": _mfu(flops, n_batches * args.steps, dt, device),
        "sw_mode": "loop" if args.sw_loop else "fused",
        "volume": list(vol), "window": list(window),
        "windows_per_volume": n_win, "batch_size": args.batch_size,
        "volume_latency_ms_p50": round(float(np.percentile(lat, 50)) * 1e3, 2),
        "volume_latency_ms_p99": round(float(np.percentile(lat, 99)) * 1e3, 2),
        **_card_fields(device),
    }))
    return 0


def _byol_bench(args, device: torch.device) -> int:
    """Two-view augmentation + BYOL train step, from a resident batch
    (device mode) or through the store ``Loader`` (store mode)."""
    from medical_image_segmentation_tpu_torch.data.device_feed import device_batches
    from medical_image_segmentation_tpu_torch.data.loader import RANDOM, Loader
    from medical_image_segmentation_tpu_torch.ops.augment import BYOL_VIEW1, BYOL_VIEW2, two_view_tail_augment
    from medical_image_segmentation_tpu_torch.ops.fused_augment import fused_two_view_augment
    from medical_image_segmentation_tpu_torch.train.byol_task import BYOLTask

    if args.hbm_check:
        raise SystemExit("--hbm_check supports tasks seg/seg3d/predict")
    if args.warmup < 1:
        raise SystemExit("--warmup must be >= 1")
    if args.precrop and args.store is None:
        raise SystemExit("--precrop requires --store")

    task = BYOLTask(
        arch=args.arch, in_channels=1, hidden_dim=4096, proj_dim=256,
        num_classes=10, total_steps=100_000,
        learning_rate=1.0, warmup_epochs=10, max_epochs=200,
        remat=args.remat, device=device,
    )
    task.init(0)
    crop = (args.crop_size, args.crop_size)
    cfg1 = dataclasses.replace(BYOL_VIEW1, out_size=crop)
    cfg2 = dataclasses.replace(BYOL_VIEW2, out_size=crop)
    gen = torch.Generator(device=device).manual_seed(1)

    if args.precrop:
        def augment(views):
            # views: (2B, crop, crop, 1) uint8, crop/resize/flip already done
            # by the loader's workers; only the elementwise tail runs here
            return two_view_tail_augment(gen, views, cfg1, cfg2)
    else:
        def augment(raw):
            return fused_two_view_augment(raw, cfg1, cfg2, generator=gen)

    rng = np.random.default_rng(0)
    # the resident batch of device mode and of the FLOP count: the shape the
    # step takes, full images or 2x pre-cropped views
    probe_shape = ((2 * args.batch_size, *crop, 1) if args.precrop
                   else (args.batch_size, args.image_size, args.image_size, 1))
    probe = _resident(rng, probe_shape, device)

    mode = "device" if args.store is None else "store"
    loader = feed = tmpdir = None
    threads = args.num_threads or (os.cpu_count() or 4)
    try:
        if mode == "store":
            store_path = args.store
            if store_path == "auto":
                tmpdir = tempfile.mkdtemp()
                store_path = os.path.join(tmpdir, "bench.mis")
                _make_auto_store(store_path, args.store_images, args.image_size, args.store_codec)
                print(f"synthetic {args.store_codec} store: "
                      f"{os.path.getsize(store_path)/1e6:.1f} MB, {args.store_images} images", file=sys.stderr)
            loader = Loader(
                store_path, args.batch_size, order=RANDOM, num_threads=threads,
                out_hw=(args.image_size, args.image_size),
                precrop={"out_hw": crop} if args.precrop else None,
            )
            if loader.channels != 1:
                raise SystemExit("bench expects a grayscale (1-channel) store")
            if len(loader) == 0:
                raise SystemExit(f"the store holds {loader.num_samples} images, fewer than one batch of "
                                 f"{args.batch_size}")

            def batches():
                while True:  # loop epochs; each gets a fresh permutation
                    with contextlib.closing(device_batches(loader, device)) as epoch:
                        for imgs, _ in epoch:
                            yield imgs

            feed = batches()

            def step():
                return task.train_step(*augment(next(feed)))
        else:
            def step():
                return task.train_step(*augment(probe))

        dt, probe_lat, metrics = _time_steps(step, args, device)
        final_loss = float(metrics["loss"])
        per_chip = args.batch_size * args.steps / dt
        disp = _dispersion_fields(probe_lat, dt / args.steps * 1e3, "byol")
        flops = _step_flops(lambda: task.train_step(*augment(probe)))
        mfu = _mfu(flops, args.steps, dt, device)
        print(
            f"[{mode}] loss={final_loss:.4f} total={per_chip:.0f} img/s "
            f"({dt/args.steps*1e3:.1f} ms/step)"
            + (f" step_flops={flops/1e9:.1f} GF mfu={mfu:.1%}" if mfu is not None else ""),
            file=sys.stderr,
        )
        out = {
            "metric": "aug_train_images_per_sec_per_chip",
            "value": round(per_chip, 1),
            "unit": "images/sec/chip",
            "mode": mode, "task": "byol",
            "mfu": mfu,
            "batch_size": args.batch_size, "image_size": args.image_size, "crop_size": args.crop_size,
            "steps_run": _steps_run(args),
            **disp,
        }
        if mode == "store":
            # bytes the loader ships per image: 2 crop² views in precrop
            # mode, full frames else
            shipped = 2 * args.crop_size * args.crop_size if args.precrop else args.image_size * args.image_size
            out["loader_gbytes_per_sec"] = round(per_chip * shipped / 1e9, 3)
            out["num_decode_threads"] = threads
            out["precrop"] = args.precrop
            out["h2d_bytes_per_batch"] = args.batch_size * shipped
            out["reader"] = "native" if loader._native is not None else "python"
            for stage, (tot, n) in loader.timers.snapshot().items():
                out[f"{stage}_ms_per_batch"] = round(tot / max(n, 1) * 1e3, 2)
                out[f"{stage}_batches_timed"] = n
            print(loader.timers.report(), file=sys.stderr)
        out.update(_card_fields(device))
        print(json.dumps(out))
    finally:
        if feed is not None:
            feed.close()
        if loader is not None:
            loader.close()
        if tmpdir is not None:
            shutil.rmtree(tmpdir, ignore_errors=True)
    return 0


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="End-to-end benchmark of the PyTorch/CUDA port on one GPU.")
    ap.add_argument("--batch_size", type=int, default=None,
                    help="default: 1024 (byol), 128 (seg), 4 (seg3d), "
                         "256 (predict), 8 windows (predict3d)")
    ap.add_argument("--image_size", type=int, default=None,
                    help="default: 256 stored (byol), 224 (seg/predict — the "
                         "reference's canonical seg resolution, "
                         "train_segmentation.py:35)")
    ap.add_argument("--crop_size", type=int, default=112)
    ap.add_argument("--arch", default="resnet18")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--fp32", action="store_true",
                    help="predict: f32 activations instead of bf16")
    ap.add_argument("--store", default=None,
                    help="feed from a real MIS store through the port's Loader "
                         "('auto' synthesizes one); default: device-resident batch")
    ap.add_argument("--store_codec", default="jpeg", choices=["jpeg", "raw"],
                    help="codec for --store auto")
    ap.add_argument("--store_images", type=int, default=4096, help="size of --store auto")
    ap.add_argument("--num_threads", type=int, default=0,
                    help="loader decode threads (0 = host cpu count)")
    ap.add_argument("--precrop", action="store_true",
                    help="with --store: host-side RandomResizedCrop in the native "
                         "workers (ships 2x crop^2 views instead of full images "
                         "— ~2.6x fewer H2D bytes at 256->112; the elementwise "
                         "augment tail still runs on the card)")
    ap.add_argument("--remat", action="store_true",
                    help="checkpoint residual blocks (fit bigger archs/batches)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler Chrome trace of the timed loop to DIR/trace.json")
    ap.add_argument("--task", default="byol",
                    choices=["byol", "seg", "seg3d", "predict", "predict3d"],
                    help="seg: U-Net(arch) segmentation train step with "
                         "device-side paired augmentation (canonical config "
                         "= the defaults: batch 128 @ 224²); "
                         "seg3d: volumetric 3D U-Net train step (--volume_size/"
                         "--crop3d, e.g. --task seg3d --batch_size 4); "
                         "predict: serving-path U-Net inference (img/s + "
                         "per-batch latency percentiles; --exported also times "
                         "the exported bucket program); "
                         "predict3d: whole-volume sliding-window serving "
                         "(vol/s + per-volume latency); "
                         "device-resident batches only")
    ap.add_argument("--sw_loop", action="store_true",
                    help="predict3d: use the loop variant of sliding-window "
                         "inference instead of the captured predictor "
                         "(A/B lever for the serving row)")
    ap.add_argument("--exported", action="store_true",
                    help="predict: additionally export the serving function "
                         "(torch.export, one bucket of --batch_size) and time the loaded program")
    ap.add_argument("--hbm_check", action="store_true",
                    help="seg/seg3d/predict: run ONE step, print its peak device "
                         "memory against the card's, and exit (2 if it does not "
                         "fit, 4 without a card to compare against)")
    ap.add_argument("--volume_size", type=int, nargs=3, default=(64, 96, 96),
                    metavar=("D", "H", "W"), help="seg3d: stored volume shape")
    ap.add_argument("--crop3d", type=int, nargs=3, default=(32, 64, 64),
                    metavar=("D", "H", "W"), help="seg3d: random train crop")
    ap.add_argument("--features3d", type=int, nargs="+", default=(32, 64, 128, 256),
                    help="seg3d: UNet3D stage widths (matches "
                         "train_segmentation3d --features)")
    ap.add_argument("--device", default="cuda",
                    help="the card to measure (cuda or cuda:N; one a process); "
                         "cpu is for the tests and measures no device")
    args = ap.parse_args(argv)
    if args.steps < 1:
        ap.error("--steps must be >= 1")
    if args.batch_size is None:
        args.batch_size = {"byol": 1024, "seg": 128, "seg3d": 4,
                           "predict": 256, "predict3d": 8}[args.task]
    if args.image_size is None:
        args.image_size = {"byol": 256, "seg": 224, "seg3d": 256,
                           "predict": 224, "predict3d": 256}[args.task]
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print(f"bench_torch: --device {args.device} asked for, but torch.cuda.is_available() is false: "
                  "there is no CUDA card to measure (--device cpu runs the tests' toy sizes and measures "
                  "no device)", file=sys.stderr)
            return 3
        if device.index is not None:
            torch.cuda.set_device(device)
        torch.backends.cudnn.benchmark = True
    return {"byol": _byol_bench, "seg": _seg_bench, "seg3d": _seg3d_bench,
            "predict": _predict_bench, "predict3d": _predict3d_bench}[args.task](args, device)


if __name__ == "__main__":
    sys.exit(main())
