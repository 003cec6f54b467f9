"""Segmentation serving traffic: one caller in a closed loop through the
program's serving function.

Each request is ``request_slices`` CT-like uint8 slices in pageable host
memory, drawn from a seeded pool of ``pool`` slices (a ring of
``request_ring`` requests made in set-up). A request runs as
``train/predict.py`` serves a batch from a checkpoint: the batch to the
card, ``serve.py::make_predict_fn`` (normalize, eval forward, sigmoid
threshold), the masks back to host memory. Its latency runs from the host
batch to the masks in host memory; the next request goes when one returns.

A seeded reservoir keeps ``sample_requests`` of the window's answers. After
the window the program is freed and the reference U-Net
(``reference/nets.py``, float32, TF32 off) computes their logits, which
judge the masks.
"""

from __future__ import annotations

import gc
import time
from typing import Dict

import numpy as np
import torch

from benchmark.harness import checks, counts, record, trace
from benchmark.harness.record import log
from benchmark.harness.ct_like import ct_like
from benchmark.harness.weights import make_weights
from benchmark.reference import nets
from benchmark.reference.layouts import unet_layout


def _seed(seed: int, k: int) -> int:
    return (seed * 1000003 + k) % (1 << 62)


def request_ring(ctx) -> list:
    """The ring of requests: ``request_ring`` arrays (slices, H, W, 1)
    uint8 in host memory, each a seeded draw of the pool."""
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    gen = torch.Generator(device=ctx.device).manual_seed(_seed(ctx.seed, 4))
    pool = ct_like(tr["pool"], cfg["image_size"], gen).cpu().numpy()
    rng = np.random.default_rng(_seed(ctx.seed, 5))
    return [pool[rng.integers(0, tr["pool"], tr["request_slices"])] for _ in range(tr["request_ring"])]


@torch.no_grad()
def served_weights(ctx) -> dict:
    """The served model's weights from the seed, with BatchNorm statistics
    of the traffic: one train-mode forward of the reference over the first
    ``request_slices`` slices of the pool sets every layer's running mean
    and variance to that batch's, as a trained network's are set, and the
    head's bias puts the median logit of that batch at the mask's
    threshold, so that masks hold boundaries as served masks do."""
    cfg = ctx.cell.config
    weights = make_weights(unet_layout(cfg), _seed(ctx.seed, 1), ctx.device)
    x = _normalized(ctx, request_ring(ctx)[0])
    stats = {}
    nets.unet(x, weights, cfg["arch"], stats=stats)
    for name, (mean, var) in stats.items():
        weights[f"{name}.running_mean"].copy_(mean)
        weights[f"{name}.running_var"].copy_(var)
    weights["head.bias"] -= nets.unet(x, weights, cfg["arch"]).flatten(0, 2).median(dim=0).values
    return weights


def _normalized(ctx, buf: np.ndarray) -> torch.Tensor:
    cfg = ctx.cell.config
    x = torch.from_numpy(buf).to(ctx.device).float() / torch.tensor(255.0, device=ctx.device)
    return (x - torch.tensor(cfg["mean"], device=ctx.device)) / torch.tensor(cfg["std"], device=ctx.device)


def setup(ctx) -> dict:
    from medical_image_segmentation_tpu_torch.serve import make_predict_fn
    from medical_image_segmentation_tpu_torch.train.segmentation_task import SegmentationTask

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    # train/predict.py (2D) leaves cudnn.benchmark as it is: off
    task = SegmentationTask(arch=cfg["arch"], n_classes=cfg["classes"], in_channels=cfg["in_channels"],
                            dtype=getattr(torch, cfg["dtype"]), device=ctx.device)
    with nets.exact_f32():
        weights = served_weights(ctx)
    task.model.load_state_dict(weights)
    predict = make_predict_fn(task, cfg["mean"], cfg["std"], threshold=cfg["threshold"])
    ring = request_ring(ctx)
    device = ctx.device

    def serve(buf: np.ndarray, span: bool = False) -> np.ndarray:
        with trace.span(span, "copy_in"):
            x = torch.from_numpy(buf).to(device)
        with trace.span(span, "predict"):
            masks = predict(x)
        with trace.span(span, "copy_out"):
            return masks.cpu().numpy()

    for i in range(tr["setup_requests"]):
        serve(ring[i % len(ring)])
    record.sync(device)
    return {"task": task, "weights": weights, "ring": ring, "serve": serve}


def window(ctx, state, run: record.Run) -> None:
    """Requests back to back for ``ctx.seconds``; a seeded reservoir of the
    answers."""
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    serve, ring = state["serve"], state["ring"]
    k = tr["sample_requests"]
    rng = np.random.default_rng(_seed(ctx.seed, 6))
    kept, lat = [], []
    record.sync(ctx.device)
    run.setup_s = time.time() - ctx.t_start
    with trace.capture(ctx.trace) as cap:
        with trace.span(ctx.trace, "window"):
            end = time.perf_counter() + ctx.seconds
            t0 = time.perf_counter()
            n = 0
            while True:
                r = n % len(ring)
                t = time.perf_counter()
                masks = serve(ring[r], ctx.trace)
                done = time.perf_counter()
                lat.append(done - t)
                if n < k:
                    kept.append((r, masks))
                else:
                    j = int(rng.integers(0, n + 1))
                    if j < k:
                        kept[j] = (r, masks)
                n += 1
                if done >= end:
                    break
            run.window_s = time.perf_counter() - t0
    run.requests = run.steps = n
    run.samples = n * tr["request_slices"]
    run.latencies_s = lat
    run.trace = cap.trace
    run.flops_per_step = counts.unet_forward_flops(cfg, tr["request_slices"])
    state["kept"] = kept


def release(state) -> None:
    for key in ("task", "serve"):
        state.pop(key, None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


@torch.no_grad()
def reference_logits(ctx, state, buf: np.ndarray, precision: str = "f32") -> torch.Tensor:
    return nets.unet(_normalized(ctx, buf), state["weights"], ctx.cell.config["arch"], precision)


def compare(ctx, state) -> Dict[str, float]:
    with nets.exact_f32():
        gaps = [checks.mask_gap(torch.from_numpy(m).to(ctx.device), reference_logits(ctx, state, state["ring"][r]))
                for r, m in state["kept"]]
    return {"mask_gap": max(gaps) if gaps else float("inf")}


def control_numbers(ctx, state) -> Dict[str, float]:
    """The control: the reference with float8 operands in the program's
    place, its masks judged by the float32 reference."""
    gaps = []
    with nets.exact_f32():
        for r, _ in state["kept"]:
            low = reference_logits(ctx, state, state["ring"][r], "fp8")
            gaps.append(checks.mask_gap((low > 0).to(torch.uint8), reference_logits(ctx, state, state["ring"][r])))
    return {"mask_gap": max(gaps)}


def run(ctx) -> tuple:
    run_ = record.Run(cell=ctx.cell, chips=ctx.world, kind="serve")
    state = setup(ctx)
    log("set-up done")
    window(ctx, state, run_)
    log(f"window done: {run_.steps} steps in {run_.window_s:.3f} s")
    run_.memory_peak_bytes = ctx.peak_memory()
    release(state)
    return run_, compare(ctx, state)
