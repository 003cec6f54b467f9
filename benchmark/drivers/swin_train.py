"""Swin UNETR training traffic: the program's augmentation and train step,
steps back to back, fed from a ring of seeded CT-like volumes resident on
the card (the loader bypassed).

Each step takes ``batch_per_chip`` volumes of a ring of ``ring_volumes``
CT-like volumes of ``volume`` with 3-class label maps, in turn (the
volumes and picks of ``drivers/seg_train.py``'s nnU-Net cell), and runs
what ``train_segmentation3d.py --arch swin_unetr`` runs on them:
``ops/augment3d.py::segmentation_augment_3d`` (random crop to ``patch``,
flips on three axes, brightness and contrast, the label map moved value
for value), then ``Segmentation3DTask.train_step`` (MONAI's squared
softmax Dice + CE, AdamW, the warmup-cosine schedule).

Set-up builds the task, loads weights made from the seed (Swin UNETR's
initialisation, ``swin_weights``), enters the schedule at ``start_step``
and drives the task through ``setup_steps`` steps of the window's own call
and feed, which also warm up every shape. After the window the program is
freed and the reference (``reference/swin_unetr.py``, float32, TF32 off)
follows the first three steps from the same weights, on the same data
and redrawn augmentation draws. A traced window is captured with
``harness/program_capture.py``, so the per-layer metrics read the
program's own spans and counters.
"""

from __future__ import annotations

import itertools
import math
import time
from typing import Dict

import torch

from benchmark.drivers import seg_train
from benchmark.drivers.seg_train import COMPARED_STEPS, _seed, release
from benchmark.harness import checks, program_capture, record, swin_counts, trace
from benchmark.harness.ct_seg import volumes_with_labels
from benchmark.harness.record import log
from benchmark.reference import nets, nnunet3d, swin_unetr


def make_ring(ctx) -> list:
    """The resident volumes and label maps, and each step's picks (made once,
    on the card: no copy from the host inside a step)."""
    tr, b = ctx.cell.traffic, ctx.cell.config["batch_per_chip"]
    gen = torch.Generator(device=ctx.device).manual_seed(_seed(ctx.seed, 100))
    n = tr["ring_volumes"]
    picks = [torch.tensor([(k * b + i) % n for i in range(b)], device=ctx.device)
             for k in range(n // math.gcd(n, b))]
    return [volumes_with_labels(n, tuple(tr["volume"]), gen), picks]


def ring_batch(ring: list, k: int):
    (vols, labels), picks = ring
    idx = picks[k % len(picks)]
    return vols.index_select(0, idx), labels.index_select(0, idx)


def swin_weights(layout: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Swin UNETR's initialisation from the seed in one draw: Linear weights
    and the bias tables normal of std 0.02 (the truncation at ±2 lies 100
    deviations out), convs and transposed convs He normal over torch's
    fan-in of the weight, biases 0, LayerNorm scales 1, the relative position
    indices as the reference states them."""
    def std(name, shape):
        if len(shape) == 5:
            return math.sqrt(2.0 / (shape[1] * math.prod(shape[2:])))
        return 0.02

    drawn = [(k, tuple(s)) for k, s in layout.items() if len(s) >= 2 and not k.endswith("relative_position_index")]
    numels = [math.prod(s) for _, s in drawn]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(numels), generator=gen, device=device)
    stds = torch.tensor([std(k, s) for k, s in drawn], device=device)
    flat.mul_(torch.repeat_interleave(stds, torch.tensor(numels, device=device)))
    out = {k: t.view(s) for (k, s), t in zip(drawn, flat.split(numels))}
    for k, s in layout.items():
        if k.endswith("relative_position_index"):
            out[k] = swin_unetr.relative_position_index(round(s[0] ** (1 / 3))).to(device)
        elif k not in out:
            ones = ".norm" in k and k.endswith(".weight")
            out[k] = (torch.ones if ones else torch.zeros)(s, device=device)
    return out


def _task(ctx):
    from medical_image_segmentation_tpu_torch.train.seg3d_task import Segmentation3DTask

    cfg = ctx.cell.config
    return Segmentation3DTask(
        arch="swin_unetr", n_classes=cfg["classes"], in_channels=cfg["in_channels"],
        feature_size=cfg["feature_size"], learning_rate=cfg["learning_rate"], weight_decay=cfg["weight_decay"],
        warmup_epochs=cfg["warmup_epochs"], max_epochs=cfg["max_epochs"], steps_per_epoch=cfg["steps_per_epoch"],
        dtype=getattr(torch, cfg["dtype"]), device=ctx.device)


def _augment(ctx, gen, data):
    """The program's augmentation of one step's volumes (looked up at the
    call, where a planted fault may stand)."""
    import medical_image_segmentation_tpu_torch.ops.augment3d as a3

    cfg = ctx.cell.config
    return a3.segmentation_augment_3d(gen, *data, out_size=tuple(cfg["patch"]), mean=(cfg["mean"],),
                                      std=(cfg["std"],), train=True, dtype=getattr(torch, cfg["dtype"]), labels=True)


def setup(ctx) -> dict:
    """The task after the set-up steps, and what the comparison reads of
    them."""
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    if ctx.device.type == "cuda":
        torch.backends.cudnn.benchmark = True  # as the trainer sets it
    task = _task(ctx)
    weights = swin_weights(swin_unetr.layout(cfg), _seed(ctx.seed, 1), ctx.device)
    task.model.load_state_dict(weights)
    task.optimizer.state.clear()
    task.step = cfg["start_step"]
    ring = make_ring(ctx)
    gen = torch.Generator(device=ctx.device).manual_seed(_seed(ctx.seed, 2))
    counter = itertools.count()
    state = {"task": task, "weights": weights, "ring": ring}

    def step(span: bool = False):
        data = ring_batch(ring, next(counter))
        with trace.span(span, "augment"):
            x, y = _augment(ctx, gen, data)
        with trace.span(span, "train_step"):
            out = task.train_step(x, y)
        return out, x, y

    state["step"] = step
    names = [n for n, _ in task.model.named_parameters()]
    obs = {"losses": []}
    for i in range(tr["setup_steps"]):
        out, x, y = step()
        if i < COMPARED_STEPS:
            obs["losses"].append(out["train/loss"])
        if i == 0:
            obs["inputs"] = (x, y)
            obs["grad"] = torch.stack([p.grad.norm() if p.grad is not None else torch.zeros((), device=ctx.device)
                                       for p in task.model.parameters()])
        if i == COMPARED_STEPS - 1:
            obs["change"] = torch.stack([(p.detach() - weights[n]).norm() for n, p in task.model.named_parameters()])
    record.sync(ctx.device)
    obs["losses"] = [float(v) for v in obs["losses"]]
    obs["grad"] = dict(zip(names, obs["grad"].tolist()))
    obs["change"] = dict(zip(names, obs["change"].tolist()))
    state["obs"] = obs
    return state


def window(ctx, state, run: record.Run) -> None:
    """Steps back to back for ``ctx.seconds``, ending in a synchronize."""
    cfg = ctx.cell.config
    b = cfg["batch_per_chip"]
    step = state["step"]
    record.sync(ctx.device)
    run.setup_s = time.time() - ctx.t_start
    n = 0
    with program_capture.capture(ctx.trace) as cap:
        with trace.span(ctx.trace, "window"):
            stopper = record.Stopper(ctx.seconds, ctx.device)
            t0 = time.perf_counter()
            while True:
                step(ctx.trace)
                n += 1
                if stopper(n):
                    break
            with trace.span(ctx.trace, "sync"):
                record.sync(ctx.device)
            run.window_s = time.perf_counter() - t0
    run.steps = n
    run.samples = n * b
    run.trace, run.program = cap.trace, cap.program
    run.flops_per_step = swin_counts.train_flops(cfg, b)
    run.norm_bytes_per_step = swin_counts.instance_norm_fwd_bytes(cfg, b)
    run.attention_flops_per_step = swin_counts.attention_flops(cfg, b)
    run.attention_bytes_per_step = swin_counts.attention_bytes(cfg, b)


def reference(ctx, state, precision: str = "f32") -> dict:
    """The reference's readings of the compared steps."""
    with nets.exact_f32():
        return _reference(ctx, state, precision)


def _reference(ctx, state, precision) -> dict:
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    gen = torch.Generator(device=ctx.device).manual_seed(_seed(ctx.seed, 2))
    ref = swin_unetr.ReferenceSwin(cfg, state["weights"], cfg["start_step"], precision)
    out = {"losses": []}
    for k in range(COMPARED_STEPS):
        imgs, labels = ring_batch(state["ring"], k)
        draws = nnunet3d.sample_draws(gen, cfg["batch_per_chip"], tuple(tr["volume"]), tuple(cfg["patch"]))
        x, y = nnunet3d.augment(draws, imgs, labels, tuple(cfg["patch"]), cfg["mean"], cfg["std"],
                                getattr(torch, cfg["dtype"]))
        if k == 0:
            out["inputs"] = (x, y)
        loss, grads = ref.loss_and_grads(x, y)
        ref.apply(grads)
        out["losses"].append(float(loss))
        if k == 0:
            out["grad"] = {n: float(g.norm()) for n, g in grads.items()}
    out["change"] = {n: float((ref.P[n] - state["weights"][n]).norm()) for n in out["grad"]}
    return out


def program_readings(state) -> dict:
    return {k: state["obs"][k] for k in ("losses", "grad", "change", "inputs")}


def numbers(ctx, prog: dict, ref: dict) -> Dict[str, float]:
    """``seg_train``'s numbers, and ``shifted_bias_grad_gap_worst``: the
    widest gradient gap among the relative position bias tables of the
    blocks that shift, each over the larger of its own norm and the median
    of those tables'. AdamW's first steps move each element by about
    lr·sign(g), so the change norms hardly see a gradient that points
    elsewhere; a table's gradient sums the scores' gradients of every
    window, and the shift mask takes the pairs across regions out of it,
    so a fault in the shift shows there."""
    out = seg_train.numbers(ctx, prog, ref)
    tables = [f"{b.name}.attn.relative_position_bias_table" for b in swin_counts.blocks(ctx.cell.config) if b.shifted]
    out["shifted_bias_grad_gap_worst"] = checks.leaf_gap(prog["grad"], ref["grad"], tables)
    return out


def compare(ctx, state, precision: str = "f32") -> Dict[str, float]:
    return numbers(ctx, program_readings(state), reference(ctx, state, precision))


def control_numbers(ctx, state) -> Dict[str, float]:
    """The control: the reference at the precision below the
    configuration's (float8 operands) put in the program's place, its
    images made in float8 too."""
    ref = reference(ctx, state)
    low = reference(ctx, state, "fp8")
    x, y = low["inputs"]
    low["inputs"] = (nets.round_fp8(x.float()).to(x.dtype), y)
    return numbers(ctx, low, ref)


def run(ctx) -> tuple:
    """(the run's record, its compared numbers)."""
    run_ = record.Run(cell=ctx.cell, chips=ctx.world, kind="train")
    state = setup(ctx)
    log("set-up done")
    window(ctx, state, run_)
    log(f"window done: {run_.steps} steps in {run_.window_s:.3f} s")
    run_.memory_peak_bytes = ctx.peak_memory()
    release(state)
    return run_, compare(ctx, state)
