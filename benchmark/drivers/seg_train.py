"""Segmentation training traffic: the program's augmentation and train step,
steps back to back, fed from a ring of seeded CT-like data resident on the
card (the loader bypassed).

Two configurations run through it:

- nnU-Net's 3d_fullres (``arch`` ``nnunet3d``): each step takes
  ``batch_per_chip`` volumes of a ring of ``ring_volumes`` CT-like volumes
  of ``volume`` with 3-class label maps, in turn, and runs what
  ``train_segmentation3d.py --arch nnunet3d`` runs on them:
  ``ops/augment3d.py::segmentation_augment_3d`` (random crop to ``patch``,
  flips on three axes, brightness and contrast, the label map moved value
  for value), then ``Segmentation3DTask.train_step`` (deep-supervised
  Dice + CE, SGD-Nesterov with clipping, the poly schedule);
- the 2D U-Net(resnet18) (``unet_r18``): each step one of ``ring_batches``
  CT-like uint8 batches of ``batch_per_chip`` slices of ``stored_size``
  with liver masks, through ``ops/augment.py::segmentation_augment`` (to
  the configuration's ``image_size``, flips, brightness and contrast),
  then ``SegmentationTask.train_step`` (Dice, LARS, warmup-cosine); the
  training settings are the traffic's.

Set-up builds the task, loads weights made from the seed (the 2D U-Net:
``harness/weights.py``; nnU-Net: its He initialisation), enters the
schedule at ``start_step`` and drives the task through ``setup_steps``
steps of the window's own call and feed, which also warm up every shape.
After the window the program is freed and the reference (float32, TF32
off: ``reference/nnunet3d.py`` or ``reference/seg_step.py``) follows the
first three steps from the same weights, on the same data and redrawn
augmentation draws. A traced window is captured with
``harness/program_capture.py``, so the per-layer metrics read the
program's own spans.
"""

from __future__ import annotations

import gc
import itertools
import math
import time
from typing import Dict

import torch

from benchmark.harness import checks, program_capture, record, seg_counts, trace
from benchmark.harness.ct_seg import slices_with_masks, volumes_with_labels
from benchmark.harness.record import log
from benchmark.harness.weights import make_weights
from benchmark.reference import nets, nnunet3d, seg_step
from benchmark.reference.layouts import unet_layout

COMPARED_STEPS = 3


def _seed(seed: int, k: int) -> int:
    return (seed * 1000003 + k) % (1 << 62)


def volumetric(ctx) -> bool:
    return ctx.cell.config["arch"] == "nnunet3d"


def batch_size(ctx) -> int:
    return ctx.cell.config["batch_per_chip"] if volumetric(ctx) else ctx.cell.traffic["batch_per_chip"]


def make_ring(ctx) -> list:
    """The resident data: nnU-Net's volumes and label maps, or the 2D
    cell's batches of slices and masks."""
    tr = ctx.cell.traffic
    if volumetric(ctx):
        gen = torch.Generator(device=ctx.device).manual_seed(_seed(ctx.seed, 100))
        n, b = tr["ring_volumes"], batch_size(ctx)
        # each step's picks made once, on the card: no copy from the host inside a step
        picks = [torch.tensor([(k * b + i) % n for i in range(b)], device=ctx.device)
                 for k in range(n // math.gcd(n, b))]
        return [volumes_with_labels(n, tuple(tr["volume"]), gen), picks]
    return [slices_with_masks(tr["batch_per_chip"], tr["stored_size"],
                              torch.Generator(device=ctx.device).manual_seed(_seed(ctx.seed, 100 + k)))
            for k in range(tr["ring_batches"])]


def ring_batch(ctx, ring: list, k: int):
    """Step ``k``'s data: the next ``batch_per_chip`` volumes in turn, or
    the next batch of slices."""
    if not volumetric(ctx):
        return ring[k % len(ring)]
    (vols, labels), picks = ring
    idx = picks[k % len(picks)]
    return vols.index_select(0, idx), labels.index_select(0, idx)


def he_weights(layout: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """nnU-Net's initialisation from the seed in one draw: every conv and
    transposed conv He normal (``reference/nnunet3d.py::he_std``), biases 0,
    norm scales 1."""
    drawn = [(k, tuple(s)) for k, s in layout.items() if len(s) >= 2]
    numels = [math.prod(s) for _, s in drawn]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(numels), generator=gen, device=device)
    stds = torch.tensor([nnunet3d.he_std(s) for k, s in drawn], device=device)
    flat.mul_(torch.repeat_interleave(stds, torch.tensor(numels, device=device)))
    out = {k: t.view(s) for (k, s), t in zip(drawn, flat.split(numels))}
    for k, s in layout.items():
        if k not in out:
            out[k] = (torch.ones if ".norm" in k and k.endswith(".weight") else torch.zeros)(s, device=device)
    return out


def _task(ctx):
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    dtype = getattr(torch, cfg["dtype"])
    if volumetric(ctx):
        from medical_image_segmentation_tpu_torch.train.seg3d_task import Segmentation3DTask

        task = Segmentation3DTask(
            arch="nnunet3d", n_classes=cfg["classes"], in_channels=cfg["in_channels"], features=cfg["features"],
            learning_rate=cfg["learning_rate"], weight_decay=cfg["weight_decay"], momentum=cfg["momentum"],
            max_epochs=cfg["max_epochs"], steps_per_epoch=cfg["steps_per_epoch"], loss=cfg["loss"], dtype=dtype,
            device=ctx.device)
        weights = he_weights(nnunet3d.layout(cfg), _seed(ctx.seed, 1), ctx.device)
        return task, weights, cfg["start_step"]
    from medical_image_segmentation_tpu_torch.train.segmentation_task import SegmentationTask

    task = SegmentationTask(
        arch=cfg["arch"], n_classes=cfg["classes"], in_channels=cfg["in_channels"],
        learning_rate=tr["learning_rate"], weight_decay=tr["weight_decay"], momentum=tr["momentum"],
        warmup_epochs=tr["warmup_epochs"], max_epochs=tr["max_epochs"], min_lr=tr["min_lr"],
        steps_per_epoch=tr["steps_per_epoch"], loss=tr["loss"], dtype=dtype, device=ctx.device)
    return task, make_weights(unet_layout(cfg), _seed(ctx.seed, 1), ctx.device), tr["start_step"]


def _augment(ctx, gen, data):
    """The program's augmentation of one step's data (looked up at the
    call, where a planted fault may stand)."""
    cfg = ctx.cell.config
    dtype = getattr(torch, cfg["dtype"])
    if volumetric(ctx):
        import medical_image_segmentation_tpu_torch.ops.augment3d as a3

        return a3.segmentation_augment_3d(gen, *data, out_size=tuple(cfg["patch"]), mean=(cfg["mean"],),
                                          std=(cfg["std"],), train=True, dtype=dtype, labels=True)
    import medical_image_segmentation_tpu_torch.ops.augment as a2

    size = cfg["image_size"]
    return a2.segmentation_augment(gen, *data, out_size=(size, size), mean=(cfg["mean"],), std=(cfg["std"],),
                                   train=True, dtype=dtype)


def setup(ctx) -> dict:
    """The task after the set-up steps, and what the comparison reads of
    them."""
    tr = ctx.cell.traffic
    if ctx.device.type == "cuda":
        torch.backends.cudnn.benchmark = True  # as both trainers set it
    task, weights, start = _task(ctx)
    task.model.load_state_dict(weights)
    task.optimizer.state.clear()
    task.step = start
    ring = make_ring(ctx)
    gen = torch.Generator(device=ctx.device).manual_seed(_seed(ctx.seed, 2))
    counter = itertools.count()
    state = {"task": task, "weights": weights, "ring": ring}

    def step(span: bool = False):
        data = ring_batch(ctx, ring, next(counter))
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
    run.samples = n * batch_size(ctx)
    run.trace, run.program = cap.trace, cap.program
    if volumetric(ctx):
        run.flops_per_step = seg_counts.nnunet_train_flops(cfg, batch_size(ctx))
        run.norm_bytes_per_step = seg_counts.instance_norm_fwd_bytes(cfg, batch_size(ctx))
    else:
        run.flops_per_step = seg_counts.unet_train_flops(cfg, batch_size(ctx))


def release(state) -> None:
    """Free the program."""
    state.pop("task", None)
    state.pop("step", None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference(ctx, state, precision: str = "f32") -> dict:
    """The reference's readings of the compared steps."""
    with nets.exact_f32():
        return _reference(ctx, state, precision)


def _reference(ctx, state, precision) -> dict:
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    dtype = getattr(torch, cfg["dtype"])
    gen = torch.Generator(device=ctx.device).manual_seed(_seed(ctx.seed, 2))
    b = batch_size(ctx)
    if volumetric(ctx):
        ref = nnunet3d.ReferenceNNUNet(cfg, state["weights"], cfg["start_step"], precision)
    else:
        ref = seg_step.ReferenceSeg(cfg["arch"], tr, state["weights"], tr["start_step"], precision)
    out = {"losses": []}
    for k in range(COMPARED_STEPS):
        imgs, labels = ring_batch(ctx, state["ring"], k)
        if volumetric(ctx):
            draws = nnunet3d.sample_draws(gen, b, tuple(tr["volume"]), tuple(cfg["patch"]))
            x, y = nnunet3d.augment(draws, imgs, labels, tuple(cfg["patch"]), cfg["mean"], cfg["std"], dtype)
        else:
            draws = seg_step.sample_draws(gen, b)
            x, y = seg_step.augment(draws, imgs, labels, (cfg["image_size"],) * 2, cfg["mean"], cfg["std"], dtype)
        if k == 0:
            out["inputs"] = (x, y)
        loss, grads = ref.loss_and_grads(x, y)
        ref.apply(grads)
        out["losses"].append(float(loss))
        if k == 0:
            coef = float(getattr(ref, "clip_coef", 1.0))  # the gradient as the optimizer got it
            out["grad"] = {n: float(g.norm()) * coef if g is not None else 0.0 for n, g in grads.items()}
    out["change"] = {n: float((ref.P[n] - state["weights"][n]).norm()) for n in out["grad"]}
    return out


def program_readings(state) -> dict:
    return {k: state["obs"][k] for k in ("losses", "grad", "change", "inputs")}


def ulp(v: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp (the configurations' precision) at each of ``v``'s
    magnitudes, those under 1 taken as 1: a normalized value near 0 is the
    difference of two values near 1 and carries their rounding."""
    a = v.float().abs().clamp_min(1.0)
    return torch.finfo(torch.bfloat16).eps * torch.exp2(torch.floor(torch.log2(a)))


def inputs_mismatch(prog, ref) -> float:
    """Image elements more than one bfloat16 ulp from the reference's, and
    label values that differ at all."""
    (x, y), (rx, ry) = prog, ref
    wide = ((x.float() - rx.float()).abs() > ulp(rx)).sum()
    return float(wide + (y.float() != ry.float()).sum())


def numbers(ctx, prog: dict, ref: dict) -> Dict[str, float]:
    out = checks.train_numbers({k: prog[k] for k in ("losses", "grad", "change")}, ref)
    out["inputs_mismatch"] = inputs_mismatch(prog["inputs"], ref["inputs"])
    return out


def compare(ctx, state, precision: str = "f32") -> Dict[str, float]:
    """The compared numbers of this run (the program against the
    reference)."""
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
