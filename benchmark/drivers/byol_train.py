"""BYOL pretraining traffic: the augmentation kernel and the train step of
the program, fed from a ring of ``ring_batches`` seeded CT-like uint8
batches resident on the card (the loader bypassed).

Each step is what ``train_ssl.py`` runs: ``fused_two_view_augment`` on the
batch, then ``BYOLTask.train_step`` on the two views (no labels: the
RADIOLOGY_1M store has none). With several ranks each takes its rows of
the global batch and of the global batch's draws.

Set-up builds the task, loads weights made from the seed, and drives it
through ``setup_steps`` steps of the window's own call and feed, which
also warm up every shape. The same task goes on into the window. After
the window the program is freed and the reference (``reference/byol.py``,
float32, TF32 off) follows the first three steps from the same weights, on
the same images and redrawn augmentation draws, and keeps the online
network's BatchNorm running statistics as the program's are kept.
"""

from __future__ import annotations

import gc
import itertools
import time
from typing import Dict

import torch

from benchmark.harness import checks, counts, record, trace
from benchmark.harness.record import log
from benchmark.harness.ct_like import ct_like
from benchmark.harness.weights import make_weights
from benchmark.reference import augment as ref_aug
from benchmark.reference import nets
from benchmark.reference.byol import ReferenceBYOL
from benchmark.reference.layouts import byol_layouts

COMPARED_STEPS = 3


def _seed(seed: int, k: int) -> int:
    return (seed * 1000003 + k) % (1 << 62)


def global_batch(ctx) -> int:
    return ctx.cell.config["batch_per_chip"] * ctx.world


def rows(ctx) -> slice:
    per = ctx.cell.config["batch_per_chip"]
    return slice(ctx.rank * per, (ctx.rank + 1) * per)


def ring_batch(ctx, k: int) -> torch.Tensor:
    """Batch ``k`` of the resident ring: this rank's rows of a global batch
    drawn from the seed."""
    cfg = ctx.cell.config
    gen = torch.Generator(device=ctx.device).manual_seed(_seed(ctx.seed, 100 + k))
    return ct_like(global_batch(ctx), cfg["image_size"], gen)[rows(ctx)].contiguous()


def _program_views(cfg: dict):
    from medical_image_segmentation_tpu_torch.ops.augment import ViewConfig

    return tuple(ViewConfig(**{**v, "crop_scale": tuple(v["crop_scale"]), "crop_ratio": tuple(v["crop_ratio"])})
                 for v in ref_aug.view_configs(cfg))


def setup(ctx) -> dict:
    """The task after the set-up steps, and what the comparison reads of
    them."""
    from medical_image_segmentation_tpu_torch.ops.fused_augment import fused_two_view_augment
    from medical_image_segmentation_tpu_torch.train.byol_task import BYOLTask

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    if ctx.device.type == "cuda":
        torch.backends.cudnn.benchmark = True  # as train_ssl.py sets it
    task = BYOLTask(
        arch=cfg["arch"], in_channels=cfg["in_channels"], low_res=False, hidden_dim=cfg["hidden_dim"],
        proj_dim=cfg["proj_dim"], num_classes=cfg["num_classes"], learning_rate=cfg["learning_rate"],
        weight_decay=cfg["weight_decay"], momentum=cfg["momentum"], warmup_epochs=cfg["warmup_epochs"],
        max_epochs=cfg["max_epochs"], base_ema_momentum=cfg["base_ema"], final_ema_momentum=cfg["final_ema"],
        total_steps=cfg["steps_per_epoch"] * cfg["max_epochs"], steps_per_epoch=cfg["steps_per_epoch"],
        dtype=getattr(torch, cfg["dtype"]), device=ctx.device, mesh=ctx.mesh,
    )
    online_l, target_l = byol_layouts(cfg)
    weights = make_weights(online_l, _seed(ctx.seed, 1), ctx.device)
    target_w = {k: weights[f"encoder.{k}"] for k in target_l}
    task.online.load_state_dict(weights)
    task.target.load_state_dict(target_w)
    task.optimizer.state.clear()
    task.step = cfg["start_step"]
    cfg1, cfg2 = _program_views(cfg)
    mean, std = tuple(cfg["train_mean"]), tuple(cfg["train_std"])
    gen = torch.Generator(device=ctx.device).manual_seed(_seed(ctx.seed, 2))
    shard = (ctx.rank, ctx.world)
    state = {"task": task, "weights": weights, "target_weights": target_w}
    ring = itertools.cycle([ring_batch(ctx, k) for k in range(tr["ring_batches"])])

    def step(span: bool = False):
        imgs = next(ring)
        with trace.span(span, "augment"):
            v1, v2 = fused_two_view_augment(imgs, cfg1, cfg2, mean, std, task.dtype, generator=gen, shard=shard)
        with trace.span(span, "train_step"):
            out = task.train_step(v1, v2)
        return out, v1, v2

    state["step"] = step
    names = [n for n, _ in task.online.named_parameters()]
    obs = {"losses": []}
    for i in range(tr["setup_steps"]):
        out, v1, v2 = step()
        if i < COMPARED_STEPS:
            obs["losses"].append(out["loss"])
        if i == 0:
            obs["views"] = (v1, v2)
            obs["grad"] = torch.stack([p.grad.norm() if p.grad is not None else torch.zeros((), device=ctx.device)
                                       for p in task.online.parameters()])
        if i == COMPARED_STEPS - 1:
            obs["change"] = torch.stack([(p.detach() - weights[n]).norm()
                                         for n, p in task.online.named_parameters()])
            buffers = dict(task.online.named_buffers())
            obs["bn"] = {n[:-len(".running_mean")]: (b.detach().clone(),
                                                     buffers[n.replace("running_mean", "running_var")].detach().clone())
                         for n, b in buffers.items() if n.endswith(".running_mean")}
    record.sync(ctx.device)
    obs["losses"] = [float(x) for x in obs["losses"]]
    obs["grad"] = dict(zip(names, obs["grad"].tolist()))
    obs["change"] = dict(zip(names, obs["change"].tolist()))
    state["obs"] = obs
    return state


def window(ctx, state, run: record.Run) -> None:
    """Steps back to back for ``ctx.seconds``, ending in a synchronize."""
    cfg = ctx.cell.config
    step = state["step"]
    if ctx.group is not None:
        _barrier(ctx)
    record.sync(ctx.device)
    run.setup_s = time.time() - ctx.t_start
    n = 0
    with trace.capture(ctx.trace) as cap:
        with trace.span(ctx.trace, "window"):
            stopper = record.Stopper(ctx.seconds, ctx.device, ctx.group)
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
    run.samples = n * global_batch(ctx)
    run.trace = cap.trace
    run.flops_per_step = counts.byol_step_flops(cfg, global_batch(ctx))
    if ctx.trace:
        run.kernel_bytes_per_launch = window_kernel_bytes(ctx, n) / n


def window_kernel_bytes(ctx, steps: int) -> int:
    """The bytes the augmentation kernel needs over the window's launches
    on this rank's rows: the draws redrawn from the seed past the set-up's
    (``counts.two_view_augment_bytes``)."""
    cfg = ctx.cell.config
    c1, c2 = ref_aug.view_configs(cfg)
    gen = torch.Generator(device=ctx.device).manual_seed(_seed(ctx.seed, 2))
    shape = (cfg["batch_per_chip"], cfg["image_size"], cfg["image_size"], cfg["in_channels"])
    total = 0
    for k in range(ctx.cell.traffic["setup_steps"] + steps):
        params = ref_aug.sample_view_params(gen, global_batch(ctx), cfg["image_size"], cfg["image_size"], c1, c2)
        if k >= ctx.cell.traffic["setup_steps"]:
            total += counts.two_view_augment_bytes(params[rows(ctx)], shape, (cfg["crop_size"],) * 2)
    return total


def _barrier(ctx) -> None:
    import torch.distributed as dist

    dist.broadcast(torch.zeros(1, device=ctx.device), src=0, group=ctx.group)
    record.sync(ctx.device)


def release(state) -> None:
    """Free the program."""
    state.pop("task", None)
    state.pop("step", None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference(ctx, state, precision: str = "f32") -> dict:
    """The reference's readings of the compared steps (``precision``: see
    ``reference/nets.py``)."""
    with nets.exact_f32():
        return _reference(ctx, state, precision)


def _reference(ctx, state, precision) -> dict:
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    images = [ring_batch(ctx, k % tr["ring_batches"]) for k in range(COMPARED_STEPS)]
    c1, c2 = ref_aug.view_configs(cfg)
    gen = torch.Generator(device=ctx.device).manual_seed(_seed(ctx.seed, 2))
    ref = ReferenceBYOL(cfg, state["weights"], state["target_weights"], cfg["start_step"], ctx.group, precision)
    out = {"losses": []}
    for k, imgs in enumerate(images):
        params = ref_aug.sample_view_params(gen, global_batch(ctx), cfg["image_size"], cfg["image_size"], c1, c2)
        v1, v2 = ref_aug.two_view_views(params[rows(ctx)], imgs, (cfg["crop_size"],) * 2,
                                        tuple(cfg["train_mean"]), tuple(cfg["train_std"]), c1["value_max"])
        if k == 0:
            out["views"] = (v1, v2)
        loss, grads = ref.train_step(v1, v2)
        out["losses"].append(float(loss))
        if k == 0:
            out["grad"] = {n: float(g.norm()) if g is not None else 0.0 for n, g in grads.items()}
    out["change"] = {n: float((ref.online[n].detach() - state["weights"][n]).norm()) for n in ref.params}
    out["bn"] = {k: (ref.online[f"{k}.running_mean"], ref.online[f"{k}.running_var"]) for k in ref.bn_stats}
    out["bn_batch_var"] = {k: v for k, (_, v) in ref.bn_stats.items()}
    out["bn_share"] = 1.0 - cfg["bn_momentum"] ** len(images)
    return out


def program_readings(state) -> dict:
    return {k: state["obs"][k] for k in ("losses", "grad", "change", "views", "bn")}


def compare(ctx, state, precision: str = "f32") -> Dict[str, float]:
    """The compared numbers of this run (the program against the
    reference)."""
    ref = reference(ctx, state, precision)
    return checks.train_numbers(program_readings(state), ref)


def control_numbers(ctx, state) -> Dict[str, float]:
    """The control: the reference at the precision below the
    configuration's (float8 operands) put in the program's place."""
    ref = reference(ctx, state)
    low = reference(ctx, state, "fp8")
    # the views too are made in float8, as a kernel that wrote them so would
    low["views"] = tuple(nets.round_fp8(v).to(getattr(torch, ctx.cell.config["dtype"])) for v in low["views"])
    return checks.train_numbers(low, ref)


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

