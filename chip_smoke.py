#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each printing one line; any failure
exits non-zero and prints no result:

1. device: a CUDA card must be present; prints its name and power limit.
2. build: compiles every hand-written kernel from csrc/.
3. kernel: the fused two-view augmentation kernel against its plain PyTorch
   version on the same parameters, at the trainer's shape (B=256, 256² uint8
   C=1 → two 112² bf16 views) and on C=3, uint16 + CT window, and forced
   flip + solarize. bf16 outputs must agree within 1 ulp (the plain version
   runs in f32 and rounds once), f32 outputs within 1e-5. Times both with
   CUDA events, cold L2.
4. parity: two f32 BYOL steps at a small width on the card against the same
   steps on the CPU: losses within 1e-3 relative, parameters and BatchNorm
   statistics within three times the CPU's own spread under a 1e-6 change
   of the input (see ``run_parity``).
5. seg_parity: the same for two f32 U-Net segmentation steps (resnet18,
   64², batch 4).
6. train: writes a synthetic raw 256² store (2,048 images) and runs the
   BYOL trainer's entry point on it — ResNet-18 at full width (hidden 4096,
   projection 256, batch 256, 256² → 112²), 3 epochs × 8 steps, with the
   final checkpoint. The kernel's launch count must cover every step, the
   loss must be finite and every parameter must have moved but the probe's
   bias, which without labels has no gradient and no decay.
7. step: steady-state BYOL ms/step on a device-resident batch, views from
   the kernel and from the plain version.
8. seg_train: writes paired raw 224² stores (512 train, 128 val, 128 test
   slices with disk masks) and runs the segmentation trainer's entry point
   at full width (resnet18 U-Net, decoder (256,128,64,32,16), batch 64,
   bf16, LARS lr 1.0 / min_lr 1e-2, Dice), 2 epochs × 8 steps, its encoder
   grafted from phase 6's checkpoint. The encoder must start equal to the
   BYOL online backbone, every parameter must move, the loss must be
   finite, val and test Dice/IoU must lie in [0, 1] and the final
   checkpoint must exist.
9. predict: the predict entry point on that checkpoint over 512² raw
   stores: batched on 128 slices, sliding-window (224, 16 windows a slice)
   on 16. Mask counts; batched masks against ``predict_step`` on the same
   resized batch (≥ 99.9% of pixels); on a 224² image the one-window
   sliding-window logits against the plain f32 eval forward (1e-5 of the
   largest logit).
10. seg_step: steady-state segmentation ms/step on a device-resident batch
   (batch 64, 224², bf16), FLOPs per step and the peak device memory.

TF32 is off for both cuDNN and cuBLAS, so every f32 op here is full f32;
the training steps run in bf16 under autocast, which TF32 does not touch.
The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "medical_image_segmentation_tpu_torch"
KERNEL_SOURCE = f"{PKG}/csrc/two_view_augment.cu"
REPLACES = "medical_image_segmentation_tpu/ops/pallas_augment.py:210"


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def phase(tag: str, **fields) -> None:
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def bf16_ulps(a, b) -> int:
    """Largest distance in bf16 units in the last place between two bf16
    tensors (sign-magnitude bit patterns mapped onto a monotone integer line)."""
    import torch

    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i >= 0, i, -(i + 32768))

    return int((ordered(a) - ordered(b)).abs().max())


def cold_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` runs, each after the L2 is
    flushed, from CUDA events around ``fn`` alone."""
    import torch

    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def kernel_cases(torch, dm_mod):
    """(name, images, cfg1, cfg2, mean, std) for the kernel checks."""
    import dataclasses

    import numpy as np

    gen = torch.Generator(device="cuda").manual_seed(0)
    rad = dm_mod.get_datamodule("RADIOLOGY_1M")()
    c1, c2 = rad.view_configs()
    u8 = torch.randint(0, 256, (256, 256, 256, 1), generator=gen, device="cuda", dtype=torch.uint8)
    yield "main", u8, c1, c2, rad.train_mean, rad.train_std
    net = dm_mod.get_datamodule("IMAGENET")()
    n1, n2 = (dataclasses.replace(c, grayscale_prob=0.6, solarize_prob=0.4) for c in net.view_configs())
    rgb = torch.randint(0, 256, (64, 224, 224, 3), generator=gen, device="cuda", dtype=torch.uint8)
    yield "rgb", rgb, n1, n2, net.train_mean, net.train_std
    u16m = dm_mod.get_datamodule("RADIOLOGY_1M_U16")(window_prob=0.7)
    w1, w2 = u16m.view_configs()
    u16 = np.random.default_rng(0).integers(0, 65536, size=(256, 256, 256), dtype=np.uint16)
    yield "u16_window", torch.from_numpy(u16).cuda(), w1, w2, u16m.train_mean, u16m.train_std
    f1, f2 = (dataclasses.replace(c, hflip_prob=1.0, solarize_prob=1.0) for c in (c1, c2))
    yield "flip_solarize", u8, f1, f2, rad.train_mean, rad.train_std


def run_kernel_checks(torch, fa, dm_mod):
    max_err, main_ms, plain_ms = 0.0, None, None
    for name, imgs, cfg1, cfg2, mean, std in kernel_cases(torch, dm_mod):
        b, h, w = imgs.shape[:3]
        gen = torch.Generator(device="cuda").manual_seed(1)
        params = fa.sample_view_params(gen, b, h, w, cfg1, cfg2)
        ref_args = (params, imgs, cfg1.out_size, tuple(mean), tuple(std), cfg1.value_max)
        worst_ulp, err = 0, 0.0
        for dtype in (torch.bfloat16, torch.float32):
            got = fa.fused_two_view_augment(imgs, cfg1, cfg2, mean, std, dtype, params=params)
            want = fa.two_view_augment_reference(*ref_args, dtype=dtype)
            torch.cuda.synchronize()
            for g, r in zip(got, want):
                check(g.shape == r.shape and g.dtype == r.dtype, f"{name}: shape/dtype {g.shape} {r.shape}")
                check(bool(torch.isfinite(g.float()).all()), f"{name}: non-finite kernel output")
                err = max(err, float((g.float() - r.float()).abs().max()))
                if dtype == torch.bfloat16:
                    worst_ulp = max(worst_ulp, bf16_ulps(g, r))
                else:
                    check(float((g - r).abs().max()) <= 1e-5, f"{name}: f32 outputs differ beyond 1e-5")
        check(worst_ulp <= 1, f"{name}: kernel and plain version differ by {worst_ulp} bf16 ulp")
        max_err = max(max_err, err)
        fields = dict(case=name, shape=tuple(imgs.shape), dtype=str(imgs.dtype).replace("torch.", ""),
                      max_bf16_ulp=worst_ulp, max_abs_err=err)
        if name == "main":
            main_ms = cold_ms(lambda: fa.fused_two_view_augment(
                imgs, cfg1, cfg2, mean, std, torch.bfloat16, params=params), 20)
            plain_ms = cold_ms(lambda: fa.two_view_augment_reference(*ref_args, dtype=torch.bfloat16), 5)
            fields.update(kernel_ms=main_ms, plain_ms=plain_ms)
        phase("kernel", **fields)
    return max_err, main_ms, plain_ms


def step_parity(tag: str, train, device: str) -> None:
    """Two f32 training steps at a small width, card against CPU, from the
    same weights and batches. ``train(device, scale)`` takes the steps with
    the first input scaled by ``scale`` and returns (losses, CPU state dict,
    parameter names).

    Parameters and BatchNorm statistics are compared per group by max|a-b|
    over max|a|. The step is badly conditioned at this size: a constant
    shift before a BatchNorm changes nothing, so the gradients of BatchNorm
    biases and scales are differences of nearly equal terms, and rounding
    moves them by several per cent. The CPU's own spread is measured by
    running it again with the input scaled by (1 + 1e-6); the card is held
    to three times that, and never looser than 1e-3 is needed.
    """

    def group_err(a, b, keys):
        return (max(float((a[k] - b[k]).abs().max()) for k in keys)
                / max(float(b[k].abs().max()) for k in keys))

    cpu_losses, cpu_sd, names = train("cpu", 1.0)
    _, spread_sd, _ = train("cpu", 1.0 + 1e-6)
    card_losses, card_sd, _ = train(device, 1.0)
    loss_rel = max(abs(a - b) / abs(a) for a, b in zip(cpu_losses, card_losses))
    fields = dict(steps=len(card_losses), loss_rel=loss_rel, losses=card_losses)
    for group, keys in (("params", names), ("bn_stats", set(cpu_sd) - names)):
        err, spread = group_err(card_sd, cpu_sd, keys), group_err(spread_sd, cpu_sd, keys)
        check(err <= max(1e-3, 3 * spread), f"{tag}: card/CPU step parity: {group} {err} (CPU spread {spread})")
        fields.update({f"{group}_rel": err, f"{group}_cpu_spread": spread})
    check(loss_rel <= 1e-3, f"{tag}: card/CPU step parity: loss rel {loss_rel}")
    phase(tag, **fields)


def run_parity(torch, device: str = "cuda"):
    """BYOL (resnet18, hidden 64, 8 two-view pairs of 64²)."""
    from medical_image_segmentation_tpu_torch.train.byol_task import BYOLTask

    kw = dict(arch="resnet18", in_channels=1, hidden_dim=64, proj_dim=32, learning_rate=0.1, warmup_epochs=0,
              max_epochs=2, total_steps=2, dtype=torch.float32)
    gen = torch.Generator().manual_seed(2)
    pairs = [(torch.randn(8, 64, 64, 1, generator=gen), torch.randn(8, 64, 64, 1, generator=gen))
             for _ in range(2)]

    def train(dev, scale):
        task = BYOLTask(device=dev, **kw)
        task.init(0)
        losses = [float(task.train_step((v1 * scale).to(dev), v2.to(dev))["loss"]) for v1, v2 in pairs]
        names = {k for k, _ in task.online.named_parameters()}
        return losses, {k: v.detach().cpu() for k, v in task.online.state_dict().items()}, names

    step_parity("parity", train, device)


def disk_slices(rng, n: int, size: int):
    """(uint8 (size, size) image, 0/1 uint8 mask) pairs: a bright disk of
    random centre and radius on noise."""
    import numpy as np

    yy, xx = np.mgrid[:size, :size]
    for _ in range(n):
        cy, cx = rng.integers(size // 4, 3 * size // 4, 2)
        r = rng.integers(size // 10, size // 4)
        m = ((yy - cy) ** 2 + (xx - cx) ** 2 <= r * r).astype(np.uint8)
        yield np.clip(rng.normal(70, 25, (size, size)) + 110 * m, 0, 255).astype(np.uint8), m


def run_seg_parity(torch, device: str = "cuda"):
    """U-Net segmentation (resnet18, 64², batch 4, Dice)."""
    import numpy as np

    from medical_image_segmentation_tpu_torch.train.segmentation_task import SegmentationTask

    kw = dict(arch="resnet18", learning_rate=0.5, warmup_epochs=0, max_epochs=2, min_lr=0.01, steps_per_epoch=1,
              dtype=torch.float32)
    rng = np.random.default_rng(4)
    batches = []
    for _ in range(2):
        imgs, masks = zip(*disk_slices(rng, 4, 64))
        x = (np.stack(imgs)[..., None].astype(np.float32) - 110.0) / 60.0
        batches.append((torch.from_numpy(x), torch.from_numpy(np.stack(masks)[..., None].astype(np.float32))))

    def train(dev, scale):
        task = SegmentationTask(device=dev, **kw)
        task.init(0)
        losses = [float(task.train_step((x * scale).to(dev), m.to(dev))["train/loss"]) for x, m in batches]
        names = {k for k, _ in task.model.named_parameters()}
        return losses, {k: v.detach().cpu() for k, v in task.model.state_dict().items()}, names

    step_parity("seg_parity", train, device)


def write_store(path: str, n: int, size: int) -> None:
    import numpy as np

    from medical_image_segmentation_tpu_torch.data.store import CODEC_RAW, StoreWriter

    rng = np.random.default_rng(0)
    with StoreWriter(path, channels=1) as w:
        for _ in range(n):
            w.add(rng.integers(0, 256, size=(size, size, 1), dtype=np.uint8), codec=CODEC_RAW)


def run_trainer(torch, fa, workdir: str, card: str):
    from medical_image_segmentation_tpu_torch.models.byol import BYOLNet
    from medical_image_segmentation_tpu_torch.train import train_ssl

    store = os.path.join(workdir, "radiology_smoke.mis")
    t0 = time.time()
    write_store(store, 2048, 256)
    os.environ["RADIOLOGY_1M_TRAIN_STORE"] = store
    os.environ["RADIOLOGY_1M_VAL_STORE"] = os.path.join(workdir, "absent.mis")
    epochs, steps = 3, 8
    argv = ["--device", "cuda", "--dataset", "RADIOLOGY_1M", "--arch", "resnet18",
            "--hidden_dim", "4096", "--projection_dim", "256", "--batch_size", "256",
            "--max_epochs", str(epochs), "--limit_steps_per_epoch", str(steps),
            "--warmup_epochs", "0", "--checkpoint_every_epochs", str(epochs), "--val_every_epochs", "0",
            "--num_workers", "8", "--seed", "0", "--log_dir", os.path.join(workdir, "logs"),
            "--checkpoint_dir", os.path.join(workdir, "ssl")]
    setup_s = time.time() - t0
    fa.fused_two_view_augment.launches = 0
    t0 = time.time()
    result = train_ssl.run(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = fa.fused_two_view_augment.launches
    task = result.task
    n_steps = epochs * steps
    check(result.used_kernel, "trainer did not route the views through the fused kernel")
    check(task.step == n_steps, f"trainer ran {task.step} steps, expected {n_steps}")
    check(launches >= n_steps, f"kernel launched {launches} times for {n_steps} steps")
    losses = [e["loss"] for e in result.epochs]
    check(all(math.isfinite(x) and 0.0 <= x <= 4.0 for x in losses), f"bad losses {losses}")
    init = BYOLNet("resnet18", 1, False, 4096, 256, 10)
    init.reset_parameters(torch.Generator().manual_seed(0))
    init_sd = init.state_dict()
    still = [name for name, p in task.online.named_parameters() if torch.equal(p.detach().cpu(), init_sd[name])]
    n_params = len(list(task.online.parameters()))
    moved = n_params - len(still)
    # RADIOLOGY_1M has no train labels: the probe gets no gradient, its
    # weight moves only by decay and its bias (rank 1, not decayed) stays
    check(set(still) <= {"probe.bias"}, f"parameters that did not move: {still}")
    ckpt = os.path.join(workdir, "ssl", f"{n_steps}.pt")
    check(os.path.exists(ckpt), f"no final BYOL checkpoint {ckpt}")
    steady = result.epochs[1:]
    ms_step = 1000.0 * sum(e["seconds"] for e in steady) / sum(e["steps"] for e in steady)
    phase("train", steps=task.step, launches=launches, losses=losses, params_moved=f"{moved}/{n_params}",
          store_setup_s=round(setup_s, 2), wall_s=round(wall, 2),
          steady_ms_per_step=ms_step, steady_img_per_s=256 * 1000.0 / ms_step, card=repr(card))
    return task, launches, ckpt


def run_step_timing(torch, fa, task, card: str):
    """Device-only aug+train step time on a resident batch (no loader)."""
    from medical_image_segmentation_tpu_torch.data.datamodules import get_datamodule

    dm = get_datamodule("RADIOLOGY_1M")()
    cfg1, cfg2 = dm.view_configs()
    gen = torch.Generator(device="cuda").manual_seed(3)
    imgs = torch.randint(0, 256, (256, 256, 256, 1), generator=gen, device="cuda", dtype=torch.uint8)
    mean, std = tuple(dm.train_mean), tuple(dm.train_std)

    def kernel_views():
        return fa.fused_two_view_augment(imgs, cfg1, cfg2, mean, std, torch.bfloat16, generator=gen)

    def plain_views():
        params = fa.sample_view_params(gen, 256, 256, 256, cfg1, cfg2)
        return fa.two_view_augment_reference(params, imgs, cfg1.out_size, mean, std, cfg1.value_max)

    out = {}
    for name, views in (("kernel", kernel_views), ("plain", plain_views), ("kernel2", kernel_views)):
        for _ in range(3):
            task.train_step(*views())
        torch.cuda.synchronize()
        t0 = time.time()
        n = 20
        for _ in range(n):
            m = task.train_step(*views())
        check(math.isfinite(float(m["loss"])), "non-finite loss in the timed steps")
        out[name] = 1000.0 * (time.time() - t0) / n
    phase("step", batch=256, ms_step_kernel_views=out["kernel"], ms_step_kernel_views_again=out["kernel2"],
          ms_step_plain_views=out["plain"], img_per_s_kernel=256 * 1000.0 / out["kernel"],
          max_mem_gib=torch.cuda.max_memory_allocated() / 2**30, card=repr(card))


def write_seg_stores(prefix: str, sizes, size: int, seed: int = 0) -> None:
    """Paired raw stores ``<prefix>_<split>_{images,masks}.mis`` of disk
    slices, ``sizes`` mapping split → count."""
    import numpy as np

    from medical_image_segmentation_tpu_torch.data.store import CODEC_RAW, StoreWriter

    rng = np.random.default_rng(seed)
    for split, n in sizes.items():
        with StoreWriter(f"{prefix}_{split}_images.mis", channels=1) as wi, \
                StoreWriter(f"{prefix}_{split}_masks.mis", channels=1) as wm:
            for img, m in disk_slices(rng, n, size):
                wi.add(img[..., None], codec=CODEC_RAW)
                wm.add(m[..., None], codec=CODEC_RAW)


# The segmentation phases run the JAX CLI's defaults at full width
# (``train/train_segmentation.py:38-75``: resnet18 U-Net, 224², batch 64,
# bf16, LARS lr 1.0 / min_lr 1e-2, Dice) on synthetic disk slices.
SEG_DATASET = "DECATHLON_LIVER"
SEG_DEVICE = "cuda"
SEG_SIZE, SEG_BATCH = 224, 64
SEG_SPLITS = {"train": 512, "val": 128, "test": 128}
SEG_EPOCHS, SEG_STEPS = 2, 8
PREDICT_SIZE, PREDICT_SLICES, SLIDING_SLICES = 512, 128, 16  # 16 windows of 224 per 512² slice


def run_seg_train(torch, workdir: str, ssl_ckpt: str, card: str) -> str:
    """The segmentation trainer at full width, its encoder grafted from the
    BYOL checkpoint; returns the final checkpoint's path."""
    from medical_image_segmentation_tpu_torch.train import train_segmentation

    prefix = os.path.join(workdir, "seg")
    t0 = time.time()
    write_seg_stores(prefix, SEG_SPLITS, SEG_SIZE)
    setup_s = time.time() - t0
    argv = ["--device", SEG_DEVICE, "--dataset", SEG_DATASET, "--images_dir", workdir, "--masks_dir", workdir,
            "--seg_store_prefix", prefix, "--arch", "resnet18", "--batch_size", str(SEG_BATCH),
            "--image_size", str(SEG_SIZE), "--max_epochs", str(SEG_EPOCHS),
            "--limit_steps_per_epoch", str(SEG_STEPS), "--warmup_epochs", "0", "--num_workers", "8", "--seed", "0",
            "--ssl_checkpoint", ssl_ckpt, "--checkpoint_dir", os.path.join(workdir, "seg_ckpt"),
            "--log_dir", os.path.join(workdir, "seg_logs")]
    t0 = time.time()
    result = train_segmentation.run(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0

    online = torch.load(ssl_ckpt, map_location="cpu", weights_only=True)["online"]
    enc = [k for k in result.start_state if k.startswith("encoder.")]
    grafted = [k for k in enc if torch.equal(result.start_state[k], online["encoder.backbone." + k[len("encoder."):]])]
    check(enc and len(grafted) == len(enc), f"encoder after the graft: {len(grafted)}/{len(enc)} equal to BYOL online")
    task = result.task
    n_steps = SEG_EPOCHS * SEG_STEPS
    check(task.step == n_steps and not result.stopped, f"seg trainer ran {task.step} steps, expected {n_steps}")
    losses = [e["loss"] for e in result.epochs]
    check(len(losses) == SEG_EPOCHS and all(math.isfinite(x) and 0.0 <= x <= 1.0 for x in losses),
          f"bad losses {losses}")
    params = dict(task.model.named_parameters())
    still = [k for k, p in params.items() if torch.equal(p.detach().cpu(), result.start_state[k])]
    check(not still, f"parameters that did not move: {still}")
    metrics = {**result.val, **result.test}
    check(len(metrics) == 6 and all(0.0 <= v <= 1.0 for v in metrics.values()), f"bad val/test metrics {metrics}")
    check(os.path.exists(result.checkpoint) and result.checkpoint.endswith(f"{n_steps}.pt"),
          f"no final checkpoint ({result.checkpoint})")
    steady = result.epochs[1:]
    ms_step = 1000.0 * sum(e["seconds"] for e in steady) / sum(e["steps"] for e in steady)
    phase("seg_train", steps=task.step, losses=losses, grafted=f"{len(grafted)}/{len(enc)}",
          params_moved=f"{len(params) - len(still)}/{len(params)}",
          **{k.replace("/", "_"): v for k, v in metrics.items()}, store_setup_s=round(setup_s, 2),
          wall_s=round(wall, 2), steady_ms_per_step=ms_step, steady_img_per_s=SEG_BATCH * 1000.0 / ms_step,
          card=repr(card))
    return result.checkpoint


def run_predict(torch, workdir: str, ckpt: str, card: str) -> None:
    """The predict entry point in both modes on the trained checkpoint."""
    import numpy as np

    from medical_image_segmentation_tpu_torch.data.datamodules import get_datamodule
    from medical_image_segmentation_tpu_torch.data.store import CODEC_RAW, StoreWriter
    from medical_image_segmentation_tpu_torch.eval.sliding_window import count_windows, sliding_window_predict
    from medical_image_segmentation_tpu_torch.serve import normalize_u8
    from medical_image_segmentation_tpu_torch.train import predict
    from medical_image_segmentation_tpu_torch.train.segmentation_task import SegmentationTask
    from medical_image_segmentation_tpu_torch.utils.png import decode_png

    n_win = count_windows(PREDICT_SIZE, PREDICT_SIZE, SEG_SIZE)
    check(n_win == 16, f"a {PREDICT_SIZE}² slice takes {n_win} windows of {SEG_SIZE}, expected 16")
    slices = [img for img, _ in disk_slices(np.random.default_rng(1), PREDICT_SLICES, PREDICT_SIZE)]
    counts = {"batched": PREDICT_SLICES, "sliding": SLIDING_SLICES}
    base = ["--checkpoint", os.path.dirname(ckpt), "--device", SEG_DEVICE, "--dataset", SEG_DATASET,
            "--image_size", str(SEG_SIZE), "--batch_size", str(SEG_BATCH), "--num_workers", "8"]
    summaries = {}
    for mode, extra in (("batched", []), ("sliding", ["--sliding_window", str(SEG_SIZE)])):
        store, out_dir = os.path.join(workdir, f"predict_{mode}.mis"), os.path.join(workdir, f"masks_{mode}")
        with StoreWriter(store, channels=1) as w:
            for img in slices[:counts[mode]]:
                w.add(img[..., None], codec=CODEC_RAW)
        summaries[mode] = predict.run(base + ["--image_store", store, "--output_dir", out_dir, *extra])
        files = sorted(os.listdir(out_dir))
        check(summaries[mode]["images"] == counts[mode] and files == [f"{i:08d}_mask.png" for i in range(counts[mode])],
              f"{mode}: {len(files)} masks for {counts[mode]} slices")

    # the batched masks against predict_step on the same resized batches
    dm = get_datamodule(SEG_DATASET)()
    task = SegmentationTask(device=SEG_DEVICE)
    task.model.load_state_dict(torch.load(ckpt, map_location=SEG_DEVICE, weights_only=True)["model"])
    agree, on = [], []
    for s in range(0, PREDICT_SLICES, SEG_BATCH):
        batch = np.stack([predict._resize_nearest(img, (SEG_SIZE, SEG_SIZE)) for img in slices[s:s + SEG_BATCH]])
        x = normalize_u8(torch.from_numpy(batch[..., None]).to(SEG_DEVICE), dm.mean, dm.std)
        ref = task.predict_step(x).cpu().numpy()[..., 0]
        for j, mask in enumerate(ref):
            with open(os.path.join(workdir, "masks_batched", f"{s + j:08d}_mask.png"), "rb") as f:
                got = decode_png(f.read())
            agree.append(float((got == predict._resize_nearest(mask, got.shape) * 255).mean()))
            on.append(float(got.mean() / 255))
    check(min(agree) >= 0.999, f"batched masks agree with predict_step on {min(agree):.5f} of pixels")

    # one window of the sliding path is the plain f32 eval forward (both at
    # batch 1: a convolution may sum in another order at another batch)
    task32 = SegmentationTask(device=SEG_DEVICE, dtype=torch.float32)
    task32.model.load_state_dict(task.model.state_dict())
    img = predict._resize_nearest(slices[0], (SEG_SIZE, SEG_SIZE))
    x = normalize_u8(torch.from_numpy(img[..., None]).to(SEG_DEVICE), dm.mean, dm.std)
    got = sliding_window_predict(task32.logits, x, SEG_SIZE, batch_windows=1)
    want = task32.logits(x[None])[0]
    one_window_rel = float((got - want).abs().max() / want.abs().max())
    check(one_window_rel <= 1e-5, f"one-window sliding logits differ from the forward by {one_window_rel} rel")

    rates = {f"{k}_img_per_s": v["images"] / v["seconds"] for k, v in summaries.items()}
    phase("predict", batched_slices=PREDICT_SLICES, sliding_slices=SLIDING_SLICES, windows_per_slice=n_win,
          min_pixel_agreement=min(agree), mask_on_share=float(np.mean(on)), one_window_rel=one_window_rel,
          **rates, card=repr(card))


def run_seg_step(torch, card: str) -> None:
    """Device-resident segmentation aug+train step time at full width, the
    FLOPs of one step (``FlopCounterMode``) and the peak device memory."""
    import numpy as np
    from torch.utils.flop_counter import FlopCounterMode

    from medical_image_segmentation_tpu_torch.data.datamodules import get_datamodule
    from medical_image_segmentation_tpu_torch.ops.augment import segmentation_augment
    from medical_image_segmentation_tpu_torch.train.segmentation_task import SegmentationTask

    dm = get_datamodule(SEG_DATASET)()
    imgs, masks = (np.stack(a)[..., None] for a in zip(*disk_slices(np.random.default_rng(2), SEG_BATCH, SEG_SIZE)))
    imgs = torch.from_numpy(imgs).to(SEG_DEVICE)
    masks = torch.from_numpy(masks.astype(np.float32)).to(SEG_DEVICE)
    task = SegmentationTask(device=SEG_DEVICE, warmup_epochs=0, max_epochs=100, steps_per_epoch=10)
    task.init(0)
    gen = torch.Generator(device=SEG_DEVICE).manual_seed(3)

    def augment():
        return segmentation_augment(gen, imgs, masks, (SEG_SIZE, SEG_SIZE), dm.mean, dm.std, train=True)

    x, y = augment()
    with FlopCounterMode(display=False) as flops:
        task.train_step(x, y)
    step_tflop = flops.get_total_flops() / 1e12

    def event_ms(fn, n: int = 20) -> float:
        for _ in range(3):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n

    torch.cuda.reset_peak_memory_stats()
    ms = {"aug_step": event_ms(lambda: task.train_step(*augment())),
          "step": event_ms(lambda: task.train_step(x, y)),
          "aug": event_ms(augment),
          "aug_step_again": event_ms(lambda: task.train_step(*augment()))}
    check(math.isfinite(float(task.train_step(x, y)["train/loss"])), "non-finite loss in the timed steps")
    phase("seg_step", batch=SEG_BATCH, size=SEG_SIZE, **{f"ms_{k}": v for k, v in ms.items()},
          img_per_s=SEG_BATCH * 1000.0 / ms["aug_step"], step_tflop=step_tflop,
          tflop_per_s=step_tflop / ms["step"] * 1000.0, max_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
          card=repr(card))


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, PKG)):
        print(f"FAIL: {PKG}/ is not beside chip_smoke.py; run it from a checkout of the repo", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi: no output"
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    phase("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda, tf32="off", card=repr(card))

    from medical_image_segmentation_tpu_torch.data import datamodules as dm_mod
    from medical_image_segmentation_tpu_torch.ops import _kernels
    from medical_image_segmentation_tpu_torch.ops import fused_augment as fa

    try:
        t0 = time.time()
        so = _kernels.build_kernel("two_view_augment")
        with open(so[:-3] + ".log") as f:
            ptxas = " | ".join(ln.strip() for ln in f if "registers" in ln or "spill" in ln)
        phase("build", kernel="two_view_augment", seconds=round(time.time() - t0, 2), ptxas=ptxas or "(cached)")
        max_err, kernel_ms, plain_ms = run_kernel_checks(torch, fa, dm_mod)
        run_parity(torch)
        run_seg_parity(torch)
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as workdir:
            task, launches, ssl_ckpt = run_trainer(torch, fa, workdir, card)
            run_step_timing(torch, fa, task, card)
            del task
            seg_ckpt = run_seg_train(torch, workdir, ssl_ckpt, card)
            run_predict(torch, workdir, seg_ckpt, card)
        run_seg_step(torch, card)
        check("jax" not in sys.modules, "the port imported jax")
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1

    print(card)
    print(json.dumps({"kernels": [{
        "name": "two_view_augment", "route": "cuda", "source": KERNEL_SOURCE, "replaces": REPLACES,
        "launches": launches, "max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
