"""BYOL self-supervised pretraining entry point (``mis-train-ssl-torch``).

Port of ``train/train_ssl.py``: the same flag surface and defaults, plus an
explicit ``--device`` (default ``cuda``). A CUDA run never drops to the CPU
by itself: asking for ``cuda`` without one raises.

Per step: the shared C++ ``Loader`` decodes a uint8 (or uint16) batch on
host threads → ``data/device_feed.py`` copies it to the device one batch
ahead → the two-view augmentation makes both views on the device → one
``BYOLTask.train_step`` (online fwd/bwd, target fwd, LARS, EMA).

Augmentation routing is the JAX trainer's (``train_ssl.py:263-294``): on
CUDA, configs whose every enabled augmentation the fused kernel implements
take it; blur/jitter recipes, uint16 stores and the CPU take the plain
``ops/augment.py::two_view_augment``.

Not ported yet (each flag raises when set away from its default):
``--resume``, ``--model_parallel > 1``, ``--remat``, ``--host_precrop``,
``--knn_every_epochs > 0``, ``--profile``, ``--run_single_validation``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from medical_image_segmentation_tpu.core.metrics_logger import CSVMetricsLogger
from medical_image_segmentation_tpu_torch.core.checkpoint import save_checkpoint
from medical_image_segmentation_tpu_torch.data.datamodules import get_datamodule
from medical_image_segmentation_tpu_torch.data.device_feed import device_batches
from medical_image_segmentation_tpu_torch.ops.augment import two_view_augment
from medical_image_segmentation_tpu_torch.ops.fused_augment import fused_supported, fused_two_view_augment
from medical_image_segmentation_tpu_torch.train.byol_task import BYOLTask


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="BYOL SSL pretraining (PyTorch/CUDA port)")
    ap.add_argument("--dataset", default="CIFAR10")
    ap.add_argument("--batch_size", type=int, default=256)
    ap.add_argument("--learning_rate", type=float, default=1.0)
    ap.add_argument("--weight_decay", type=float, default=1e-6)
    ap.add_argument("--warmup_epochs", type=int, default=10,
                    help="linear warmup from lr 0: with warmup, step 0 has lr = 0")
    ap.add_argument("--max_epochs", type=int, default=100)
    ap.add_argument("--projection_dim", type=int, default=256)
    ap.add_argument("--hidden_dim", type=int, default=4096)
    ap.add_argument("--base_momentum", type=float, default=0.99)
    ap.add_argument("--final_momentum", type=float, default=1.0)
    ap.add_argument("--arch", default="resnet18")
    ap.add_argument("--num_workers", type=int,
                    default=int(os.environ.get("SLURM_CPUS_PER_TASK", os.cpu_count() or 4)))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device; cuda raises if absent")
    ap.add_argument("--log_dir", default="logs")
    ap.add_argument("--checkpoint_dir", default="checkpoints/ssl")
    ap.add_argument("--resume", action="store_true", help="not ported yet")
    ap.add_argument("--checkpoint_every_epochs", type=int, default=1)
    ap.add_argument("--val_every_epochs", type=int, default=1)
    ap.add_argument("--knn_every_epochs", type=int, default=0, help="0 disables the KNN probe (not ported yet)")
    ap.add_argument("--knn_bank_size", type=int, default=262144, help="KNN bank cap (KNN not ported yet)")
    ap.add_argument("--knn_bank_chunk", type=int, default=65536, help="KNN chunk (KNN not ported yet)")
    ap.add_argument("--val_full_image", action="store_true",
                    help="validate on full stored images (normalize only) instead of a center crop")
    ap.add_argument("--probe_loss_weight", type=float, default=1.0)
    ap.add_argument("--limit_steps_per_epoch", type=int, default=0, help="smoke-test cap (0 = full epoch)")
    ap.add_argument("--run_single_validation", action="store_true", help="not ported yet")
    ap.add_argument("--checkpoint_path", default=None)
    ap.add_argument("--bf16", action="store_true", default=True)
    ap.add_argument("--fp32", dest="bf16", action="store_false")
    ap.add_argument("--aug_recipe", default=None, choices=["ffcv", "torchvision"])
    ap.add_argument("--window_prob", type=float, default=None)
    ap.add_argument("--host_precrop", action="store_true", help="not ported yet")
    ap.add_argument("--remat", action="store_true", help="not ported yet")
    ap.add_argument("--skip_hbm_check", action="store_true", help="no effect: no memory guard in the port yet")
    ap.add_argument("--force_hbm", action="store_true", help="no effect: no memory guard in the port yet")
    ap.add_argument("--model_parallel", type=int, default=1, metavar="N", help="only 1 in the port so far")
    ap.add_argument("--profile", type=int, default=0, metavar="N", help="not ported yet")
    return ap.parse_args(argv)


_UNPORTED = (
    ("resume", lambda a: a.resume, "checkpoint resume"),
    ("model_parallel", lambda a: a.model_parallel > 1, "tensor-parallel BYOL heads"),
    ("remat", lambda a: a.remat, "activation checkpointing"),
    ("host_precrop", lambda a: a.host_precrop, "host pre-crop"),
    ("knn_every_epochs", lambda a: a.knn_every_epochs > 0, "the KNN probe"),
    ("profile", lambda a: a.profile > 0, "the torch.profiler trace"),
    ("run_single_validation", lambda a: a.run_single_validation, "checkpoint load + single validation"),
)


def refuse_unported(args: argparse.Namespace, unported=_UNPORTED) -> None:
    """SystemExit on the first flag of ``unported`` that ``args`` sets."""
    for flag, is_set, what in unported:
        if is_set(args):
            raise SystemExit(f"--{flag}: {what} is not ported to the PyTorch package yet "
                             "(see ROADMAP.md); run medical_image_segmentation_tpu for it")


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: CUDA is not available (pass --device cpu explicitly)")
    return device


def _val_preprocess(imgs: torch.Tensor, dm, full_image: bool = False) -> torch.Tensor:
    """Val stats normalize, after a center crop to the train crop size unless
    ``full_image`` (``train_ssl.py:107-126``)."""
    x = imgs.float()
    if not full_image:
        _, h, w, _ = imgs.shape
        s = min(h, w, dm.crop_size)
        y0, x0 = (h - s) // 2, (w - s) // 2
        x = x[:, y0:y0 + s, x0:x0 + s, :]
    mean = torch.tensor(dm.val_mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(dm.val_std, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).contiguous()


@dataclasses.dataclass
class TrainRun:
    """What a run did: the task at its end, one record per epoch
    (``steps``, ``seconds``, ``img_per_s``, ``loss``) and whether the fused
    kernel made the views."""

    task: object
    epochs: List[Dict[str, float]]
    used_kernel: bool


def run(argv: Optional[Sequence[str]] = None) -> TrainRun:
    args = parse_args(argv)
    refuse_unported(args)
    device = resolve_device(args.device)

    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True
    dm = get_datamodule(args.dataset)()
    if args.aug_recipe is not None:
        dm.aug_recipe = args.aug_recipe
    if args.window_prob is not None:
        dm.window_prob = args.window_prob
    cfg1, cfg2 = dm.view_configs()
    train_loader = dm.train_loader(args.batch_size, num_threads=args.num_workers, seed=args.seed)
    steps_per_epoch = len(train_loader)
    if steps_per_epoch == 0:
        raise SystemExit(f"--batch_size {args.batch_size} exceeds the train set: every epoch would run 0 steps")
    if args.limit_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, args.limit_steps_per_epoch)
    total_steps = steps_per_epoch * args.max_epochs

    dtype = torch.bfloat16 if args.bf16 else torch.float32
    task = BYOLTask(
        arch=args.arch, in_channels=dm.channels, low_res=dm.low_res,
        hidden_dim=args.hidden_dim, proj_dim=args.projection_dim, num_classes=dm.NUM_CLASSES,
        learning_rate=args.learning_rate, weight_decay=args.weight_decay,
        warmup_epochs=args.warmup_epochs, max_epochs=args.max_epochs,
        base_ema_momentum=args.base_momentum, final_ema_momentum=args.final_momentum,
        total_steps=total_steps, steps_per_epoch=steps_per_epoch,
        probe_loss_weight=args.probe_loss_weight, dtype=dtype, device=device,
    )
    task.init(args.seed)

    mean, std = tuple(dm.train_mean), tuple(dm.train_std)
    use_kernel = (device.type == "cuda"
                  and fused_supported(cfg1, dm.channels) and fused_supported(cfg2, dm.channels)
                  # uint16 stores stay on the plain path in the trainer for now
                  and train_loader.dtype == np.uint8)
    aug_gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    has_labels = dm.has_train_labels

    def augment(imgs):
        if use_kernel:
            return fused_two_view_augment(imgs, cfg1, cfg2, mean, std, dtype, generator=aug_gen)
        return two_view_augment(aug_gen, imgs, cfg1, cfg2, mean, std, dtype)

    logger = CSVMetricsLogger(args.log_dir)
    epochs: List[Dict[str, float]] = []
    with contextlib.closing(train_loader):
        for epoch in range(args.max_epochs):
            epochs += _train_epoch(task, train_loader, augment, has_labels, args, device, logger, epoch)
            if args.val_every_epochs and (epoch + 1) % args.val_every_epochs == 0:
                _validate(task, dm, args, device, logger, epoch)
            if args.checkpoint_every_epochs and (epoch + 1) % args.checkpoint_every_epochs == 0:
                path = save_checkpoint(args.checkpoint_dir, task.state_dict(), task.step)
                print(f"checkpoint → {path}", file=sys.stderr)
    return TrainRun(task=task, epochs=epochs, used_kernel=use_kernel)


def _train_epoch(task, train_loader, augment, has_labels, args, device, logger, epoch) -> List[Dict[str, float]]:
    """One epoch; its record, or none if it ran no step."""
    t0 = time.time()
    n_imgs, metrics = 0, {}
    with contextlib.closing(device_batches(train_loader, device)) as batches:
        for i, (imgs, labels) in enumerate(batches):
            if args.limit_steps_per_epoch and i >= args.limit_steps_per_epoch:
                break
            v1, v2 = augment(imgs)
            metrics = task.train_step(v1, v2, labels if has_labels else None)
            n_imgs += args.batch_size
            if i % 50 == 0:
                logger.log({k: float(v) for k, v in metrics.items()}, step=task.step, epoch=epoch)
    if not metrics:
        return []
    last_loss = float(metrics["loss"])  # waits for the epoch's last step
    dt = time.time() - t0
    print(f"epoch {epoch}: loss={last_loss:.4f} {n_imgs / dt:.0f} img/s "
          f"lr={metrics['lr']:.4f} tau={metrics['momentum']:.5f}", file=sys.stderr)
    return [{"steps": n_imgs // args.batch_size, "seconds": dt, "img_per_s": n_imgs / dt, "loss": last_loss}]


def _validate(task, dm, args, device, logger, epoch) -> None:
    try:
        val_loader = dm.val_loader(args.batch_size, num_threads=args.num_workers)
    except FileNotFoundError:
        return
    aggr = {"val/loss": 0.0, "val/acc@1": 0.0, "val/acc@5": 0.0}
    n_b = 0
    with contextlib.closing(val_loader):
        for imgs, labels in device_batches(val_loader, device):
            m = task.val_step(_val_preprocess(imgs, dm, args.val_full_image), labels)
            for k in aggr:
                aggr[k] += float(m[k])
            n_b += 1
    if n_b:
        aggr = {k: v / n_b for k, v in aggr.items()}
        print(f"epoch {epoch}: " + " ".join(f"{k}={v:.4f}" for k, v in aggr.items()), file=sys.stderr)
        logger.log(aggr, step=task.step, epoch=epoch)


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
