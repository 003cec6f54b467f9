"""U-Net segmentation training entry point (``mis-train-segmentation-torch``):
fit → val each epoch → test → final checkpoint.

Port of ``train/train_segmentation.py:36-347``: the same flags and
defaults, plus an explicit ``--device`` (default ``cuda``, which raises
without a card). Per step: the paired loader (raw stores or PNG dir)
decodes a uint8 image batch and its 0/1 masks on host threads →
``data/device_feed.py`` copies both to the device one batch ahead →
``segmentation_augment`` (resize, shared flips, jitter, windows,
normalize) → one ``SegmentationTask.train_step``.

- ``--ssl_checkpoint`` grafts the online backbone of a port BYOL ``.pt``
  (``mis-train-ssl-torch``) into the U-Net encoder before training.
- val and test metrics are the mean over batches of each batch's Dice, IoU
  and loss, not pooled over the split.
- a periodic checkpoint every ``--checkpoint_every_epochs`` epochs but the
  last; the final one is written after the test pass.
- SIGTERM/SIGINT: the current step finishes, a checkpoint is written and
  the run returns 0.

Not ported yet (each raises when set): ``--resume``, ``--remat``,
``--profile``. ``--skip_hbm_check`` and ``--force_hbm`` have no effect.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time
from typing import Dict, List, Optional, Sequence

import torch

from medical_image_segmentation_tpu.core.metrics_logger import CSVMetricsLogger
from medical_image_segmentation_tpu_torch.core.checkpoint import (
    load_byol_encoder_into_unet, resolve_checkpoint_path, save_checkpoint,
)
from medical_image_segmentation_tpu_torch.data.datamodules import get_datamodule
from medical_image_segmentation_tpu_torch.data.device_feed import device_arrays
from medical_image_segmentation_tpu_torch.eval.sliding_window import make_unet_window_fn, sliding_window_predict
from medical_image_segmentation_tpu_torch.ops.augment import parse_hu_windows, segmentation_augment
from medical_image_segmentation_tpu_torch.ops.dice import dice_coefficient, jaccard_index, post_process_masks
from medical_image_segmentation_tpu_torch.serve import normalize_u8
from medical_image_segmentation_tpu_torch.train.resilience import PreemptionGuard
from medical_image_segmentation_tpu_torch.train.segmentation_task import SegmentationTask
from medical_image_segmentation_tpu_torch.train.train_ssl import refuse_unported, resolve_device
from medical_image_segmentation_tpu_torch.utils.viz import save_combined_image_grid


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="U-Net medical segmentation (PyTorch/CUDA port)")
    ap.add_argument("--dataset", default="DECATHLON_LIVER")
    ap.add_argument("--images_dir", required=True)
    ap.add_argument("--masks_dir", required=True)
    ap.add_argument("--split_file", default=None)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--max_epochs", type=int, default=50)
    ap.add_argument("--learning_rate", type=float, default=1.0)
    ap.add_argument("--min_lr", type=float, default=1e-2)
    ap.add_argument("--warmup_epochs", type=int, default=10)
    ap.add_argument("--weight_decay", type=float, default=1e-6)
    ap.add_argument("--arch", default="resnet18")
    ap.add_argument("--image_size", type=int, default=224)
    ap.add_argument("--num_workers", type=int,
                    default=int(os.environ.get("SLURM_CPUS_PER_TASK", os.cpu_count() or 4)))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device; cuda raises if absent")
    ap.add_argument("--log_dir", default="logs")
    ap.add_argument("--checkpoint_dir", default="checkpoints/seg")
    ap.add_argument("--resume", action="store_true", help="not ported yet")
    ap.add_argument("--checkpoint_every_epochs", type=int, default=1,
                    help="periodic checkpoint cadence (0 = final checkpoint only)")
    ap.add_argument("--ssl_checkpoint", default=None,
                    help="BYOL .pt (or its directory: latest step) to initialize the U-Net encoder from")
    ap.add_argument("--predict_grid", default=None, help="path for a pred/truth overlay grid PNG")
    ap.add_argument("--loss", default="dice", choices=["dice", "dice_ce"])
    ap.add_argument("--hu_windows", default=None, metavar="L:W,L:W,…",
                    help="fixed display windows (level:width, stored-value units) stacked as input "
                         "channels; applied at train, eval and serving, e.g. '96:160,40:80,170:170'")
    ap.add_argument("--seg_store_prefix", default="",
                    help="paired MIS store prefix from create_seg_store.py (C++ loader fast path)")
    ap.add_argument("--full_res_window", type=int, default=0,
                    help=">0: also evaluate test slices at native resolution via sliding-window blending")
    ap.add_argument("--limit_steps_per_epoch", type=int, default=0)
    ap.add_argument("--bf16", action="store_true", default=True)
    ap.add_argument("--fp32", dest="bf16", action="store_false")
    ap.add_argument("--remat", action="store_true", help="not ported yet")
    ap.add_argument("--skip_hbm_check", action="store_true", help="no effect: no memory guard in the port yet")
    ap.add_argument("--force_hbm", action="store_true", help="no effect: no memory guard in the port yet")
    ap.add_argument("--profile", type=int, default=0, metavar="N", help="not ported yet")
    return ap.parse_args(argv)


_UNPORTED = (
    ("resume", lambda a: a.resume, "checkpoint resume"),
    ("remat", lambda a: a.remat, "activation checkpointing"),
    ("profile", lambda a: a.profile > 0, "the torch.profiler trace"),
)


@dataclasses.dataclass
class SegRun:
    """What a run did: the task at its end, the weights it started from
    (after the graft; CPU copies), one record per epoch (``steps``,
    ``seconds``, ``img_per_s``, ``loss``), the last val and the test
    metrics, the last checkpoint written, and whether a signal stopped it."""

    task: SegmentationTask
    start_state: Dict[str, torch.Tensor]
    epochs: List[Dict[str, float]]
    val: Optional[Dict[str, float]]
    test: Optional[Dict[str, float]]
    checkpoint: str
    stopped: bool = False


def run(argv: Optional[Sequence[str]] = None) -> SegRun:
    args = parse_args(argv)
    refuse_unported(args, _UNPORTED)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True

    dm = get_datamodule(args.dataset)(images_dir=args.images_dir, masks_dir=args.masks_dir,
                                      split_file=args.split_file, image_size=args.image_size,
                                      store_prefix=args.seg_store_prefix)
    train_loader = dm.loader("train", args.batch_size, seed=args.seed, num_threads=args.num_workers)
    if len(train_loader) == 0:
        train_loader.close()
        raise SystemExit(f"--batch_size {args.batch_size} exceeds the train split: every epoch would run 0 "
                         "steps. Lower --batch_size to at most the train-set size.")
    steps_per_epoch = len(train_loader)
    if args.limit_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, args.limit_steps_per_epoch)

    hu_windows = parse_hu_windows(args.hu_windows) if args.hu_windows else ()
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    task = SegmentationTask(
        arch=args.arch, n_classes=1, in_channels=len(hu_windows) or 1,
        learning_rate=args.learning_rate, weight_decay=args.weight_decay,
        warmup_epochs=args.warmup_epochs, max_epochs=args.max_epochs, min_lr=args.min_lr,
        steps_per_epoch=steps_per_epoch, loss=args.loss, dtype=dtype, device=device,
    )
    task.init(args.seed)
    if args.ssl_checkpoint:
        byol = torch.load(resolve_checkpoint_path(args.ssl_checkpoint), map_location="cpu", weights_only=True)
        task.model.load_state_dict(load_byol_encoder_into_unet(task.model.state_dict(), byol["online"]))
        print(f"initialized encoder from {args.ssl_checkpoint}", file=sys.stderr)
    start_state = {k: v.detach().cpu().clone() for k, v in task.model.state_dict().items()}

    size = (args.image_size, args.image_size)
    mean, std = tuple(dm.mean), tuple(dm.std)
    aug_gen = torch.Generator(device=device).manual_seed(args.seed + 1)

    def augment(imgs, msks, train: bool):
        return segmentation_augment(aug_gen if train else None, imgs, msks, out_size=size, mean=mean, std=std,
                                    train=train, dtype=dtype, hu_windows=hu_windows)

    def run_eval(split: str) -> Optional[Dict[str, float]]:
        with contextlib.closing(dm.loader(split, args.batch_size, num_threads=args.num_workers)) as loader:
            if len(loader) == 0:
                return None
            aggr = {"loss": 0.0, "dice": 0.0, "iou": 0.0}
            n = 0
            for imgs, msks in device_arrays(loader, device):
                m = task.eval_step(*augment(imgs, msks, train=False))
                for k in aggr:
                    aggr[k] += float(m[k])
                n += 1
        return {f"{split}/{k}": v / n for k, v in aggr.items()}

    logger = CSVMetricsLogger(args.log_dir)

    def checkpoint() -> str:
        path = save_checkpoint(args.checkpoint_dir, task.state_dict(), task.step)
        print(f"checkpoint → {path}", file=sys.stderr)
        return path

    epochs: List[Dict[str, float]] = []
    val = None
    with PreemptionGuard() as guard, contextlib.closing(train_loader):
        for epoch in range(args.max_epochs):
            t0 = time.time()
            metrics, n_imgs = {}, 0
            with contextlib.closing(device_arrays(train_loader, device)) as batches:
                for i, (imgs, msks) in enumerate(batches):
                    if args.limit_steps_per_epoch and i >= args.limit_steps_per_epoch:
                        break
                    metrics = task.train_step(*augment(imgs, msks, train=True))
                    n_imgs += args.batch_size
                    if guard.stop_requested:
                        break
            if guard.stop_requested:
                return SegRun(task, start_state, epochs, val, None, checkpoint(), stopped=True)
            if metrics:
                loss = float(metrics["train/loss"])  # waits for the epoch's last step
                dt = time.time() - t0
                print(f"epoch {epoch}: train/loss={loss:.4f} {n_imgs / dt:.0f} img/s", file=sys.stderr)
                logger.log({k: float(v) for k, v in metrics.items()}, step=task.step, epoch=epoch)
                epochs.append({"steps": n_imgs // args.batch_size, "seconds": dt, "img_per_s": n_imgs / dt,
                               "loss": loss})
            val = run_eval("val")
            if val:
                print(f"epoch {epoch}: " + " ".join(f"{k}={v:.4f}" for k, v in val.items()), file=sys.stderr)
                logger.log(val, step=task.step, epoch=epoch)
            if (args.checkpoint_every_epochs and (epoch + 1) % args.checkpoint_every_epochs == 0
                    and epoch + 1 < args.max_epochs):  # the final epoch saves below
                checkpoint()

    test = run_eval("test")
    if test:
        print("test: " + " ".join(f"{k}={v:.4f}" for k, v in test.items()), file=sys.stderr)
        logger.log(test, step=task.step, epoch=args.max_epochs)
    path = checkpoint()

    if args.full_res_window:
        _full_res_test(task, dm, args.full_res_window, mean, std, hu_windows, device, logger, args.max_epochs)
    if args.predict_grid:
        with contextlib.closing(dm.loader("test", min(args.batch_size, 16))) as loader:
            for imgs, msks in loader:
                x, _ = augment(torch.from_numpy(imgs).to(device), torch.from_numpy(msks).to(device), train=False)
                save_combined_image_grid(imgs, task.predict_step(x).cpu().numpy(), msks, args.predict_grid)
                print(f"prediction grid → {args.predict_grid}", file=sys.stderr)
                break
    return SegRun(task, start_state, epochs, val, test, path)


def _full_res_test(task, dm, window, mean, std, hu_windows, device, logger, epoch) -> None:
    """Dice and IoU of every test slice at its native resolution, through
    sliding-window blending; the means are printed and logged."""
    ds = dm.dataset("test")
    window_fn = make_unet_window_fn(task)
    dices, ious = [], []
    for i in range(len(ds)):
        img, msk = ds[i]
        x = normalize_u8(torch.from_numpy(img[..., None]).to(device), mean, std, hu_windows)
        pred = post_process_masks(sliding_window_predict(window_fn, x, window=window))
        target = torch.from_numpy(msk[..., None]).to(device).float()
        dices.append(float(dice_coefficient(pred, target)))
        ious.append(float(jaccard_index(pred, target)))
    if dices:
        dice, iou = sum(dices) / len(dices), sum(ious) / len(ious)
        print(f"full-res sliding-window test: dice={dice:.4f} iou={iou:.4f} ({len(dices)} slices, window {window})",
              file=sys.stderr)
        logger.log({"test/full_res_dice": dice, "test/full_res_iou": iou}, step=task.step, epoch=epoch)


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
