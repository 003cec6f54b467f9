"""BYOL self-supervised pretraining entry point (``mis-train-ssl-torch``).

Port of ``train/train_ssl.py``: the same flag surface and defaults, plus an
explicit ``--device`` (default ``cuda``). A CUDA run never drops to the CPU
by itself: asking for ``cuda`` without one raises.

Per step: the C++ ``Loader`` (``data/loader.py``) decodes a uint8 (or uint16) batch on
host threads → ``data/device_feed.py`` copies it to the device one batch
ahead → the two-view augmentation makes both views on the device → one
``BYOLTask.train_step`` (online fwd/bwd, target fwd, LARS, EMA).

Augmentation routing is the JAX trainer's (``train_ssl.py:263-294``):
``--host_precrop`` crops on the host and runs only the elementwise tail
(``two_view_tail_augment``) on the device; otherwise, on CUDA, configs
whose every enabled augmentation the fused kernel implements take it;
blur/jitter recipes, uint16 stores and the CPU take the plain
``ops/augment.py::two_view_augment``.

``train/loop.py`` runs the epochs, as in the JAX trainer: ``--resume``
(the batches a mid-epoch checkpoint already trained are read and dropped,
without drawing any augmentation), the memory guard's probe step,
SIGTERM/SIGINT, the checkpoint cadence (the last epoch included) and
``--profile N``, which here also prints the loader's stage timers each
epoch. Around it:

- ``--run_single_validation`` loads ``--checkpoint_path`` (or the latest
  step of ``--checkpoint_dir``) and runs one val pass, no training;
- ``--knn_every_epochs`` runs the KNN probe (``eval/knn.py``) on the val
  store.

Several processes (``parallel/mesh.py``): launched by torchrun or SLURM,
every rank runs this entry point; ``--batch_size`` is global and must
divide by the world size. Each rank loads its shard of every epoch
(``shard=(data rank, data ranks)``), draws the global batch's
augmentation from the stream all ranks share and keeps its rows, and
takes the step with global BatchNorm statistics and averaged gradients.
Only rank 0 logs and writes checkpoints; a SIGTERM to any rank stops all
of them at one agreed step. ``--model_parallel M`` lays the ranks out on
a (data, model) mesh and splits the BYOL heads over the M ranks of each
model group (``parallel/tp.py``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from medical_image_segmentation_tpu_torch.core.checkpoint import load_checkpoint
from medical_image_segmentation_tpu_torch.data.datamodules import get_datamodule
from medical_image_segmentation_tpu_torch.data.device_feed import device_batches
from medical_image_segmentation_tpu_torch.eval.knn import KNNEvaluator, val_preprocess
from medical_image_segmentation_tpu_torch.ops.augment import precrop_supported, two_view_augment, two_view_tail_augment
from medical_image_segmentation_tpu_torch.ops.fused_augment import fused_supported, fused_two_view_augment
from medical_image_segmentation_tpu_torch.parallel.mesh import Mesh, Process, shutdown_distributed
from medical_image_segmentation_tpu_torch.train.byol_task import BYOLTask
from medical_image_segmentation_tpu_torch.train.loop import (
    FitRun, TrainLoop, add_common_flags, batch_range, epoch_steps, start_ranks,
)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="BYOL SSL pretraining (PyTorch/CUDA port)")
    ap.add_argument("--dataset", default="CIFAR10")
    ap.add_argument("--batch_size", type=int, default=256)
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
    ap.add_argument("--checkpoint_dir", default="checkpoints/ssl")
    ap.add_argument("--checkpoint_every_epochs", type=int, default=1)
    ap.add_argument("--val_every_epochs", type=int, default=1)
    ap.add_argument("--knn_every_epochs", type=int, default=0, help="0 disables the KNN probe")
    ap.add_argument("--knn_bank_size", type=int, default=262144,
                    help="cap on the KNN feature-bank rows (the train loader's first N); 0 = unbounded")
    ap.add_argument("--knn_bank_chunk", type=int, default=65536,
                    help="stream the similarity product over bank chunks of this many rows; 0 = unchunked")
    ap.add_argument("--val_full_image", action="store_true",
                    help="validate on full stored images (normalize only) instead of a center crop")
    ap.add_argument("--probe_loss_weight", type=float, default=1.0)
    ap.add_argument("--limit_steps_per_epoch", type=int, default=0, help="smoke-test cap (0 = full epoch)")
    ap.add_argument("--run_single_validation", action="store_true",
                    help="load --checkpoint_path (or the latest in --checkpoint_dir) and run one val pass, "
                         "no training")
    ap.add_argument("--checkpoint_path", default=None)
    ap.add_argument("--aug_recipe", default=None, choices=["ffcv", "torchvision"])
    ap.add_argument("--window_prob", type=float, default=None)
    ap.add_argument("--host_precrop", action="store_true",
                    help="RandomResizedCrop in the loader's host workers: ship 2 crop² views instead of "
                         "the full images and run only the elementwise tail on the device "
                         "(blur-free recipes only)")
    ap.add_argument("--remat", action="store_true",
                    help="checkpoint each residual block: less activation memory, ~1/3 more backward work")
    ap.add_argument("--force_hbm", action="store_true",
                    help="run even if the probe step does not fit the card's memory")
    ap.add_argument("--model_parallel", type=int, default=1, metavar="N",
                    help=">1: split the projector/predictor MLP heads over N ranks of a (data, model) mesh "
                         "(parallel/tp.py); 1 = pure data parallel")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="trace the first N steps with torch.profiler into <log_dir>/trace and print the "
                         "loader's stage timers each epoch")
    add_common_flags(ap)
    return ap.parse_args(argv)


def precrop_spec(dm, cfg1, cfg2) -> dict:
    """The ``Loader`` precrop spec of ``--host_precrop``, with the JAX
    trainer's refusals (``train_ssl.py:167-182``)."""
    if not (precrop_supported(cfg1) and precrop_supported(cfg2)):
        raise SystemExit("--host_precrop requires an all-elementwise post-crop recipe "
                         "(no GaussianBlur) — use the default ffcv recipe, not torchvision")
    if (cfg1.crop_scale, cfg1.crop_ratio, cfg1.hflip_prob) != (cfg2.crop_scale, cfg2.crop_ratio, cfg2.hflip_prob):
        raise SystemExit("--host_precrop needs both views to share crop geometry")
    return {"out_hw": (dm.crop_size, dm.crop_size), "n_views": 2, "scale": cfg1.crop_scale,
            "ratio": cfg1.crop_ratio, "hflip_prob": cfg1.hflip_prob}


@dataclasses.dataclass
class TrainRun(FitRun):
    """``FitRun``'s fields, the rate ``img_per_s``, and: ``(step, lr, tau)``
    of every step it trained; whether the fused kernel made the views; the
    last val metrics and KNN accuracy; and which host reader served the
    train store ("native" or "python")."""

    used_kernel: bool
    schedule: List[Tuple[int, float, float]] = dataclasses.field(default_factory=list)
    val: Optional[Dict[str, float]] = None
    knn_acc: Optional[float] = None
    reader: str = ""


def run(argv: Optional[Sequence[str]] = None) -> TrainRun:
    args = parse_args(argv)
    proc, mesh = start_ranks(args.device, args.batch_size, args.model_parallel, args.hidden_dim)
    device = proc.device
    shard = mesh.shard("data")
    per_rank = args.batch_size // shard[1]

    dm = get_datamodule(args.dataset)()
    if args.aug_recipe is not None:
        dm.aug_recipe = args.aug_recipe
    if args.window_prob is not None:
        dm.window_prob = args.window_prob
    cfg1, cfg2 = dm.view_configs()
    precrop = precrop_spec(dm, cfg1, cfg2) if args.host_precrop else None
    dtype = torch.bfloat16 if args.bf16 else torch.float32

    if args.run_single_validation:
        task = _make_task(args, dm, dtype, device, steps_per_epoch=1, mesh=mesh)
        task.load_state_dict(load_checkpoint(args.checkpoint_path or args.checkpoint_dir))
        val = _validate(task, dm, args, device, dm.val_loader(per_rank, num_threads=args.num_workers, shard=shard))
        if val is None:
            raise SystemExit(f"--run_single_validation: the val store {dm.val_store!r} holds no batch")
        if proc.is_main:
            print(" ".join(f"{k}={v:.4f}" for k, v in val.items()))
        return TrainRun(task=task, used_kernel=False, val=val)

    train_loader = dm.train_loader(per_rank, num_threads=args.num_workers, seed=args.seed, shard=shard,
                                   distributed=shard[1] > 1, precrop=precrop)
    with contextlib.closing(train_loader):
        steps_per_epoch = epoch_steps(args, len(train_loader), per_rank, "the train set")
        task = _make_task(args, dm, dtype, device, steps_per_epoch, mesh)
        return _fit(args, dm, task, train_loader, steps_per_epoch, cfg1, cfg2, dtype, proc, mesh)


def _make_task(args, dm, dtype, device, steps_per_epoch: int, mesh: Optional[Mesh] = None) -> BYOLTask:
    task = BYOLTask(
        arch=args.arch, in_channels=dm.channels, low_res=dm.low_res,
        hidden_dim=args.hidden_dim, proj_dim=args.projection_dim, num_classes=dm.NUM_CLASSES,
        learning_rate=args.learning_rate, weight_decay=args.weight_decay,
        warmup_epochs=args.warmup_epochs, max_epochs=args.max_epochs,
        base_ema_momentum=args.base_momentum, final_ema_momentum=args.final_momentum,
        total_steps=steps_per_epoch * args.max_epochs, steps_per_epoch=steps_per_epoch,
        probe_loss_weight=args.probe_loss_weight, dtype=dtype, device=device, remat=args.remat, mesh=mesh,
    )
    task.init(args.seed)
    return task


def _fit(args, dm, task, train_loader, steps_per_epoch, cfg1, cfg2, dtype, proc: Process, mesh: Mesh) -> TrainRun:
    device = proc.device
    shard = mesh.shard("data")
    per_rank = args.batch_size // shard[1]
    mean, std = tuple(dm.train_mean), tuple(dm.train_std)
    use_kernel = (not args.host_precrop and device.type == "cuda"
                  and fused_supported(cfg1, dm.channels) and fused_supported(cfg2, dm.channels)
                  # uint16 stores stay on the plain path in the trainer for now
                  and train_loader.dtype == np.uint8)
    has_labels = dm.has_train_labels
    out = TrainRun(task=task, used_kernel=use_kernel, reader="native" if train_loader._native is not None else "python")
    loop = TrainLoop(args, proc, mesh, task, train_loader, steps_per_epoch, out)
    aug_gen = loop.aug_gen

    def augment(imgs):
        if args.host_precrop:
            return two_view_tail_augment(aug_gen, imgs, cfg1, cfg2, mean, std, dtype, shard)
        if use_kernel:
            return fused_two_view_augment(imgs, cfg1, cfg2, mean, std, dtype, generator=aug_gen, shard=shard)
        return two_view_augment(aug_gen, imgs, cfg1, cfg2, mean, std, dtype, shard)

    # the memory guard's probe: one step at the shapes the loader ships this
    # rank (sample-major views under --host_precrop, full stored images
    # otherwise)
    shape = ((2 * per_rank, dm.crop_size, dm.crop_size, train_loader.channels) if args.host_precrop
             else (per_rank, *train_loader.out_hw, train_loader.channels))
    img_dtype = torch.from_numpy(np.zeros(0, train_loader.dtype)).dtype

    def probe():
        imgs = torch.zeros(shape, dtype=img_dtype, device=device)
        labels = torch.zeros(per_rank, dtype=torch.int64, device=device) if has_labels else None
        task.train_step(*augment(imgs), labels)

    loop.guard_memory(probe, f"ssl train step (arch {args.arch}, batch {per_rank} a rank)")

    def step(imgs, labels):
        metrics = task.train_step(*augment(imgs), labels if has_labels else None)
        out.schedule.append((task.step - 1, metrics["lr"], metrics["momentum"]))
        return metrics

    def end_epoch(epoch, metrics, record):
        if record and proc.is_main:
            rate = record["img_per_s"]
            print(f"epoch {epoch}: loss={record['loss']:.4f} {rate:.0f} img/s ({rate / proc.world_size:.0f}/rank) "
                  f"lr={metrics['lr']:.4f} tau={metrics['momentum']:.5f}", file=sys.stderr)
            if args.profile:
                print(f"loader stages (epoch {epoch}):\n{train_loader.timers.report(reset=True)}", file=sys.stderr)
        if args.val_every_epochs and (epoch + 1) % args.val_every_epochs == 0:
            _validate_epoch(task, dm, args, device, loop, epoch, out, mesh)
        if args.knn_every_epochs and (epoch + 1) % args.knn_every_epochs == 0:
            _knn_epoch(task, dm, args, device, loop, epoch, out, mesh)

    loop.run(lambda start, stop: batch_range(device_batches(train_loader, device), start, stop), step, end_epoch,
             rate="img_per_s", loss="loss", checkpoint_last=True, log_every=50, profile=args.profile)
    return out


def _validate(task, dm, args, device, val_loader) -> Optional[Dict[str, float]]:
    """Mean over ``val_loader``'s batches of the probe's val metrics (the
    loader is closed); None if it had no batch."""
    aggr = {"val/loss": 0.0, "val/acc@1": 0.0, "val/acc@5": 0.0}
    n_b = 0
    with contextlib.closing(val_loader), contextlib.closing(device_batches(val_loader, device)) as batches:
        for imgs, labels in batches:
            m = task.val_step(val_preprocess(imgs, dm, args.val_full_image), labels)
            for k in aggr:
                aggr[k] += float(m[k])
            n_b += 1
    return {k: v / n_b for k, v in aggr.items()} if n_b else None


def _validate_epoch(task, dm, args, device, loop: TrainLoop, epoch, out: TrainRun, mesh: Mesh) -> None:
    shard = mesh.shard("data")
    try:
        val_loader = dm.val_loader(args.batch_size // shard[1], num_threads=args.num_workers, shard=shard)
    except FileNotFoundError:
        return
    out.val = _validate(task, dm, args, device, val_loader)
    loop.report(f"epoch {epoch}: ", out.val, epoch)


def _knn_epoch(task, dm, args, device, loop: TrainLoop, epoch, out: TrainRun, mesh: Mesh) -> None:
    """The KNN probe (``train_ssl.py:413-442``): a bank from the train
    store's first ``--knn_bank_size`` images in the run's order (every
    rank's shard, gathered), scored on the val store; both probe loaders
    are closed on every path."""
    shard = mesh.shard("data")
    per_rank = args.batch_size // shard[1]
    try:
        bank_loader = dm.train_loader(per_rank, num_threads=args.num_workers, seed=args.seed, shard=shard)
    except FileNotFoundError:
        return
    with contextlib.closing(bank_loader):
        try:
            val_loader = dm.val_loader(per_rank, num_threads=args.num_workers, shard=shard)
        except FileNotFoundError:
            return
        with contextlib.closing(val_loader), \
                contextlib.closing(device_batches(bank_loader, device)) as bank, \
                contextlib.closing(device_batches(val_loader, device)) as val:
            ev = KNNEvaluator(num_classes=dm.NUM_CLASSES, max_bank_size=args.knn_bank_size or None,
                              bank_chunk_size=args.knn_bank_chunk or None, group=mesh.group("data"))
            out.knn_acc = ev.evaluate(lambda x: task.embed_step(val_preprocess(x, dm, args.val_full_image)),
                                      bank, val)
    loop.report(f"epoch {epoch}: ", {"online_knn_val_acc": out.knn_acc}, epoch)


def main(argv: Optional[Sequence[str]] = None) -> int:
    try:
        run(argv)
    finally:
        shutdown_distributed()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
