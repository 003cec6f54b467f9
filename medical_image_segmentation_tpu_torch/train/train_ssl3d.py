"""Volumetric BYOL pretraining entry point (``mis-train-ssl3d-torch``).

Port of ``train/train_ssl3d.py:32-251``: the same flags and defaults, plus
an explicit ``--device`` (default ``cuda``, which raises without a card).
A ``UNet3DEncoder`` is pretrained with BYOL on unlabeled NIfTI volumes:
``data/volumes.py`` reads and centre-fits them on the host →
``ops/augment3d.py::byol_two_view_augment_3d`` makes two random sub-volume
views of each on the device → one ``BYOLTask(volumetric=True)`` step, with
no probe loss (two dummy classes, weight 0).

``--device_cache`` puts the whole corpus on the device once and gathers
the batches there by index, bit for bit the batches of the host route.
``--resume``, SIGTERM/SIGINT, the checkpoint cadence, ``--remat`` and the
memory guard work as in ``train/train_ssl.py``. The encoder of the
checkpoint grafts into a ``UNet3D`` through ``mis-train-segmentation3d-torch
--ssl_checkpoint``.

Several processes (torchrun or SLURM, ``parallel/mesh.py``): the global
``--batch_size`` divides by the world size; each rank reads its shard
(``VolumeLoader(num_hosts=N, host_id=rank)``), keeps its rows of the
global view draws and takes the step with global head BatchNorm
statistics and averaged gradients; only rank 0 logs and writes
checkpoints. ``--device_cache`` stays single-process, as in the JAX
trainer.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from medical_image_segmentation_tpu_torch.core.checkpoint import resume_latest, save_rank0, trainer_state
from medical_image_segmentation_tpu_torch.core.hbm import guard_step, preserved, rank_hbm_capacity
from medical_image_segmentation_tpu_torch.core.metrics_logger import CSVMetricsLogger
from medical_image_segmentation_tpu_torch.data.device_feed import build_corpus, volume_batches
from medical_image_segmentation_tpu_torch.data.volumes import UnlabeledVolumeDataset, VolumeLoader
from medical_image_segmentation_tpu_torch.ops.augment3d import byol_two_view_augment_3d
from medical_image_segmentation_tpu_torch.train.byol_task import BYOLTask
from medical_image_segmentation_tpu_torch.train.resilience import PreemptionGuard
from medical_image_segmentation_tpu_torch.parallel.mesh import shutdown_distributed
from medical_image_segmentation_tpu_torch.train.train_segmentation3d import DEVICE_CACHE_SINGLE
from medical_image_segmentation_tpu_torch.train.train_ssl import start_ranks


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Volumetric BYOL pretraining (PyTorch/CUDA port)")
    ap.add_argument("--images_dir", required=True, help="directory of unlabeled .nii/.nii.gz volumes")
    ap.add_argument("--volume_size", type=int, nargs=3, default=(64, 96, 96), metavar=("D", "H", "W"))
    ap.add_argument("--crop_size", type=int, nargs=3, default=(32, 64, 64), metavar=("D", "H", "W"),
                    help="view crop (each dim a multiple of 2^(len(features)-1))")
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--max_epochs", type=int, default=100)
    ap.add_argument("--learning_rate", type=float, default=1.0)
    ap.add_argument("--warmup_epochs", type=int, default=10)
    ap.add_argument("--weight_decay", type=float, default=1e-6)
    ap.add_argument("--features", type=int, nargs="+", default=(32, 64, 128, 256))
    ap.add_argument("--hidden_dim", type=int, default=4096)
    ap.add_argument("--projection_dim", type=int, default=256)
    ap.add_argument("--ema_momentum", type=float, default=0.99)
    ap.add_argument("--mean", type=float, default=0.2089)
    ap.add_argument("--std", type=float, default=0.2109)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device; cuda raises if absent")
    ap.add_argument("--log_dir", default="logs")
    ap.add_argument("--checkpoint_dir", default="checkpoints/ssl3d")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in --checkpoint_dir: weights, optimizer, step, "
                         "data order and augmentation stream")
    ap.add_argument("--checkpoint_every_epochs", type=int, default=1)
    ap.add_argument("--limit_steps_per_epoch", type=int, default=0)
    ap.add_argument("--bf16", action="store_true", default=True)
    ap.add_argument("--fp32", dest="bf16", action="store_false")
    ap.add_argument("--remat", action="store_true", help="checkpoint each double-conv block of both towers")
    ap.add_argument("--skip_hbm_check", action="store_true",
                    help="skip the pre-flight memory guard (one probe step, core/hbm.py)")
    ap.add_argument("--force_hbm", action="store_true",
                    help="run even if the probe step, on top of what already lives on the card, does not fit "
                         "its memory: the guard then warns instead of refusing")
    ap.add_argument("--cache_volumes", action="store_true",
                    help="keep the fitted volumes in host memory between epochs (len(ds)·∏volume_size·4 "
                         "bytes; NIfTI gunzip and parse otherwise repeat every epoch)")
    ap.add_argument("--device_cache", action="store_true",
                    help="put the whole unlabeled corpus on the device once and gather the batches there by "
                         "index: epochs then move no volume from host to device (len(ds)·∏volume_size·4 "
                         "bytes of device memory, which the memory guard counts)")
    return ap.parse_args(argv)


@dataclasses.dataclass
class SSL3DRun:
    """What a run did: the task at its end, one record per epoch (``steps``,
    ``seconds``, ``vol_per_s``, ``loss``), every step's loss (0-d device
    tensors) and ``(step, lr, tau)``, the last checkpoint written, whether
    a signal stopped it, the step it resumed from and the batches it
    skipped, the memory guard's report and the corpus's bytes on the
    device."""

    task: BYOLTask
    epochs: List[Dict[str, float]] = dataclasses.field(default_factory=list)
    losses: List[torch.Tensor] = dataclasses.field(default_factory=list)
    schedule: List[Tuple[int, float, float]] = dataclasses.field(default_factory=list)
    checkpoint: str = ""
    stopped: bool = False
    resumed_from: Optional[int] = None
    skipped: int = 0
    hbm: Optional[dict] = None
    corpus_bytes: int = 0


def run(argv: Optional[Sequence[str]] = None) -> SSL3DRun:
    args = parse_args(argv)
    proc, mesh = start_ranks(args.device, args.batch_size)
    device, main_rank = proc.device, proc.is_main
    shard = mesh.shard("data")
    per_rank = args.batch_size // shard[1]
    if args.device_cache and proc.world_size > 1:
        raise SystemExit(DEVICE_CACHE_SINGLE)
    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True
    volume_size, crop = tuple(args.volume_size), tuple(args.crop_size)

    ds = UnlabeledVolumeDataset(args.images_dir, target_shape=volume_size, cache=args.cache_volumes)
    loader = VolumeLoader(ds, per_rank, shuffle=True, seed=args.seed, num_hosts=shard[1], host_id=shard[0])
    if len(loader) == 0:
        raise SystemExit(f"--batch_size {args.batch_size} (per rank {per_rank}) exceeds the unlabeled set ({len(ds)} volumes): every "
                         "epoch would run 0 steps. Lower --batch_size to at most the dataset size.")
    steps_per_epoch = len(loader)
    if args.limit_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, args.limit_steps_per_epoch)

    dtype = torch.bfloat16 if args.bf16 else torch.float32
    task = BYOLTask(
        volumetric=True, features3d=tuple(args.features), in_channels=1, hidden_dim=args.hidden_dim,
        proj_dim=args.projection_dim, num_classes=2, learning_rate=args.learning_rate,
        weight_decay=args.weight_decay, warmup_epochs=args.warmup_epochs, max_epochs=args.max_epochs,
        base_ema_momentum=args.ema_momentum, total_steps=steps_per_epoch * args.max_epochs,
        steps_per_epoch=steps_per_epoch, probe_loss_weight=0.0, dtype=dtype, device=device, remat=args.remat,
        mesh=mesh,
    )
    task.init(args.seed)
    out = SSL3DRun(task)

    aug_gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    start_epoch = 0
    resumed = resume_latest(args.checkpoint_dir, task, loader, aug_gen, steps_per_epoch) if args.resume else None
    if resumed:
        out.resumed_from, start_epoch, out.skipped = resumed

    def augment(vols):
        return byol_two_view_augment_3d(aug_gen, vols, out_size=crop, mean=(args.mean,), std=(args.std,), dtype=dtype,
                                        shard=shard)

    corpus = build_corpus(ds, device) if args.device_cache else None
    label = f"ssl3d train step (batch {per_rank} a rank)"
    if corpus is not None:
        out.corpus_bytes = corpus[0].numel() * corpus[0].element_size()
        print(f"device corpus cache: {len(ds)} volumes, {out.corpus_bytes / 2**30:.2f} GiB resident on the device",
              file=sys.stderr)
        label += f" on top of a {out.corpus_bytes / 2**30:.2f} GiB corpus kept on the device (in the peak)"

    def probe():
        vols = torch.zeros(per_rank, *volume_size, 1, device=device)
        with preserved(task, aug_gen):
            task.train_step(*augment(vols))

    out.hbm = guard_step(probe, label=label, skip=args.skip_hbm_check, force=args.force_hbm, device=device,
                         capacity=rank_hbm_capacity(proc.device, proc.ranks_per_device))

    logger = CSVMetricsLogger(args.log_dir) if main_rank else None

    def checkpoint(next_epoch: int) -> str:
        return save_rank0(args.checkpoint_dir, trainer_state(task, next_epoch, aug_gen), task.step, mesh)

    with PreemptionGuard(mesh) as guard:
        for epoch in range(start_epoch, args.max_epochs):
            skip = out.skipped if epoch == start_epoch else 0
            t0 = time.time()
            metrics, done = {}, skip
            with contextlib.closing(volume_batches(loader, device, corpus, skip, steps_per_epoch)) as batches:
                for (vols,) in batches:
                    metrics = task.train_step(*augment(vols))
                    out.losses.append(metrics["loss"])
                    out.schedule.append((task.step - 1, metrics["lr"], metrics["momentum"]))
                    done += 1
                    if guard.stop_agreed(done - 1):
                        out.checkpoint = checkpoint(epoch if done < steps_per_epoch else epoch + 1)
                        out.stopped = True
                        return out
            if guard.stop_agreed(at_epoch_end=True):
                out.checkpoint, out.stopped = checkpoint(epoch + 1), True
                return out
            if metrics:
                loss = float(metrics["loss"])  # waits for the epoch's last step
                dt = time.time() - t0
                n_vols = (done - skip) * args.batch_size
                if logger:
                    print(f"epoch {epoch}: loss={loss:.4f} tau={metrics['momentum']:.4f} {n_vols / dt:.1f} vol/s",
                          file=sys.stderr)
                    logger.log({k: float(v) for k, v in metrics.items()}, step=task.step, epoch=epoch)
                out.epochs.append({"steps": done - skip, "seconds": dt, "vol_per_s": n_vols / dt, "loss": loss})
            if (args.checkpoint_every_epochs and (epoch + 1) % args.checkpoint_every_epochs == 0
                    and epoch + 1 < args.max_epochs):  # the final epoch saves below
                out.checkpoint = checkpoint(epoch + 1)

    out.checkpoint = checkpoint(args.max_epochs)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    try:
        run(argv)
    finally:
        shutdown_distributed()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
