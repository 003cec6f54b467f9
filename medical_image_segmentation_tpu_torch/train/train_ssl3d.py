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
``--resume``, SIGTERM/SIGINT, the checkpoint cadence (the final one
after the last epoch) and the memory guard are ``train/loop.py``'s;
``--remat`` works as in ``train/train_ssl.py``. The encoder of the
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
import dataclasses
import sys
from typing import List, Optional, Sequence, Tuple

import torch

from medical_image_segmentation_tpu_torch.data.device_feed import build_corpus, volume_batches
from medical_image_segmentation_tpu_torch.data.volumes import UnlabeledVolumeDataset, VolumeLoader
from medical_image_segmentation_tpu_torch.ops.augment3d import byol_two_view_augment_3d
from medical_image_segmentation_tpu_torch.parallel.mesh import shutdown_distributed
from medical_image_segmentation_tpu_torch.train.byol_task import BYOLTask
from medical_image_segmentation_tpu_torch.train.loop import (
    FitRun, TrainLoop, add_common_flags, epoch_steps, start_ranks,
)
from medical_image_segmentation_tpu_torch.train.train_segmentation3d import DEVICE_CACHE_SINGLE


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Volumetric BYOL pretraining (PyTorch/CUDA port)")
    ap.add_argument("--images_dir", required=True, help="directory of unlabeled .nii/.nii.gz volumes")
    ap.add_argument("--volume_size", type=int, nargs=3, default=(64, 96, 96), metavar=("D", "H", "W"))
    ap.add_argument("--crop_size", type=int, nargs=3, default=(32, 64, 64), metavar=("D", "H", "W"),
                    help="view crop (each dim a multiple of 2^(len(features)-1))")
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--max_epochs", type=int, default=100)
    ap.add_argument("--warmup_epochs", type=int, default=10)
    ap.add_argument("--features", type=int, nargs="+", default=(32, 64, 128, 256))
    ap.add_argument("--hidden_dim", type=int, default=4096)
    ap.add_argument("--projection_dim", type=int, default=256)
    ap.add_argument("--ema_momentum", type=float, default=0.99)
    ap.add_argument("--mean", type=float, default=0.2089)
    ap.add_argument("--std", type=float, default=0.2109)
    ap.add_argument("--checkpoint_dir", default="checkpoints/ssl3d")
    ap.add_argument("--checkpoint_every_epochs", type=int, default=1)
    ap.add_argument("--limit_steps_per_epoch", type=int, default=0)
    ap.add_argument("--remat", action="store_true", help="checkpoint each double-conv block of both towers")
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
    add_common_flags(ap)
    return ap.parse_args(argv)


@dataclasses.dataclass
class SSL3DRun(FitRun):
    """``FitRun``'s fields, the rate ``vol_per_s``, and: every step's loss
    (0-d device tensors) and ``(step, lr, tau)``, and the corpus's bytes on
    the device."""

    losses: List[torch.Tensor] = dataclasses.field(default_factory=list)
    schedule: List[Tuple[int, float, float]] = dataclasses.field(default_factory=list)
    corpus_bytes: int = 0


def run(argv: Optional[Sequence[str]] = None) -> SSL3DRun:
    args = parse_args(argv)
    proc, mesh = start_ranks(args.device, args.batch_size)
    device = proc.device
    shard = mesh.shard("data")
    per_rank = args.batch_size // shard[1]
    if args.device_cache and proc.world_size > 1:
        raise SystemExit(DEVICE_CACHE_SINGLE)
    volume_size, crop = tuple(args.volume_size), tuple(args.crop_size)

    ds = UnlabeledVolumeDataset(args.images_dir, target_shape=volume_size, cache=args.cache_volumes)
    loader = VolumeLoader(ds, per_rank, shuffle=True, seed=args.seed, num_hosts=shard[1], host_id=shard[0])
    steps_per_epoch = epoch_steps(args, len(loader), per_rank, f"the unlabeled set ({len(ds)} volumes)")

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
    out = SSL3DRun(task=task)
    loop = TrainLoop(args, proc, mesh, task, loader, steps_per_epoch, out)

    def augment(vols):
        return byol_two_view_augment_3d(loop.aug_gen, vols, out_size=crop, mean=(args.mean,), std=(args.std,),
                                        dtype=dtype, shard=shard)

    corpus = build_corpus(ds, device) if args.device_cache else None
    label = f"ssl3d train step (batch {per_rank} a rank)"
    if corpus is not None:
        out.corpus_bytes = corpus[0].numel() * corpus[0].element_size()
        print(f"device corpus cache: {len(ds)} volumes, {out.corpus_bytes / 2**30:.2f} GiB resident on the device",
              file=sys.stderr)
        label += f" on top of a {out.corpus_bytes / 2**30:.2f} GiB corpus kept on the device (in the peak)"
    loop.guard_memory(lambda: task.train_step(*augment(torch.zeros(per_rank, *volume_size, 1, device=device))),
                      label)

    def step(vols):
        metrics = task.train_step(*augment(vols))
        out.losses.append(metrics["loss"])
        out.schedule.append((task.step - 1, metrics["lr"], metrics["momentum"]))
        return metrics

    def end_epoch(epoch, metrics, record):
        if record and loop.logger:
            print(f"epoch {epoch}: loss={record['loss']:.4f} tau={metrics['momentum']:.4f} "
                  f"{record['vol_per_s']:.1f} vol/s", file=sys.stderr)
            loop.log(metrics, epoch)

    loop.run(lambda start, stop: volume_batches(loader, device, corpus, start, stop), step, end_epoch,
             rate="vol_per_s", loss="loss", checkpoint_last=False)
    if not out.stopped:
        loop.checkpoint(args.max_epochs)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    try:
        run(argv)
    finally:
        shutdown_distributed()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
