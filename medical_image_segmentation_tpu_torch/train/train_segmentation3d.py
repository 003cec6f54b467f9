"""Volumetric (3D U-Net) segmentation training entry point
(``mis-train-segmentation3d-torch``): fit → val → test → final checkpoint.

Port of ``train/train_segmentation3d.py:36-437``: the same flags and
defaults, plus an explicit ``--device`` (default ``cuda``, which raises
without a card). Per step: ``data/volumes.py`` reads and centre-fits
Medical Decathlon NIfTI volumes on the host to ``--volume_size`` →
``data/device_feed.py`` copies the batch to the device one ahead →
``ops/augment3d.py`` crops, flips and jitters it there to ``--crop_size``
→ one ``Segmentation3DTask.train_step``.

- ``--device_cache`` puts every split's fitted volumes (f32) and masks
  (uint8) on the device once and gathers the batches there by index: the
  same batches, bit for bit, with only the indices crossing. The corpora
  are built before the memory guard's probe step, whose peak is the whole
  process's, so the guard counts them.
- ``--cache_volumes`` keeps the fitted volumes in host memory instead.
- ``--ssl_checkpoint`` grafts the online backbone of a volumetric BYOL
  ``.pt`` (``mis-train-ssl3d-torch``) into the encoder before training.
- val runs every ``--eval_every_epochs`` epochs and on the last; 0 means no
  val pass at all. Test always runs at the end. Metrics are the mean over
  batches of each batch's Dice, IoU and loss, on the centre crop.
- ``--full_res_window D H W`` then scores the test volumes (the train
  volumes when there is no test split) at their native size through
  sliding-window blending.
- ``--resume``, SIGTERM/SIGINT, the checkpoint cadence and the memory
  guard are ``train/loop.py``'s, as in ``train/train_segmentation.py``,
  which ``--remat`` follows too; a batch larger than the train split is
  refused, since every epoch would run no step.

``--arch nnunet3d --classes K`` trains nnU-Net's 3d_fullres network
(``models/plain_unet3d.py``) on the volumes' integer label maps (K
classes, background included) with its recipe (SGD with Nesterov
momentum 0.99 and the gradient norm clipped to 12, the poly schedule);
flags left unset take nnU-Net's values (``--features 32 64 128 256 320
320``, ``--loss dice_ce_ds``, ``--learning_rate 0.01``, ``--weight_decay
3e-5``); under ``--arch unet3d`` (the default) every flag keeps its
default. bf16 autocast stands in for nnU-Net's fp16 with a gradient
scaler. It refuses ``--space_shards`` above 1, ``--ssl_checkpoint`` and
``--full_res_window``.

``--arch swin_unetr --classes K`` trains Swin UNETR (``models/swin_unetr.py``
at its published size: feature size 48, depths 2 2 2 2, heads 3 6 12 24,
window 7; crops a multiple of 32 on each axis) on the integer label maps
with its fine-tuning recipe (Tang et al.'s CT settings): MONAI's squared
softmax Dice + CE, AdamW, the warmup-cosine schedule ending at 0; flags
left unset take its values (``--learning_rate 1e-4``, ``--weight_decay
1e-5``, ``--warmup_epochs 50``, ``--max_epochs 5000``, ``--min_lr 0``). It
refuses ``--features`` (its widths are the published ones), ``--loss``
(its loss is the recipe's), ``--space_shards`` above 1,
``--ssl_checkpoint`` and ``--full_res_window``.

Several processes (torchrun or SLURM, ``parallel/mesh.py``): the global
``--batch_size`` divides by the data shards; each rank reads its data
shard of the volumes (``VolumeLoader(num_hosts=data shards,
host_id=data index)``) and keeps its rows of the global augmentation
draws; Dice sums (and BatchNorm statistics under ``--norm batch``) are the
global batch's, gradients are averaged; only rank 0 logs, writes
checkpoints and runs ``--full_res_window``. ``--device_cache`` stays
single-process, as in the JAX trainer.

``--space_shards S`` lays the N ranks out as ``("data", "space") = (N/S,
S)`` (``train_segmentation3d.py:117-126``): the S ranks of a space group
read the same volumes and draws, and each trains on its depth slab of
every crop (``train/seg3d_task.py``: halo-exchanged convolutions, GroupNorm
statistics over the group). The crop depth must divide by S ·
2^(len(features) − 1), so that every slab at every level has an even
depth. Rank 0's checkpoint holds the whole replicated weights: it resumes
under any ``--space_shards``. ``--full_res_window`` in a one-process run
spreads its window batches over every local device
(``parallel/replicas.py``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from medical_image_segmentation_tpu_torch.core.checkpoint import load_byol3d_encoder_into_unet3d, load_checkpoint
from medical_image_segmentation_tpu_torch.data.device_feed import build_corpus, volume_batches
from medical_image_segmentation_tpu_torch.data.volumes import DecathlonVolumeDataset, VolumeLoader
from medical_image_segmentation_tpu_torch.eval.sliding_window import sliding_window_predict_3d
from medical_image_segmentation_tpu_torch.ops.augment import apply_hu_windows, parse_hu_windows
from medical_image_segmentation_tpu_torch.ops.augment3d import segmentation_augment_3d
from medical_image_segmentation_tpu_torch.ops.dice import dice_coefficient, jaccard_index, post_process_masks
from medical_image_segmentation_tpu_torch.parallel.mesh import depth_slab, shutdown_distributed
from medical_image_segmentation_tpu_torch.parallel.replicas import local_devices
from medical_image_segmentation_tpu_torch.train.loop import (
    FitRun, TrainLoop, add_common_flags, epoch_steps, start_ranks,
)
from medical_image_segmentation_tpu_torch.train.seg3d_task import Segmentation3DTask

DEVICE_CACHE_SINGLE = ("--device_cache is single-process only (a per-host corpus would desynchronize the global "
                       "shuffle); use --cache_volumes on multi-host runs")


# nnU-Net's and Swin UNETR's recipes: what --arch nnunet3d and --arch swin_unetr take for the flags left unset
NNUNET_DEFAULTS = dict(learning_rate=0.01, weight_decay=3e-5, features=(32, 64, 128, 256, 320, 320),
                       loss="dice_ce_ds")
SWIN_DEFAULTS = dict(learning_rate=1e-4, weight_decay=1e-5, warmup_epochs=50, max_epochs=5000, min_lr=0.0)
ARCH_DEFAULTS = {"nnunet3d": NNUNET_DEFAULTS, "swin_unetr": SWIN_DEFAULTS}
NNUNET_MOMENTUM = 0.99
_UNSET = object()


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="3D U-Net volumetric segmentation (PyTorch/CUDA port)")
    ap.add_argument("--images_dir", required=True)
    ap.add_argument("--masks_dir", required=True)
    ap.add_argument("--split_file", default=None)
    ap.add_argument("--volume_size", type=int, nargs=3, default=(64, 96, 96), metavar=("D", "H", "W"),
                    help="host-side pad/crop shape of every volume")
    ap.add_argument("--crop_size", type=int, nargs=3, default=(32, 64, 64), metavar=("D", "H", "W"),
                    help="device-side random train crop (centre crop at eval)")
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--max_epochs", type=int, default=50)
    ap.add_argument("--arch", default="unet3d", choices=["unet3d", "nnunet3d", "swin_unetr"],
                    help="unet3d (the JAX package's 3D U-Net), nnunet3d (nnU-Net's 3d_fullres PlainConvUNet, "
                         "multi-class, deep supervision) or swin_unetr (Swin UNETR, multi-class); under the last "
                         "two the flags left unset take their recipe's values")
    ap.add_argument("--classes", type=int, default=1,
                    help="classes of the label maps, background included (nnunet3d, swin_unetr: at least 2)")
    ap.add_argument("--min_lr", type=float, default=1e-2)
    ap.add_argument("--warmup_epochs", type=int, default=10)
    ap.add_argument("--features", type=int, nargs="+", default=(32, 64, 128, 256))
    ap.add_argument("--norm", default="group", choices=["group", "batch"])
    ap.add_argument("--mean", type=float, default=0.2089, help="dataset mean on the 0-1 scale")
    ap.add_argument("--std", type=float, default=0.2109)
    ap.add_argument("--loss", default="dice", choices=["dice", "dice_ce", "dice_ce_ds"])
    ap.add_argument("--hu_windows", default=None, metavar="L:W,L:W,…",
                    help="fixed display windows (level:width on the 0-1 intensity scale) stacked as input "
                         "channels; applied at train, eval and sliding-window eval")
    ap.add_argument("--space_shards", type=int, default=1, metavar="N",
                    help="shard each crop's depth over N ranks of a (data, space) mesh (halo-exchanged 3D "
                         "convolutions); the ranks must divide by N")
    ap.add_argument("--checkpoint_dir", default="checkpoints/seg3d")
    ap.add_argument("--checkpoint_every_epochs", type=int, default=1,
                    help="periodic checkpoint cadence (0 = final checkpoint only)")
    ap.add_argument("--ssl_checkpoint", default=None,
                    help="volumetric BYOL .pt of mis-train-ssl3d-torch (or its directory: latest step) to "
                         "initialize the encoder from")
    ap.add_argument("--full_res_window", type=int, nargs=3, default=None, metavar=("D", "H", "W"),
                    help="after training, evaluate the test volumes at native resolution through overlapped "
                         "sliding-window blending (eval/sliding_window.py)")
    ap.add_argument("--eval_every_epochs", type=int, default=1,
                    help="run the val split every N epochs and on the last one; 0 = no val pass at all "
                         "(test always runs at the end)")
    ap.add_argument("--limit_steps_per_epoch", type=int, default=0)
    ap.add_argument("--remat", action="store_true", help="checkpoint each double-conv block")
    ap.add_argument("--cache_volumes", action="store_true",
                    help="keep the fitted volumes in host memory between epochs (len(ds)·∏volume_size·8 "
                         "bytes; NIfTI gunzip and parse otherwise repeat every epoch)")
    ap.add_argument("--device_cache", action="store_true",
                    help="put each split's volumes and masks on the device once and gather the batches there "
                         "by index: train and val then move no volume from host to device "
                         "(len(ds)·∏volume_size·5 bytes of device memory, which the memory guard counts)")
    ap.add_argument("--force_hbm", action="store_true",
                    help="run even if the probe step, on top of what already lives on the card, does not fit "
                         "its memory: the guard then warns instead of refusing")
    add_common_flags(ap)
    unset = {k for d in ARCH_DEFAULTS.values() for k in d}
    args = ap.parse_args(argv, argparse.Namespace(**{k: _UNSET for k in unset}))
    given = {flag: getattr(args, flag) is not _UNSET for flag in ("features", "loss")}
    recipe = ARCH_DEFAULTS.get(args.arch, {})
    for key in unset:  # a flag left unset: its default, or the arch's recipe's value
        if getattr(args, key) is _UNSET:
            setattr(args, key, recipe.get(key, ap.get_default(key)))
    if args.arch in ARCH_DEFAULTS:
        refused = [("--space_shards", args.space_shards > 1), ("--ssl_checkpoint", args.ssl_checkpoint),
                   ("--full_res_window", args.full_res_window)]
        if args.arch == "swin_unetr":
            refused[:0] = [("--features", given["features"]), ("--loss", given["loss"])]
        for flag, bad in refused:
            if bad:
                ap.error(f"--arch {args.arch} does not support {flag}")
        if args.classes < 2:
            ap.error(f"--arch {args.arch} needs --classes of at least 2 (background included)")
    elif args.classes != 1:
        ap.error("--arch unet3d trains one sigmoid class: --classes must be 1")
    return args


@dataclasses.dataclass
class Seg3DRun(FitRun):
    """``FitRun``'s fields, the rate ``vol_per_s``, and: the weights it
    started from (after the graft; CPU copies), every step's loss (0-d
    device tensors) and ``(step, lr)``, the last val, the test and the
    full-res metrics, and the bytes of the corpora on the device."""

    start_state: Dict[str, torch.Tensor]
    losses: List[torch.Tensor] = dataclasses.field(default_factory=list)
    schedule: List[Tuple[int, float]] = dataclasses.field(default_factory=list)
    val: Optional[Dict[str, float]] = None
    test: Optional[Dict[str, float]] = None
    full_res: Optional[Dict[str, float]] = None
    corpus_bytes: int = 0


def run(argv: Optional[Sequence[str]] = None, devices: Optional[Sequence] = None) -> Seg3DRun:
    """Train; returns what the run did. ``devices``: where a one-process
    ``--full_res_window`` runs its window batches (default: every local
    device of ``--device``)."""
    args = parse_args(argv)
    proc, mesh = start_ranks(args.device, args.batch_size, space_shards=args.space_shards)
    device, main_rank = proc.device, proc.is_main
    if args.space_shards > 1:
        if args.crop_size[0] % args.space_shards:
            raise SystemExit("--crop_size depth must be divisible by --space_shards")
        levels = 2 ** (len(args.features) - 1)
        if args.crop_size[0] % (args.space_shards * levels):
            raise SystemExit(f"--crop_size depth {args.crop_size[0]} must be divisible by --space_shards "
                             f"{args.space_shards} x {levels} (2^(len(features) - 1)): every depth slab at every "
                             "level of the U-Net needs an even depth")
    shard = mesh.shard("data")
    slab = depth_slab(mesh, args.crop_size[0])
    per_rank = args.batch_size // shard[1]
    if args.device_cache and proc.world_size > 1:
        raise SystemExit(DEVICE_CACHE_SINGLE)
    volume_size, crop = tuple(args.volume_size), tuple(args.crop_size)
    labels = args.arch in ARCH_DEFAULTS

    def dataset(split: str) -> DecathlonVolumeDataset:
        return DecathlonVolumeDataset(args.images_dir, args.masks_dir, target_shape=volume_size,
                                      split_file=args.split_file, split=split, cache=args.cache_volumes,
                                      labels=labels)

    ds_train = dataset("train")
    train_loader = VolumeLoader(ds_train, per_rank, shuffle=True, seed=args.seed, num_hosts=shard[1],
                                host_id=shard[0])
    steps_per_epoch = epoch_steps(args, len(train_loader), per_rank, f"the train split ({len(ds_train)} volumes)")

    hu_windows = parse_hu_windows(args.hu_windows, value_max=1.0) if args.hu_windows else ()
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    task = Segmentation3DTask(
        n_classes=args.classes, in_channels=len(hu_windows) or 1, features=tuple(args.features), norm=args.norm,
        learning_rate=args.learning_rate, weight_decay=args.weight_decay,
        momentum=NNUNET_MOMENTUM if args.arch == "nnunet3d" else 0.9, warmup_epochs=args.warmup_epochs,
        max_epochs=args.max_epochs, min_lr=args.min_lr, steps_per_epoch=steps_per_epoch, loss=args.loss,
        dtype=dtype, device=device, remat=args.remat, mesh=mesh, arch=args.arch,
    )
    task.init(args.seed)
    if args.ssl_checkpoint:
        byol = load_checkpoint(args.ssl_checkpoint)
        task.model.load_state_dict(load_byol3d_encoder_into_unet3d(task.model.state_dict(), byol["online"]))
        print(f"initialized 3D encoder from {args.ssl_checkpoint}", file=sys.stderr)
    out = Seg3DRun(task=task, start_state={k: v.detach().cpu().clone() for k, v in task.model.state_dict().items()})
    loop = TrainLoop(args, proc, mesh, task, train_loader, steps_per_epoch, out)

    def augment(vols, msks, train: bool):  # eval takes whole crops, replicated over space
        return segmentation_augment_3d(loop.aug_gen if train else None, vols, msks, out_size=crop,
                                       mean=(args.mean,), std=(args.std,), train=train, dtype=dtype,
                                       hu_windows=hu_windows, shard=shard, depth=slab if train else slice(None),
                                       labels=labels)

    # the eval splits are set up once, before the memory guard, so that its
    # probe runs on top of every corpus the run will keep on the card
    def eval_context(split: str):
        try:
            ds = dataset(split)
        except ValueError:
            return None
        loader = VolumeLoader(ds, per_rank, shuffle=False, drop_last=False, num_hosts=shard[1], host_id=shard[0])
        return loader, (build_corpus(ds, device) if args.device_cache else None)

    train_corpus = build_corpus(ds_train, device) if args.device_cache else None
    eval_ctx = {split: eval_context(split) for split in (("val",) if args.eval_every_epochs else ()) + ("test",)}
    if args.device_cache:
        corpora = [train_corpus] + [ctx[1] for ctx in eval_ctx.values() if ctx]
        out.corpus_bytes = sum(t.numel() * t.element_size() for c in corpora for t in c)
        print(f"device corpus cache: {len(corpora)} splits, {out.corpus_bytes / 2**30:.2f} GiB resident on the "
              "device", file=sys.stderr)

    def probe():
        vols = torch.zeros(per_rank, *volume_size, 1, device=device)
        task.train_step(*augment(vols, vols, train=True))

    label = f"seg3d train step (batch {per_rank} a rank)"
    if out.corpus_bytes:
        label += f" on top of {out.corpus_bytes / 2**30:.2f} GiB of corpora kept on the device (in the peak)"
    loop.guard_memory(probe, label)

    def run_eval(split: str) -> Optional[Dict[str, float]]:
        ctx = eval_ctx.get(split)
        if ctx is None:
            return None
        loader, corpus = ctx
        aggr = {"loss": 0.0, "dice": 0.0, "iou": 0.0}
        n = 0
        with contextlib.closing(volume_batches(loader, device, corpus)) as batches:
            for vols, msks in batches:
                m = task.eval_step(*augment(vols, msks, train=False))
                for k in aggr:
                    aggr[k] += float(m[k])
                n += 1
        return {f"{split}/{k}": v / n for k, v in aggr.items()}

    def step(vols, msks):
        metrics = task.train_step(*augment(vols, msks, train=True))
        out.losses.append(metrics["train/loss"])
        out.schedule.append((task.step - 1, metrics["lr"]))
        return metrics

    def end_epoch(epoch, metrics, record):
        if record and loop.logger:
            print(f"epoch {epoch}: train/loss={record['loss']:.4f} {record['vol_per_s']:.1f} vol/s", file=sys.stderr)
            loop.log(metrics, epoch)
        if args.eval_every_epochs and ((epoch + 1) % args.eval_every_epochs == 0 or epoch + 1 == args.max_epochs):
            out.val = run_eval("val")
            loop.report(f"epoch {epoch}: ", out.val, epoch)

    loop.run(lambda start, stop: volume_batches(train_loader, device, train_corpus, start, stop), step, end_epoch,
             rate="vol_per_s", loss="train/loss", checkpoint_last=False)
    if out.stopped:
        return out

    out.test = run_eval("test")
    loop.report("test: ", out.test, args.max_epochs)
    loop.checkpoint(args.max_epochs)

    if args.full_res_window and main_rank:
        ds_test = eval_ctx["test"][0].ds if eval_ctx["test"] else ds_train  # no test split: the train volumes
        if devices is None:  # a one-process run uses every local device (JAX: mesh=mesh if nproc == 1)
            devices = local_devices(args.device) if proc.world_size == 1 else [device]
        out.full_res = _full_res_test(task, ds_test, tuple(args.full_res_window), args.mean, args.std, hu_windows,
                                      device, devices)
        loop.log(out.full_res, args.max_epochs)
    return out

def _full_res_test(task, ds, window, mean: float, std: float, hu_windows, device,
                   devices: Sequence = ()) -> Dict[str, float]:
    """Mean Dice and IoU of every volume of ``ds`` at its native size,
    through sliding-window blending of the task's eval-mode logits on the
    representation it trained on (windows, then normalize); the window
    batches split over ``devices`` when it names more than one."""
    window_fn = task.replicas(devices) if len(devices) > 1 else task.logits
    dices, ious = [], []
    for i in range(len(ds)):
        vol, msk = ds.raw(i)
        x = (apply_hu_windows(torch.from_numpy(vol).to(device), hu_windows) - mean) / std
        pred = post_process_masks(sliding_window_predict_3d(window_fn, x, window=window, devices=devices))
        target = torch.from_numpy(msk).to(device)
        dices.append(float(dice_coefficient(pred, target)))
        ious.append(float(jaccard_index(pred, target)))
    dice, iou = sum(dices) / len(dices), sum(ious) / len(ious)
    print(f"full-res sliding-window test: dice={dice:.4f} iou={iou:.4f} ({len(dices)} volumes, window {window})",
          file=sys.stderr)
    return {"test/full_res_dice": dice, "test/full_res_iou": iou}


def main(argv: Optional[Sequence[str]] = None) -> int:
    try:
        run(argv)
    finally:
        shutdown_distributed()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
