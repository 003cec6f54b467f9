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

Around the loop, as in the JAX trainer:

- ``--run_single_validation`` loads ``--checkpoint_path`` (or the latest
  step of ``--checkpoint_dir``) and runs one val pass, no training;
- ``--resume`` restores the latest checkpoint: the task, the loader's
  epoch and the augmentation generator; the batches a mid-epoch checkpoint
  already trained are skipped without drawing anything;
- the memory guard runs one probe step at the run's shapes before
  training and refuses a run that does not fit the card
  (``core/hbm.py``; ``--skip_hbm_check``, ``--force_hbm``);
- SIGTERM/SIGINT: the current step finishes, a checkpoint is written and
  the run returns (``train/resilience.py``);
- ``--profile N`` traces the first N steps (``core/profiling.py``) and
  prints the loader's stage timers each epoch;
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
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from medical_image_segmentation_tpu_torch.core.checkpoint import (
    load_checkpoint, resume_latest, save_rank0, trainer_state,
)
from medical_image_segmentation_tpu_torch.core.hbm import guard_step, preserved, rank_hbm_capacity
from medical_image_segmentation_tpu_torch.core.metrics_logger import CSVMetricsLogger
from medical_image_segmentation_tpu_torch.core.profiling import StepProfiler
from medical_image_segmentation_tpu_torch.data.datamodules import get_datamodule
from medical_image_segmentation_tpu_torch.data.device_feed import device_batches
from medical_image_segmentation_tpu_torch.eval.knn import KNNEvaluator
from medical_image_segmentation_tpu_torch.ops.augment import precrop_supported, two_view_augment, two_view_tail_augment
from medical_image_segmentation_tpu_torch.ops.fused_augment import fused_supported, fused_two_view_augment
from medical_image_segmentation_tpu_torch.parallel.mesh import (
    Mesh, Process, initialize_distributed, make_mesh, shutdown_distributed,
)
from medical_image_segmentation_tpu_torch.parallel.tp import check_model_parallel
from medical_image_segmentation_tpu_torch.train.byol_task import BYOLTask
from medical_image_segmentation_tpu_torch.train.resilience import PreemptionGuard


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
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in --checkpoint_dir: weights, optimizer, step, "
                         "data order and augmentation stream")
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
    ap.add_argument("--bf16", action="store_true", default=True)
    ap.add_argument("--fp32", dest="bf16", action="store_false")
    ap.add_argument("--aug_recipe", default=None, choices=["ffcv", "torchvision"])
    ap.add_argument("--window_prob", type=float, default=None)
    ap.add_argument("--host_precrop", action="store_true",
                    help="RandomResizedCrop in the loader's host workers: ship 2 crop² views instead of "
                         "the full images and run only the elementwise tail on the device "
                         "(blur-free recipes only)")
    ap.add_argument("--remat", action="store_true",
                    help="checkpoint each residual block: less activation memory, ~1/3 more backward work")
    ap.add_argument("--skip_hbm_check", action="store_true",
                    help="skip the pre-flight memory guard (one probe step, core/hbm.py)")
    ap.add_argument("--force_hbm", action="store_true",
                    help="run even if the probe step does not fit the card's memory")
    ap.add_argument("--model_parallel", type=int, default=1, metavar="N",
                    help=">1: split the projector/predictor MLP heads over N ranks of a (data, model) mesh "
                         "(parallel/tp.py); 1 = pure data parallel")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="trace the first N steps with torch.profiler into <log_dir>/trace and print the "
                         "loader's stage timers each epoch")
    return ap.parse_args(argv)


_UNPORTED = ()  # every flag of the JAX trainer is ported


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


def start_ranks(device: str, batch_size: int, model_parallel: int = 1, hidden_dim: int = 0,
                space_shards: int = 1) -> Tuple[Process, Mesh]:
    """Join the launch's process group (``parallel/mesh.py``) and lay its
    ranks out: ``("data",)``; ``("data", "model")`` with ``model_parallel``
    ranks a model group; or ``("data", "space")`` with ``space_shards``
    ranks a space group (``train_segmentation3d.py:117-126``).
    ``batch_size`` is the global batch and must divide by the data shards:
    the world size (``train_ssl.py:143-155``), or the world over
    ``space_shards``."""
    proc = initialize_distributed(device)
    data_shards = proc.world_size
    if model_parallel > 1:
        check_model_parallel(proc.world_size, model_parallel, hidden_dim)
        mesh = make_mesh(("data", "model"), (proc.world_size // model_parallel, model_parallel), device=proc.device)
    elif space_shards > 1:
        if proc.world_size % space_shards:
            raise SystemExit(f"--space_shards {space_shards} must divide the device count {proc.world_size}")
        data_shards = proc.world_size // space_shards
        mesh = make_mesh(("data", "space"), (data_shards, space_shards), device=proc.device)
    else:
        mesh = make_mesh(device=proc.device)
    if batch_size % data_shards:
        what = f"the data shards {data_shards}" if space_shards > 1 else f"the device count {proc.world_size}"
        raise SystemExit(f"--batch_size {batch_size} must be divisible by {what}")
    return proc, mesh


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
class TrainRun:
    """What a run did: the task at its end; one record per epoch (``steps``,
    ``seconds``, ``img_per_s``, ``loss``); ``(step, lr, tau)`` of every
    step it trained; whether the fused kernel made the views; the last val
    metrics and KNN accuracy; the step it resumed from and the batches it
    skipped; the memory guard's report; the trace file; which host reader
    served the train store ("native" or "python"); and whether a signal
    stopped it."""

    task: object
    epochs: List[Dict[str, float]]
    used_kernel: bool
    schedule: List[Tuple[int, float, float]] = dataclasses.field(default_factory=list)
    val: Optional[Dict[str, float]] = None
    knn_acc: Optional[float] = None
    resumed_from: Optional[int] = None
    skipped: int = 0
    hbm: Optional[dict] = None
    trace: Optional[str] = None
    reader: str = ""
    stopped: bool = False


def run(argv: Optional[Sequence[str]] = None) -> TrainRun:
    args = parse_args(argv)
    refuse_unported(args)
    proc, mesh = start_ranks(args.device, args.batch_size, args.model_parallel, args.hidden_dim)
    device = proc.device
    shard = mesh.shard("data")
    per_rank = args.batch_size // shard[1]

    if device.type == "cuda":
        torch.backends.cudnn.benchmark = True
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
        return TrainRun(task=task, epochs=[], used_kernel=False, val=val)

    train_loader = dm.train_loader(per_rank, num_threads=args.num_workers, seed=args.seed, shard=shard,
                                   distributed=shard[1] > 1, precrop=precrop)
    with contextlib.closing(train_loader):
        steps_per_epoch = len(train_loader)
        if steps_per_epoch == 0:
            raise SystemExit(f"--batch_size {args.batch_size} (per rank {per_rank}) exceeds the train set: every "
                             "epoch would run 0 steps")
        if args.limit_steps_per_epoch:
            steps_per_epoch = min(steps_per_epoch, args.limit_steps_per_epoch)
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
    aug_gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    has_labels = dm.has_train_labels

    def augment(imgs):
        if args.host_precrop:
            return two_view_tail_augment(aug_gen, imgs, cfg1, cfg2, mean, std, dtype, shard)
        if use_kernel:
            return fused_two_view_augment(imgs, cfg1, cfg2, mean, std, dtype, generator=aug_gen, shard=shard)
        return two_view_augment(aug_gen, imgs, cfg1, cfg2, mean, std, dtype, shard)

    out = TrainRun(task=task, epochs=[], used_kernel=use_kernel,
                   reader="native" if train_loader._native is not None else "python")
    start_epoch = 0
    resumed = resume_latest(args.checkpoint_dir, task, train_loader, aug_gen, steps_per_epoch) if args.resume else None
    if resumed:
        out.resumed_from, start_epoch, out.skipped = resumed

    # the memory guard's probe: one step at the shapes the loader ships this
    # rank (sample-major views under --host_precrop, full stored images
    # otherwise), against this rank's share of the card
    shape = ((2 * per_rank, dm.crop_size, dm.crop_size, train_loader.channels) if args.host_precrop
             else (per_rank, *train_loader.out_hw, train_loader.channels))
    img_dtype = torch.from_numpy(np.zeros(0, train_loader.dtype)).dtype

    def probe():
        imgs = torch.zeros(shape, dtype=img_dtype, device=device)
        labels = torch.zeros(per_rank, dtype=torch.int64, device=device) if has_labels else None
        with preserved(task, aug_gen):
            task.train_step(*augment(imgs), labels)

    out.hbm = guard_step(probe, label=f"ssl train step (arch {args.arch}, batch {per_rank} a rank)",
                         skip=args.skip_hbm_check, force=args.force_hbm, device=device,
                         capacity=rank_hbm_capacity(proc.device, proc.ranks_per_device))

    def checkpoint(next_epoch: int) -> None:
        save_rank0(args.checkpoint_dir, trainer_state(task, next_epoch, aug_gen), task.step, mesh)

    logger = CSVMetricsLogger(args.log_dir) if proc.is_main else None
    prof = StepProfiler(args.profile if proc.is_main else 0, args.log_dir, device)
    try:
        with PreemptionGuard(mesh) as guard:
            for epoch in range(start_epoch, args.max_epochs):
                skip = out.skipped if epoch == start_epoch else 0
                t0 = time.time()
                n_imgs, metrics = 0, {}
                with contextlib.closing(device_batches(train_loader, device)) as batches:
                    for i, (imgs, labels) in enumerate(batches):
                        if i >= steps_per_epoch:
                            break
                        if i < skip:
                            continue  # trained before the checkpoint this run resumed from
                        metrics = task.train_step(*augment(imgs), labels if has_labels else None)
                        out.schedule.append((task.step - 1, metrics["lr"], metrics["momentum"]))
                        n_imgs += args.batch_size
                        prof.tick()
                        if guard.stop_agreed(i):
                            checkpoint(epoch if i + 1 < steps_per_epoch else epoch + 1)
                            out.stopped = True
                            return out
                        if logger and i % 50 == 0:
                            logger.log({k: float(v) for k, v in metrics.items()}, step=task.step, epoch=epoch)
                if guard.stop_agreed(at_epoch_end=True):  # a signal during the epoch's last batches or its end
                    checkpoint(epoch + 1)
                    out.stopped = True
                    return out
                if metrics:
                    last_loss = float(metrics["loss"])  # waits for the epoch's last step
                    dt = time.time() - t0
                    if proc.is_main:
                        print(f"epoch {epoch}: loss={last_loss:.4f} {n_imgs / dt:.0f} img/s "
                              f"({n_imgs / dt / proc.world_size:.0f}/rank) lr={metrics['lr']:.4f} "
                              f"tau={metrics['momentum']:.5f}", file=sys.stderr)
                    out.epochs.append({"steps": n_imgs // args.batch_size, "seconds": dt,
                                       "img_per_s": n_imgs / dt, "loss": last_loss})
                    if args.profile and proc.is_main:
                        print(f"loader stages (epoch {epoch}):\n{train_loader.timers.report(reset=True)}",
                              file=sys.stderr)
                if args.val_every_epochs and (epoch + 1) % args.val_every_epochs == 0:
                    _validate_epoch(task, dm, args, device, logger, epoch, out, mesh)
                if args.knn_every_epochs and (epoch + 1) % args.knn_every_epochs == 0:
                    _knn_epoch(task, dm, args, device, logger, epoch, out, mesh)
                if args.checkpoint_every_epochs and (epoch + 1) % args.checkpoint_every_epochs == 0:
                    checkpoint(epoch + 1)
    finally:
        prof.stop()  # writes the trace on every exit path
        out.trace = prof.path
    return out


def _validate(task, dm, args, device, val_loader) -> Optional[Dict[str, float]]:
    """Mean over ``val_loader``'s batches of the probe's val metrics (the
    loader is closed); None if it had no batch."""
    aggr = {"val/loss": 0.0, "val/acc@1": 0.0, "val/acc@5": 0.0}
    n_b = 0
    with contextlib.closing(val_loader), contextlib.closing(device_batches(val_loader, device)) as batches:
        for imgs, labels in batches:
            m = task.val_step(_val_preprocess(imgs, dm, args.val_full_image), labels)
            for k in aggr:
                aggr[k] += float(m[k])
            n_b += 1
    return {k: v / n_b for k, v in aggr.items()} if n_b else None


def _validate_epoch(task, dm, args, device, logger, epoch, out: TrainRun, mesh: Mesh) -> None:
    shard = mesh.shard("data")
    try:
        val_loader = dm.val_loader(args.batch_size // shard[1], num_threads=args.num_workers, shard=shard)
    except FileNotFoundError:
        return
    out.val = _validate(task, dm, args, device, val_loader)
    if out.val and logger:
        print(f"epoch {epoch}: " + " ".join(f"{k}={v:.4f}" for k, v in out.val.items()), file=sys.stderr)
        logger.log(out.val, step=task.step, epoch=epoch)


def _knn_epoch(task, dm, args, device, logger, epoch, out: TrainRun, mesh: Mesh) -> None:
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
            out.knn_acc = ev.evaluate(lambda x: task.embed_step(_val_preprocess(x, dm, args.val_full_image)),
                                      bank, val)
    if logger:
        print(f"epoch {epoch}: online_knn_val_acc={out.knn_acc:.4f}", file=sys.stderr)
        logger.log({"online_knn_val_acc": out.knn_acc}, step=task.step, epoch=epoch)



def main(argv: Optional[Sequence[str]] = None) -> int:
    try:
        run(argv)
    finally:
        shutdown_distributed()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
