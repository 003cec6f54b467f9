"""The training loop that the port's four trainers share.

``train_ssl.py``, ``train_ssl3d.py``, ``train_segmentation.py`` and
``train_segmentation3d.py`` each build their data, task and augmentation,
and hand ``TrainLoop.run`` three hooks: an epoch's batches, from the
resumed position up to the epoch's step count; one step on one batch,
returning its metrics; and the end of an epoch, where the trainer prints
its epoch line and runs its val, KNN or eval cadence. Around them the loop
does what every trainer does:

- set-up: ``start_ranks`` joins the launch's process group, lays out the
  mesh and turns on cuDNN's autotuner on a card; ``epoch_steps`` refuses a
  batch that leaves an epoch with no step and applies
  ``--limit_steps_per_epoch``; ``TrainLoop`` seeds the augmentation
  generator (``--seed`` + 1), restores the latest checkpoint under
  ``--resume`` and runs the memory guard's probe step (``core/hbm.py``);
- the epochs: SIGTERM/SIGINT, agreed across ranks
  (``train/resilience.py``), lets the step in flight finish, writes a
  checkpoint and ends the run; a resumed epoch skips the batches its
  checkpoint already trained; each epoch leaves a record ``{steps,
  seconds, <rate>, loss}`` taken once its last step has finished; a
  checkpoint every ``--checkpoint_every_epochs`` epochs; ``--profile N``
  traces the first N steps, the trace written on every exit path.

Only rank 0 logs (``CSVMetricsLogger``) and writes checkpoints.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import sys
import time
from typing import Callable, Dict, Iterator, List, Mapping, Optional, Tuple

import torch

from medical_image_segmentation_tpu_torch.core.checkpoint import resume_latest, save_rank0, trainer_state
from medical_image_segmentation_tpu_torch.core.hbm import guard_step, preserved, rank_hbm_capacity
from medical_image_segmentation_tpu_torch.core.metrics_logger import CSVMetricsLogger
from medical_image_segmentation_tpu_torch.core.profiling import StepProfiler
from medical_image_segmentation_tpu_torch.parallel.mesh import Mesh, Process, initialize_distributed, make_mesh
from medical_image_segmentation_tpu_torch.parallel.tp import check_model_parallel
from medical_image_segmentation_tpu_torch.train.resilience import PreemptionGuard


def add_common_flags(ap: argparse.ArgumentParser) -> None:
    """The flags that every trainer declares with one default, type and
    help."""
    ap.add_argument("--learning_rate", type=float, default=1.0)
    ap.add_argument("--weight_decay", type=float, default=1e-6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device; cuda raises if absent")
    ap.add_argument("--log_dir", default="logs")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in --checkpoint_dir: weights, optimizer, step, "
                         "data order and augmentation stream")
    ap.add_argument("--bf16", action="store_true", default=True)
    ap.add_argument("--fp32", dest="bf16", action="store_false")
    ap.add_argument("--skip_hbm_check", action="store_true",
                    help="skip the pre-flight memory guard (one probe step, core/hbm.py)")


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
    ``space_shards``. On a card, cuDNN picks its convolution algorithms by
    timing them."""
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
    if proc.device.type == "cuda":
        torch.backends.cudnn.benchmark = True
    return proc, mesh


def epoch_steps(args: argparse.Namespace, n_batches: int, per_rank: int, what: str) -> int:
    """The steps of an epoch: the train loader's ``n_batches``, capped by
    ``--limit_steps_per_epoch``. SystemExit when a batch of ``per_rank``
    rows leaves ``what`` (the train set) with no step."""
    if n_batches == 0:
        raise SystemExit(f"--batch_size {args.batch_size} (per rank {per_rank}) exceeds {what}: every epoch would "
                         "run 0 steps. Lower --batch_size to at most its size.")
    return min(n_batches, args.limit_steps_per_epoch) if args.limit_steps_per_epoch else n_batches


def batch_range(batches: Iterator, start: int, stop: int) -> Iterator:
    """Batches ``start`` up to ``stop`` of an epoch's iterator, which is
    closed on every exit path; the batches before ``start`` are read and
    dropped."""
    with contextlib.closing(batches):
        yield from itertools.islice(batches, start, stop)


@dataclasses.dataclass(kw_only=True)
class FitRun:
    """What the loop records of a run: the task at its end; one record per
    epoch (``steps``, ``seconds``, the rate, ``loss``); whether a signal
    stopped it; the step it resumed from and the batches it skipped; the
    memory guard's report; the last checkpoint written; and the trace file
    of ``--profile``."""

    task: object
    epochs: List[Dict[str, float]] = dataclasses.field(default_factory=list)
    stopped: bool = False
    resumed_from: Optional[int] = None
    skipped: int = 0
    hbm: Optional[dict] = None
    checkpoint: str = ""
    trace: Optional[str] = None


class TrainLoop:
    """One trainer's epochs over ``task``, recorded in ``out``. Resumes
    from the latest checkpoint of ``--checkpoint_dir`` under ``--resume``
    (``loader``'s epoch, the task and ``aug_gen``, the generator the
    trainer's augmentation draws from)."""

    def __init__(self, args: argparse.Namespace, proc: Process, mesh: Mesh, task, loader, steps_per_epoch: int,
                 out: FitRun):
        self.args, self.proc, self.mesh, self.task, self.out = args, proc, mesh, task, out
        self.steps_per_epoch = steps_per_epoch
        self.aug_gen = torch.Generator(device=proc.device).manual_seed(args.seed + 1)
        self.logger: Optional[CSVMetricsLogger] = None
        self.start_epoch = 0
        resumed = args.resume and resume_latest(args.checkpoint_dir, task, loader, self.aug_gen, steps_per_epoch)
        if resumed:
            out.resumed_from, self.start_epoch, out.skipped = resumed

    def guard_memory(self, step: Callable[[], object], label: str) -> None:
        """The memory guard: ``step`` once at the run's shapes, against this
        rank's share of the card; the task and the generator are put back
        after it."""
        def probe():
            with preserved(self.task, self.aug_gen):
                step()

        self.out.hbm = guard_step(probe, label=label, skip=self.args.skip_hbm_check, force=self.args.force_hbm,
                                  device=self.proc.device,
                                  capacity=rank_hbm_capacity(self.proc.device, self.proc.ranks_per_device))

    def checkpoint(self, next_epoch: int) -> str:
        """Rank 0 saves the task, ``next_epoch`` and the generator; every
        rank records the path (rank 0's, "" elsewhere)."""
        state = trainer_state(self.task, next_epoch, self.aug_gen)
        self.out.checkpoint = save_rank0(self.args.checkpoint_dir, state, self.task.step, self.mesh)
        return self.out.checkpoint

    def log(self, metrics: Mapping[str, object], epoch: int) -> None:
        if self.logger:
            self.logger.log(metrics, step=self.task.step, epoch=epoch)

    def report(self, prefix: str, metrics: Optional[Mapping[str, float]], epoch: int) -> None:
        """Rank 0 prints ``metrics`` after ``prefix`` and logs them."""
        if metrics and self.logger:
            print(prefix + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()), file=sys.stderr)
            self.log(metrics, epoch)

    def run(self, batches: Callable[[int, int], Iterator[tuple]], step: Callable[..., Mapping[str, torch.Tensor]],
            end_epoch: Callable[[int, Mapping[str, torch.Tensor], Optional[Dict[str, float]]], None], *,
            rate: str, loss: str, checkpoint_last: bool, log_every: int = 0, profile: int = 0) -> None:
        """Train from the resumed epoch to ``--max_epochs``.

        ``batches(start, stop)``: the current epoch's batches ``start`` up
        to ``stop``, a generator. ``step(*batch)``: one step, returning its
        metrics, of which ``loss`` names the one an epoch record keeps.
        ``end_epoch(epoch, metrics, record)``: after each epoch, with its
        last step's metrics and its record (None for an epoch with no
        step). The record's rate is ``rate``, samples of the global batch
        a second. ``checkpoint_last``: the periodic checkpoint also
        follows the last epoch. ``log_every`` > 0 logs a step's metrics
        every that many steps of an epoch. ``out.stopped`` tells whether
        a signal ended the run."""
        args, out = self.args, self.out
        self.logger = CSVMetricsLogger(args.log_dir) if self.proc.is_main else None
        prof = StepProfiler(profile if self.proc.is_main else 0, args.log_dir, self.proc.device)
        try:
            with PreemptionGuard(self.mesh) as guard:

                def stopped(next_epoch: int, **at) -> bool:
                    out.stopped = guard.stop_agreed(**at)
                    if out.stopped:
                        self.checkpoint(next_epoch)
                    return out.stopped

                for epoch in range(self.start_epoch, args.max_epochs):
                    skip = out.skipped if epoch == self.start_epoch else 0
                    t0 = time.time()
                    metrics, n = {}, 0
                    with contextlib.closing(batches(skip, self.steps_per_epoch)) as epoch_batches:
                        for i, batch in enumerate(epoch_batches, skip):
                            metrics = step(*batch)
                            n += 1
                            prof.tick()
                            if stopped(epoch if i + 1 < self.steps_per_epoch else epoch + 1, step_idx=i):
                                return
                            if log_every and i % log_every == 0:
                                self.log(metrics, epoch)
                    # a signal during the epoch's last batches or its end
                    if stopped(epoch + 1, at_epoch_end=True):
                        return
                    record = None
                    if metrics:
                        last_loss = float(metrics[loss])  # waits for the epoch's last step
                        dt = time.time() - t0
                        record = {"steps": n, "seconds": dt, rate: n * args.batch_size / dt, "loss": last_loss}
                        out.epochs.append(record)
                    end_epoch(epoch, metrics, record)
                    if (args.checkpoint_every_epochs and (epoch + 1) % args.checkpoint_every_epochs == 0
                            and (checkpoint_last or epoch + 1 < args.max_epochs)):
                        self.checkpoint(epoch + 1)
        finally:
            prof.stop()  # writes the trace on every exit path
            out.trace = prof.path
