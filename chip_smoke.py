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
   CUDA events, cold L2, and prints the kernel's plan and its bounds: the
   bytes of the image sectors the sampled crops touch plus the outputs over
   3.35 TB/s (``bound_needed_us``, the one that counts), the same with the
   whole images (``bound_whole_us``), and the f32 operations over 67
   TFLOP/s; ``share_of_bound`` is the bound over the kernel's time.
3a. bn_kernels: training BatchNorm's four hand-written kernels
   (``csrc/global_batchnorm.cu``: statistics, normalize, backward reduce,
   backward elementwise) at ``byol_r18.ddp4``'s stem (4096 × 64 × 56², also
   ``byol_r18.device``'s) and layer-4 (4096 × 512 × 4²) shapes and its
   projector's 4096 × 4096, and at ``unet_r18.train``'s stem (512 × 64 ×
   112²) and narrowest decoder blocks (512 × 32 × 112², 512 × 16 × 224²),
   bf16 channels-last: each against its plain version (sums within 1e-5 of
   Σ|v|, the normalized output and dx from the same sums within 1 bf16
   ulp), then timed cold by CUDA events beside its byte bound at 3.35 TB/s
   (each input byte read once, each output byte written once), the plain
   version's time and torch's ``batch_norm_stats`` / ``batch_norm_elemt`` /
   ``batch_norm_backward_reduce`` / ``batch_norm_backward_elemt`` as
   ``library_ms`` (the port never calls these); then the one-card path's
   forward (statistics and normalize) and backward (the two backward
   passes) beside their bounds (3a and 5a) and torch's training
   ``F.batch_norm`` and its autograd backward (cuDNN, the call the one-card
   path made before the kernels) as ``library_forward_ms`` and
   ``library_backward_ms``. The phases after it count the kernels' launches
   on every path, with each ``BatchNorm`` call counted at the module
   boundary: in this process (one card, parity, bench) 3 for each
   training forward and 3 for each backward of a ``BatchNorm`` whose input
   the kernels take (a CUDA tensor, ``global_batchnorm.takes``), none on
   the global path and none on the serving paths (the kernels' record
   counts training calls on the card left to ``F.batch_norm`` as
   ``library_calls_by_path``); in each rank of the
   data-parallel and depth-sharded phases the same, and 3 for each
   BatchNorm forward and 3 for each backward on the global path, with no
   BatchNorm left on local statistics (``dist_byol``: 195 a ResNet-18 BYOL
   step).
3b. in_kernels: nnU-Net's InstanceNorm + LeakyReLU kernels
   (``csrc/instance_norm.cu``) at ``nnunet3d_liver.train``'s shapes, B=2
   at 128³ × 32, 32³ × 128 and 4³ × 320, bf16 channels_last_3d: each
   against its plain version (statistics within 1e-5, the same bits on a
   second call, y and dx from the same statistics and sums within 1 bf16
   ulp, the sums within 1e-5 of Σ|v|), then timed cold by CUDA events
   beside its byte bound at 3.35 TB/s, with the forward and backward
   against the bytes the design moves (3a and 5a, one kernel 2a and 3a),
   the plain versions' times and ``F.instance_norm`` + ``F.leaky_relu``
   and their autograd backward as ``library_ms`` (the port never calls
   these). Then two of nnU-Net's train steps at 128³, batch 2: 108 kernels
   a step (16 norms of three kernels and 6 of one, each direction), the
   ``norm.instance_kernels`` and ``norm.instance_values`` counters, and the
   gradients copied into channels-last a step (``dy_copies_per_step``).
   Then Swin UNETR's InstanceNorms (no affine, LeakyReLU 0.01 or slope 1,
   the norm alone) at ``swin_unetr_liver.train``'s shapes, B=4 at 96³ × 48
   and 3³ × 768 (one kernel a direction), each slope against the plain
   versions within the same limits, and two of its train steps at 96³,
   batch 4: 136 kernels a step (21 norms of three kernels and 5 of one,
   each direction) and both counters.
   The phases after it count the launches on the BYOL and 2D U-Net,
   ingest, parity, serving, ``UNet3D`` (GroupNorm) and bench paths: none.
3c. native_store: builds the port's native store reader
   (``medical_image_segmentation_tpu_torch/csrc/mis_loader.cpp`` with its
   own JPEG and PNG decoders and the DICOM codecs) with ``g++`` alone, on
   a thread started before phase 2, and prints the command, its seconds, the shared object's ``ldd`` libraries
   (nothing beyond the C and C++ runtimes) and ``os.cpu_count()``; holds
   ``fetch`` and ``fetch_views`` (two 112² RandomResizedCrop views a
   sample) to the byte against the Python ``StoreReader`` and
   ``fetch_views_fallback`` on 256² stores from a seed: raw u8 and u16, gray
   JPEG at quality 75 and 95, PNG 8- and 16-bit, JPEG-LS 8- and 16-bit;
   then times the ``Loader``'s fetch of a batch of 256 × 256² from a raw
   and a gray JPEG (quality 90) store, native at 1 and 8 threads against
   the Python reader.
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
   loss must be finite, the native reader must have read the store, and
   every parameter must have moved but the probe's bias, which without
   labels has no gradient and no decay.
6b. train_jpeg: the same trainer for 2 × 8 steps on a gray JPEG 256² store
   (2,048 records of 256 CT-like slices at quality 90): the native reader
   decodes, the kernel makes the views; steady ms a step beside phase 6's.
7. step: steady-state BYOL ms/step on a device-resident batch, views from
   the kernel and from the plain version.
7b. dist: training across several processes on the one card.
   - dist_<case>: one spawn of 2 ranks joined over gloo on ``cuda:0`` (NCCL
     refuses two ranks on one device) runs two f32 steps (TF32 off) of
     BYOL (ResNet-18, hidden 4096, projection 256, global batch 256 of
     112² views with labels), BYOL with the heads split over the 2 ranks
     (``tp``: 2048 hidden units a rank), the U-Net (224², global batch 64)
     and the 3D U-Net ((32, 64, 128, 256), 32×64×64, global batch 4) with
     GroupNorm and with BatchNorm, each rank on its rows; this process
     runs the same steps on the whole batch. Step-1 losses within 1e-4,
     parameters and statistics per group within three times the one-process
     step's own spread under a 1e-6 change of the input (never looser than
     1e-3 is needed), the ranks equal to the bit.
   - dist_train: ``mis-train-ssl-torch`` at full width (global batch 256,
     2 × 4 steps) in 2 gloo ranks: each rank prints its ``process r/2``
     line, launches the kernel once a step and once for the memory guard's
     probe, ends with the other's parameters to the bit, and holds the
     kernel at its batch of 128 against the plain version (1 bf16 ulp);
     only rank 0 writes the checkpoint.
   - dist_nccl: the same run in this process, plain and then as the one
     rank of an NCCL group (every collective of the path through NCCL):
     the probe's and first step's losses equal, the parameters within 1e-3.
   Prints ms a step of 1 rank, of the NCCL rank and of 2 gloo ranks; two
   ranks sharing a card all-reduce through the host, so the last is no
   measure of multi-card scaling.
7c. space_steps: depth sharding (``--space_shards``). The 3D step cases
   (GroupNorm, then BatchNorm) in 2 gloo ranks on ``cuda:0`` laid out as
   (data, space) = (1, 2): each rank takes its depth slab (16 of 32) of the
   whole global batch of 4, halo-exchanges every 3³ convolution with the
   other and sums GroupNorm statistics with it; held against the dist
   phase's one-process steps as dist_<case> is, the ranks equal to the bit.
   Prints the f32 halo bytes a step, computed from the shapes.
8. seg_train: writes paired raw 224² stores (512 train, 128 val, 128 test
   slices with disk masks) and runs the segmentation trainer's entry point
   at full width (resnet18 U-Net, decoder (256,128,64,32,16), batch 64,
   bf16, LARS lr 1.0 / min_lr 1e-2, Dice), 2 epochs × 8 steps, its encoder
   grafted from phase 6's checkpoint. The encoder must start equal to the
   BYOL online backbone, every parameter must move, the loss must be
   finite, val and test Dice/IoU must lie in [0, 1], the native reader must
   have read the stores and the final checkpoint must exist.
9. predict: the predict entry point on that checkpoint over 512² raw
   stores: batched on 128 slices, sliding-window (224, 16 windows a slice)
   on 16. Mask counts; batched masks against ``predict_step`` on the same
   resized batch (≥ 99.9% of pixels); on a 224² image the one-window
   sliding-window logits against the plain f32 eval forward (1e-5 of the
   largest logit).
10. seg_step: steady-state segmentation ms/step on a device-resident batch
   (batch 64, 224², bf16), FLOPs per step and the peak device memory.

The serving path's phases (after ``predict`` and after ``predict3d``). No
hand-written kernel lies on this path, and the run fails if one is launched
in it:

- export: ``mis-export-torch`` on phase 8's checkpoint (buckets 1, 8, 64 at
  224²), then ``mis-predict-torch --exported`` on phase 9's 128 slices: its
  masks must equal the checkpoint-backed batched masks on every pixel.
  ``ServingPredictor`` on 1, 9 and 73 images against ``make_predict_fn`` on
  the same chunks (equal), and a fresh process that loads and calls the
  artifact must end with no module of ``models/`` or ``train/`` loaded.
  Prints the artifact's bytes, the export's seconds, and both routes taken
  in turns (checkpoint, exported, exported, checkpoint): images a second
  through the CLI, where each ``--exported`` run also loads its buckets,
  and milliseconds a loaded batch of 64.
- fused2d: the fused sliding-window predictor (the first slice of a shape
  eager, then one captured CUDA graph) against the loop on one 512² slice in f32 (1e-5 of the
  largest logit), then ``mis-predict-torch --sliding_window`` on phase 9's
  16 slices through the loop, the fused predictor twice, and the loop:
  equal masks, milliseconds a slice, the kernels a slice of both, the
  capture's seconds.
- export3d: ``mis-export3d-torch`` on phase 19's checkpoint (window
  32×64×64, 4 windows a batch), then ``mis-predict3d-torch --exported`` on
  phase 21's volumes against its checkpoint-backed masks (≥ 99.9% of
  voxels; equal is expected).
- fused3d: fused against loop on one 160×160×80 volume in f32 (1e-5), then
  ``mis-predict3d-torch`` through loop, fused, fused, loop: seconds a
  volume and megavoxels a second, and both variants on a device-resident
  volume by CUDA events.

The SSL path's phases, each at the BYOL width of phase 6:

11. precrop: ``--host_precrop`` on phase 6's store for 8 steps. The
   elementwise tail on the card against the CPU on the same draws (1 bf16
   ulp), no kernel launch, the H2D bytes a batch of both routes and the
   host reader that served, which must be the native one.
12. resume: the BYOL trainer (2 epochs × 8 steps) stopped by SIGTERM after
   step 11, then run with ``--resume``: it ends at step 16 having skipped
   the 3 trained batches, every step ran at the uninterrupted run's LR and
   τ, and the checkpoint restores bit for bit. The same for the
   segmentation trainer.
13. ssl_eval: CIFAR10 (32² RGB, low-res stem, train labels) on a synthetic
   labelled store, one epoch with validation and the KNN probe over a bank
   larger than its chunk, then ``mis-linear-probe-torch`` on its
   checkpoint for 2 epochs; then the chunked KNN against the unchunked one
   at the trainer's default bank cap (262,144 × 512 f32, 256 queries,
   chunks of 65,536): equal argmax, scores within 1e-4, and both timed.
14. profile: ``--profile 4``; the trace names the kernel and the loader's
   stage report is printed.
15. remat: one BYOL step (batch 256) and one U-Net step (batch 64, 224²)
   with and without ``remat`` from the same weights and batch: loss and
   BatchNorm statistics within 1e-6 and a lower peak with remat.
16. hbm: the memory guard's report on both configurations, and the task
   and generator bit-equal across its probe step.

The data-curation path and the parity harness (after hbm), with ``cv2``
and ``PIL`` absent (not importable) or blocked for the two phases, so
every image goes through the port's numpy routes:

- ingest: writes from a seed 64 distinct 300×300 uint16 DICOMs and 8
  pixel copies in three TCIA-style trees, 4 Decathlon NIfTI pairs of
  256×256×12 with a mask blob and a val tree of 8 uint16 PNGs, then runs
  the CLIs' entry points with 2 spawned workers: ``create_subset``
  (``dicom_sizes``, ``dicom_hashes``, ``write_subset``), ``create_store``
  (JPEG at 224), ``compute_stats`` (``--center_crop 224``),
  ``slice_decathlon``, ``create_splits`` and ``create_seg_store``. The
  dedup must keep 64, the store hold 64 images of 224², the slices and seg
  stores 48. Prints each stage's seconds and counts, the host's ms an
  image for JPEG encode and decode and for INTER_AREA, and whether the
  libraries were absent or blocked. The port's native library must be
  loaded: a 128² 16-bit slice through JPEG-LS and DICOM JPEG Lossless,
  native against Python (equal), names the route and its ms. No kernel
  lies on this path; the run fails if one is launched.
- parity: ``mis-parity-torch`` on that raw data at the canonical width
  (resnet18, hidden 4096 / projection 256, bf16; ``--subset_size 64
  --image_size 224 --ssl_epochs 1 --ssl_batch_size 64 --seg_epochs 1
  --seg_batch_size 16 --fractions 100``): every stage, a report with the
  scratch and SSL inits' test Dice in [0, 1], then a second call that
  re-runs nothing. The pretrain stage must launch ``two_view_augment``;
  the kernel is then held against its plain version on a batch of 64 of
  the harness's own 224² store (1 bf16 ulp) and timed. The native
  library must be loaded, as in ingest.

The volumetric path's phases, at the 3D trainers' defaults (``UNet3D`` of
features (32, 64, 128, 256), GroupNorm, bf16, volumes fitted to 64×96×96,
crops of 32×64×64, batch 4; volumetric BYOL with hidden 4096 and projection
256) on synthetic NIfTI written from a seed: 32 labelled volumes of about
96×96×64 on disk with ±8 of ragged extent and sphere masks, split 24/4/4,
and four volumes of 160×160×80 (one 160×152×80) to serve. No hand-written
kernel lies on this path, and the run fails if one is launched in it.

17. vol_parity: two f32 ``Segmentation3DTask`` steps at a small width
   (features (8, 16, 32), 16×32×32, batch 2), card against CPU, held as
   phases 4-5 are.
18. ssl3d_train: the volumetric BYOL trainer's entry point, 2 epochs × 6
   steps with ``--device_cache``: finite losses, every backbone parameter
   moved, the checkpoint written.
19. seg3d_train: the 3D segmentation trainer's entry point from that
   checkpoint (``--ssl_checkpoint``), 2 epochs × 6 steps, val each epoch,
   test, then ``--full_res_window 32 64 64``. The encoder must start equal
   to the BYOL online backbone, every parameter must move, Dice/IoU must
   lie in [0, 1]. Once more with ``--device_cache`` for one epoch: its
   first loss equals the plain route's to the bit (the same batch through
   the same weights) and the rest of the epoch within 1e-2 relative (a
   backward convolution may sum in another order from run to run).
20. resume3d: that trainer stopped by SIGTERM after step 8 of 2 × 6 and
   resumed, held as phase 12.
21. predict3d: the predict3d entry point on the four volumes (64 windows
   each), twice (cold, warm): mask files of the inputs' (X, Y, Z) shapes,
   one of them against the task's own sliding-window prediction on the
   (Z, X, Y) volume (≥ 99.9% of voxels), and on a volume of exactly one
   window the f32 sliding-window logits against the plain eval forward
   (1e-5 of the largest logit). Prints megavoxels a second.
- multicard_3d: ``mis-predict3d-torch`` on those four volumes with two
   replicas of the network on ``cuda:0`` against one device, in turns
   (one, two, two, one): masks equal or the voxels that differ, one
   volume's largest logit difference (loop over two replicas against the
   fused predictor), megavoxels a second of both routes. multicard_2d (after
   fused2d) does the same for ``mis-predict-torch``: batched on 64 slices
   of 512², ``--sliding_window 224`` on 16. No kernel is launched.
- space: ``mis-train-segmentation3d-torch --space_shards 2`` at the
   defaults above in bf16, 2 gloo ranks sharing the card, 2 epochs × 4
   steps: ranks equal to the bit, finite losses, one checkpoint (rank 0's),
   ms a step, the bf16 halo bytes a step; then ``--resume`` of that
   checkpoint in this process under ``--space_shards 1`` for one more epoch.
   No kernel is launched. Two ranks on one card exchange through the host:
   no measure of multi-card scaling.
22. seg3d_step: device-resident augmentation + step by CUDA events at batch
   4 and batch 32, the FLOPs of a step, the peak device memory with and
   without remat (loss equal to 1e-6), the step's kernel count and device
   time by kind under ``torch.profiler``, the volumetric BYOL step, and
   the memory guard's report.

The port's benchmark programs (after seg3d_step):

23. bench: ``bench_torch.main`` in this process for each task at the
   bench's default widths and batches, ``--steps 5 --warmup 2``: byol
   (batch 1024, 256² → 112²), then byol in store mode on a synthetic
   ``--store auto`` of 512 images, raw and gray JPEG (batch 256: 512
   images hold no batch of 1024), seg (128 × 224²), seg3d (4 × 64×96×96 →
   32×64×64), predict (256 × 224²), predict3d (64×96×96, window 32×64×64,
   8 a batch); then ``--task seg3d --hbm_check`` (exit 0 or 2 and its
   ``seg3d_projected_hbm_gb`` line) and ``tools/bench_loader_torch.py``
   (gray JPEG, ``--threads 1 8``). Each JSON line is printed as
   ``[bench_<run>] {...}``, with the card's name and power limit in it.
   Fails if a line lacks its metric or ``mfu``, if store mode read through
   the Python reader, or if byol launched ``two_view_augment`` other than
   once a step it took (warmup, timed, probe and the FLOP count's) or
   another task launched it at all. cuDNN's TF32 is back at PyTorch's
   default (on) for this phase, as a standalone bench run has it.
24. bench_ranks: ``bench_torch.py`` over the ranks of a launch and over
   replicas, on the one card (TF32 as in phase 23). byol and seg as the
   one rank of an NCCL group (torchrun's variables at world 1, in this
   process) at phase 23's flags; byol at a global batch of 256 and seg3d in
   two spawned ranks sharing ``cuda:0`` over gloo (NCCL refuses two ranks
   on one card: these lines measure the mechanism, not scaling); then
   ``--task predict`` with ``local_devices`` forced to two replicas on
   ``cuda:0``. Each line is printed as ``[bench_ranks_<run>] {...}``. Fails
   unless each line names its group (``ranks``, ``backend``) and one card
   (``gpus`` 1), ``value`` is ``total_per_sec`` over the ranks or devices,
   rank 1 printed nothing on stdout, each rank launched
   ``two_view_augment`` once a step of byol it took (and never in the
   other tasks), and the predict line says ``devices`` 2. Prints the NCCL
   lines' values over phase 23's one-process values.

TF32 is off for both cuDNN and cuBLAS, so every f32 op here is full f32;
the training steps run in bf16 under autocast, which TF32 does not touch.
The device line also says whether ``triton`` imports (information only: the
port needs none). The last lines are the card, the kernels' JSON record (with
``launches_jpeg_store_path``, the launches of phase 6b,
``launches_data_parallel_path``, the kernel launches of each rank in
dist_train, ``launches_nccl_path``, ``launches_bench_path``, the
launches of the bench's byol runs, ``launches_bench_ranks_path``, the
launches of phase 24's byol runs by rank, and ``launches_space_path`` and
``launches_multicard_path``, which must be 0) and ``{"ok": true, "device":
{...}}``. The run also fails if the port loaded
``jax`` or any module of the JAX package.

    python3 chip_smoke.py --ab-old-source OLD.cu

runs phases 1-3 only, then holds another version of
``csrc/two_view_augment.cu`` (the same C interface, e.g. the parent
commit's) and this one against the plain version and times them in turns
(old, new, new, old; cold and L2-warm), failing unless this one is the
faster, then profiles both at batches 1024 and 4096. It prints no kernels
line.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "medical_image_segmentation_tpu_torch"
KERNEL_SOURCE = f"{PKG}/csrc/two_view_augment.cu"
REPLACES = "medical_image_segmentation_tpu/ops/pallas_augment.py:210"
BN_KERNEL_SOURCE = f"{PKG}/csrc/global_batchnorm.cu"
IN_KERNEL_SOURCE = f"{PKG}/csrc/instance_norm.cu"


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


def sleep_cycles(ms: float) -> int:
    """GPU clock cycles that ``torch.cuda._sleep`` spins for about ``ms``,
    calibrated once with CUDA events."""
    import torch

    if not hasattr(sleep_cycles, "per_ms"):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(20_000_000)
        end.record()
        end.synchronize()
        sleep_cycles.per_ms = 20_000_000 / start.elapsed_time(end)
    return int(ms * sleep_cycles.per_ms)


def cold_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` runs, each after the L2 is
    flushed, from CUDA events around ``fn`` alone. A GPU sleep queued before
    the first event keeps the card busy while the host prepares the launch,
    so the events time the device and not the host's launch overhead."""
    import torch

    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(sleep_cycles(0.5))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def warm_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back runs, the L2
    warm, from CUDA events around all of them, behind a GPU sleep long
    enough for the host to queue every launch."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    host_ms = 1000.0 * (time.perf_counter() - t0) / 10
    torch.cuda._sleep(sleep_cycles(2.0 * iters * host_ms + 1.0))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profiled_us(fn, iters: int, name: str = "two_view_augment"):
    """Mean device time of the kernels whose name holds ``name`` over
    ``iters`` cold runs, from ``torch.profiler``; None if the profiler saw
    no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        if name in e.key:
            total += getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
            count += e.count
    return total / count if count else None


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


# H100 SXM peaks (NVIDIA's data sheet): device memory and f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# f32 operations per output value: the bilinear taps' 6 products and 3 sums,
# then the normalize's difference and quotient (window, solarize and the
# grayscale mix add more where they are on; left out, so this is a floor)
FLOPS_PER_VALUE = 11


def kernel_bounds(torch, fa, params, imgs, out_size, dtype) -> dict:
    """The least time the card could take for one call on these inputs:
    bytes over the memory rate (each input byte read once, each output
    byte written once), counting either the image sectors the taps touch
    (``needed``) or the whole images (``whole``), against the operations
    over the f32 rate. The larger of the ``needed`` and operations bounds
    is the call's bound."""
    b, h, w, c = imgs.shape
    values = 2 * b * out_size[0] * out_size[1] * c
    out_bytes = values * torch.empty((), dtype=dtype).element_size()
    fixed = out_bytes + params.numel() * params.element_size()
    needed_in = fa.touched_input_bytes(params, tuple(imgs.shape), imgs.element_size(), out_size)
    whole_in = imgs.numel() * imgs.element_size()
    needed_us = (needed_in + fixed) / HBM_BYTES_PER_S * 1e6
    ops_us = values * FLOPS_PER_VALUE / F32_FLOPS_PER_S * 1e6
    return dict(needed_in_bytes=needed_in, whole_in_bytes=whole_in, out_bytes=out_bytes,
                bound_needed_us=needed_us, bound_whole_us=(whole_in + fixed) / HBM_BYTES_PER_S * 1e6,
                bound_ops_us=ops_us, bound_by="bytes" if needed_us >= ops_us else "operations",
                bound_us=max(needed_us, ops_us))


def run_kernel_checks(torch, fa, dm_mod):
    """Every case against the plain version; the main case timed, with its
    bounds. Returns the kernels-line fields of ``two_view_augment``."""
    max_err, record = 0.0, {}
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
            prof_us = profiled_us(lambda: fa.fused_two_view_augment(
                imgs, cfg1, cfg2, mean, std, torch.bfloat16, params=params), 20)
            bounds = kernel_bounds(torch, fa, params, imgs, cfg1.out_size, torch.bfloat16)
            plan = fa.kernel_plan(h, w, imgs.shape[3], cfg1.out_size, imgs.dtype)
            share = bounds["bound_us"] / (1000.0 * main_ms)
            fields.update(kernel_ms=main_ms, kernel_profiled_us=prof_us, plain_ms=plain_ms, **bounds,
                          share_of_bound=share, share_of_whole_bound=bounds["bound_whole_us"] / (1000.0 * main_ms),
                          **{f"plan_{k}": v for k, v in plan.items()})
            record = dict(ms=main_ms, plain_ms=plain_ms, bound_ms=bounds["bound_us"] / 1000.0,
                          bound_by=bounds["bound_by"], library_ms=None, share_of_bound=share)
        phase("kernel", **fields)
    return dict(max_abs_err=max_err, **record)


# training BatchNorm at byol_r18.ddp4's shapes (a rank's 4096 views: both views of 2048 images;
# byol_r18.device's too), and at unet_r18.train's (512 slices of 224²): the encoder's stem and
# the decoder's two narrowest blocks, which hold 43% of its BatchNorm bytes
BN_CASES = (("stem", (4096, 64, 56, 56)), ("layer4", (4096, 512, 4, 4)), ("head", (4096, 4096)),
            ("unet_stem", (512, 64, 112, 112)), ("unet_dec32", (512, 32, 112, 112)),
            ("unet_dec16", (512, 16, 224, 224)))
BN_DEVICE = "cuda"
BN_STEP_KERNELS = 195  # byol_r18: 43 BatchNorm forwards (21 target, 22 online) and 22 backwards, 3 kernels each


def bn_kernel_bytes(shape, elem: int) -> dict:
    """Bytes each of global BatchNorm's passes needs on an activation of
    ``shape``: each input byte read once, each output byte written once
    (activation-sized tensors; per-channel vectors at 4 bytes)."""
    c = shape[1]
    a = math.prod(shape) * elem
    need = {"stats": a + 4 * (2 * c + 1), "normalize": 2 * a + 4 * (2 * c + 1 + 4 * c),
            "backward_reduce": 2 * a + 4 * 6 * c, "backward_elemt": 3 * a + 4 * (6 * c + 1)}
    # the one-card path's two directions: what its two passes each way need
    return dict(need, forward=need["stats"] + need["normalize"],
                backward=need["backward_reduce"] + need["backward_elemt"])


def bn_inputs(torch, shape, seed: int):
    gen = torch.Generator(device=BN_DEVICE).manual_seed(seed)
    view = (1, shape[1]) + (1,) * (len(shape) - 2)
    x = (torch.randn(shape, generator=gen, device=BN_DEVICE) * (0.5 + torch.rand(view, generator=gen, device=BN_DEVICE))
         + torch.randn(view, generator=gen, device=BN_DEVICE))
    fmt = torch.channels_last if len(shape) == 4 else torch.contiguous_format
    return x.to(torch.bfloat16).contiguous(memory_format=fmt)


def check_bn_case(torch, gbn, name, x, dy, w, b):
    """The four kernels against their plain versions on one activation;
    returns the kernels' outputs for the timing."""
    dims = [0, *range(2, x.ndim)]
    stats = gbn.batch_stats(x)
    want = gbn.stats_reference(x)
    xf = x.float()
    scale = torch.cat([xf.abs().sum(dims), xf.square().sum(dims)])
    stats_err = float(((stats[:-1] - want[:-1]).abs() / scale).max())
    check(stats_err <= 1e-5 and float(stats[-1]) == x.numel() // x.shape[1],
          f"bn_kernels {name}: statistics differ from the plain version by {stats_err} of sum |v|")
    check(torch.equal(gbn.batch_stats(x), stats), f"bn_kernels {name}: two statistics calls differ")
    y, mean, invstd = gbn.normalize(x, w, b, stats, 1e-5, 0.9)
    y_ulp = bf16_ulps(y, gbn.normalize_reference(x, w, b, mean, invstd))
    check(y_ulp <= 1, f"bn_kernels {name}: normalize differs from the plain version by {y_ulp} bf16 ulp")
    sums, _, _ = gbn.backward_reduce(x, dy, mean, invstd)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    xhat = (xf - mean.view(shape)) * invstd.view(shape)
    del xf
    scale = torch.cat([dy.float().abs().sum(dims), (dy.float() * xhat).abs().sum(dims)])
    del xhat
    sums_err = float(((sums - gbn.backward_reduce_reference(x, dy, mean, invstd)).abs() / scale).max())
    check(sums_err <= 1e-5, f"bn_kernels {name}: backward sums differ by {sums_err} of sum |v|")
    n = stats[-1:]
    dx = gbn.backward_elemt(x, dy, w, mean, invstd, sums, n)
    dx_ulp = bf16_ulps(dx, gbn.backward_elemt_reference(x, dy, w, mean, invstd, sums, n))
    check(dx_ulp <= 1, f"bn_kernels {name}: dx differs from the plain version by {dx_ulp} bf16 ulp")
    torch.cuda.synchronize()
    return dict(stats_err=stats_err, y_ulp=y_ulp, sums_err=sums_err, dx_ulp=dx_ulp), (stats, mean, invstd, sums, n)


def bn_library_calls(torch, x, dy, w, b, mean, invstd):
    """torch's SyncBatchNorm primitives for the same four passes: the
    yardstick, never the port's path."""
    count = torch.tensor([x.numel() // x.shape[1]], dtype=torch.int32, device=x.device)
    sum_dy, sum_dy_xmu, _, _ = torch.batch_norm_backward_reduce(dy, x, mean, invstd, w, True, True, True)
    return {"stats": lambda: torch.batch_norm_stats(x, 1e-5),
            "normalize": lambda: torch.batch_norm_elemt(x, w, b, mean, invstd, 1e-5),
            "backward_reduce": lambda: torch.batch_norm_backward_reduce(dy, x, mean, invstd, w, True, True, True),
            "backward_elemt": lambda: torch.batch_norm_backward_elemt(dy, x, mean, invstd, w, sum_dy, sum_dy_xmu,
                                                                      count)}


def bn_training_library(torch, x, dy, w, b):
    """torch's training ``F.batch_norm`` and its autograd backward on the
    same activation: the call the one-card path made before the kernels
    (cuDNN for a channels-last one), the yardstick of its two directions."""
    import torch.nn.functional as F

    rm, rv = torch.zeros_like(w), torch.ones_like(w)
    xg, wg, bg = (t.detach().clone().requires_grad_(True) for t in (x, w, b))
    y = F.batch_norm(xg, rm, rv, wg, bg, True, 0.1, 1e-5)
    return {"forward": lambda: F.batch_norm(xg, rm, rv, wg, bg, True, 0.1, 1e-5),
            "backward": lambda: torch.autograd.grad(y, (xg, wg, bg), dy, retain_graph=True)}


class BatchNormCalls:
    """``BatchNorm``'s calls in training in this process, counted at the
    module boundary: ``forwards`` and ``backwards`` on the global path (a
    group set; a backward counted when the gradient reaches the output),
    ``local`` ones (no group), and of those ``local_forwards`` and
    ``local_backwards`` on the one-card kernels (an input that
    ``global_batchnorm.takes``) and ``local_library``, a CUDA input left to
    ``F.batch_norm`` (a layout the kernels refuse). Either path launches 3 kernels for each
    forward and 3 for each backward (``ops/global_batchnorm.py``), so
    ``take`` also reads the wrapper's ``launches`` and ``local_launches``."""

    def __init__(self, torch):
        from medical_image_segmentation_tpu_torch.models.batchnorm import BatchNorm
        from medical_image_segmentation_tpu_torch.ops import global_batchnorm

        self.gbn = global_batchnorm
        self.forwards = self.backwards = self.local = self.local_forwards = self.local_backwards = 0
        self.local_library = 0
        self.mark = self.now()

        def on_grad(_):
            self.backwards += 1

        def on_local_grad(_):
            self.local_backwards += 1

        def hook(m, args, out):
            if not (isinstance(m, BatchNorm) and m.training):
                return
            if m.group is None:
                self.local += 1
                if not global_batchnorm.takes(args[0]):
                    self.local_library += args[0].is_cuda
                    return
                self.local_forwards += 1
                if out.requires_grad:
                    out.register_hook(on_local_grad)
                return
            self.forwards += 1
            if out.requires_grad:
                out.register_hook(on_grad)

        self.handle = torch.nn.modules.module.register_module_forward_hook(hook)

    def now(self) -> dict:
        return {"launches": self.gbn.launches, "forwards": self.forwards, "backwards": self.backwards,
                "local": self.local, "local_launches": self.gbn.local_launches,
                "local_forwards": self.local_forwards, "local_backwards": self.local_backwards,
                "local_library": self.local_library}

    def take(self) -> dict:
        """The counts since the last ``take``."""
        now = self.now()
        out = {k: now[k] - self.mark[k] for k in now}
        self.mark = now
        return out


# global BatchNorm's kernel launches by rank, per phase of the data-parallel paths
BN_RANK_LAUNCHES = {}
# training BatchNorm calls on the card left to F.batch_norm in this process, by path
BN_LIBRARY_CALLS = {}


def check_local_bn(name: str, counts: dict) -> None:
    """3 one-card kernels for each local forward and backward on them
    (``BatchNormCalls.take``)."""
    forwards, backwards, launches = counts["local_forwards"], counts["local_backwards"], counts["local_launches"]
    check(launches == 3 * (forwards + backwards),
          f"{name}: one-card BatchNorm launched {launches} kernels, not 3 × ({forwards} forwards + "
          f"{backwards} backwards) = {3 * (forwards + backwards)}")


def check_global_bn(name: str, counts: dict, global_path: bool = True) -> None:
    """A rank's BatchNorm counts (``BatchNormCalls.take``): 3 kernels for
    each global forward and backward, and for each local one on the
    one-card kernels; on a ``global_path`` (more than one rank in
    BatchNorm's group) no call kept local statistics, else none took the
    global path."""
    derived = 3 * (counts["forwards"] + counts["backwards"])
    check(counts["launches"] == derived,
          f"{name}: global BatchNorm launched {counts['launches']} kernels, not 3 × ({counts['forwards']} "
          f"forwards + {counts['backwards']} backwards) = {derived}")
    check_local_bn(name, counts)
    if global_path:
        check(counts["local"] == 0, f"{name}: {counts['local']} BatchNorm calls kept their local statistics")
    else:
        check(counts["forwards"] == 0, f"{name}: {counts['forwards']} BatchNorm calls took the global path")
    BN_RANK_LAUNCHES.setdefault(name.split(" rank ")[0], []).append(counts["launches"])


def take_bn_launches(calls, paths: dict, path: str) -> None:
    """BatchNorm's kernel launches in this process since the last take
    (``calls``, a ``BatchNormCalls``), added to ``paths[path]``: 3 for each
    forward and backward on the one-card kernels, and none on the global
    path, as none of this process's paths has a group of more than one
    rank. ``BN_LIBRARY_CALLS[path]`` counts the training calls on the card
    left to ``F.batch_norm`` (a layout the kernels refuse)."""
    counts = calls.take()
    check(counts["launches"] == 0 and counts["forwards"] == 0,
          f"{path}: global BatchNorm ran in one process: {counts}")
    check_local_bn(path, counts)
    paths[path] = paths.get(path, 0) + counts["local_launches"]
    BN_LIBRARY_CALLS[path] = BN_LIBRARY_CALLS.get(path, 0) + counts["local_library"]


def run_bn_kernels(torch, card: str) -> dict:
    """Training BatchNorm's kernels against their plain versions, timed
    beside their bounds, the plain versions and torch's primitives at the
    BYOL and U-Net cells' shapes, then the one-card path's two directions
    against torch's training ``F.batch_norm``. Returns the kernels-line
    fields of ``global_batchnorm``; each path's launches are counted where
    it runs (``BatchNormCalls``, ``take_bn_launches``)."""
    from medical_image_segmentation_tpu_torch.ops import _kernels
    from medical_image_segmentation_tpu_torch.ops import global_batchnorm as gbn

    t0 = time.time()
    so = _kernels.build_kernel("global_batchnorm")
    with open(so[:-3] + ".log") as f:
        ptxas = " | ".join(ln.strip() for ln in f if "registers" in ln or "spill" in ln or "stack" in ln)
    phase("build", kernel="global_batchnorm", seconds=round(time.time() - t0, 2), ptxas=ptxas or "(cached)")
    record = {}
    for name, shape in BN_CASES:
        x, dy = bn_inputs(torch, shape, 0), bn_inputs(torch, shape, 1)
        gen = torch.Generator(device=BN_DEVICE).manual_seed(2)
        w = torch.rand(shape[1], generator=gen, device=BN_DEVICE) + 0.5
        b = torch.randn(shape[1], generator=gen, device=BN_DEVICE)
        errs, (stats, mean, invstd, sums, n) = check_bn_case(torch, gbn, name, x, dy, w, b)
        kernels = {"stats": lambda: gbn.batch_stats(x),
                   "normalize": lambda: gbn.normalize(x, w, b, stats, 1e-5, 0.9),
                   "backward_reduce": lambda: gbn.backward_reduce(x, dy, mean, invstd),
                   "backward_elemt": lambda: gbn.backward_elemt(x, dy, w, mean, invstd, sums, n)}
        plain = {"stats": lambda: gbn.stats_reference(x),
                 "normalize": lambda: gbn.normalize_reference(x, w, b, mean, invstd),
                 "backward_reduce": lambda: gbn.backward_reduce_reference(x, dy, mean, invstd),
                 "backward_elemt": lambda: gbn.backward_elemt_reference(x, dy, w, mean, invstd, sums, n)}
        try:
            library = bn_library_calls(torch, x, dy, w, b, mean, invstd)
        except RuntimeError as e:  # a yardstick that does not run here is reported, not fatal
            library = f"refused: {str(e).splitlines()[0][:80]}"
        # the one-card path's passes as BatchNorm launches them, each direction in one timing
        kernels["forward"] = lambda: gbn.normalize(x, w, b, gbn.batch_stats(x), 1e-5, 0.9)
        kernels["backward"] = lambda: gbn.backward_elemt(x, dy, w, mean, invstd,
                                                         gbn.backward_reduce(x, dy, mean, invstd)[0], n)
        need = bn_kernel_bytes(shape, x.element_size())
        fields = dict(case=name, shape=shape, **errs)
        for part in kernels:  # the kernels first, before the plain versions fill the allocator's cache
            ms = cold_ms(kernels[part], 10)
            bound_ms = need[part] / HBM_BYTES_PER_S * 1e3
            fields.update({f"{part}_ms": ms, f"{part}_bound_ms": bound_ms, f"{part}_share": bound_ms / ms,
                           f"{part}_bytes": need[part]})
        training = bn_training_library(torch, x, dy, w, b)
        for part, fn in training.items():
            ms = cold_ms(fn, 10)
            fields.update({f"library_{part}_ms": ms, f"library_{part}_share": fields[f"{part}_bound_ms"] / ms})
        del training
        for part in plain:
            try:
                fields[f"{part}_library_ms"] = library if isinstance(library, str) else cold_ms(library[part], 10)
            except RuntimeError as e:
                fields[f"{part}_library_ms"] = f"refused: {str(e).splitlines()[0][:80]}"
            fields[f"{part}_plain_ms"] = cold_ms(plain[part], 3)
        phase("bn_kernels", **fields, card=repr(card))
        record[name] = {k: v for k, v in fields.items() if k.endswith(("_ms", "_share", "_bytes"))}
        del x, dy, stats, mean, invstd, sums, n, kernels, plain, library
        torch.cuda.empty_cache()
    gbn.launches = gbn.local_launches = 0  # the paths count from here
    return record


# nnU-Net's InstanceNorm + LeakyReLU at nnunet3d_liver.train's shapes: 2 crops of 128³ at the
# first stage (three quarters of its bytes), the third, and the deepest
IN_CASES = (("128x32", (2, 32, 128, 128, 128)), ("32x128", (2, 128, 32, 32, 32)), ("4x320", (2, 320, 4, 4, 4)))
IN_DEVICE = "cuda"
IN_EPS, IN_SLOPE = 1e-5, 0.01
IN_STEP = {"crop": 128, "batch": 2, "steps": 2}
IN_STEP_KERNELS = 108  # 16 norms of three kernels and 6 of one, forward and backward
IN_STEP_VALUES = 714_424_320  # values the 22 norms normalize a step
# Swin UNETR's (no affine; slope 1 where the residual sum comes before the activation) at
# swin_unetr_liver.train's shapes: 4 crops at 96³ × 48, the largest, and 3³ × 768, one kernel a direction
IN_SWIN_CASES = (("96x48", (4, 48, 96, 96, 96)), ("3x768", (4, 768, 3, 3, 3)))
IN_SWIN_SLOPES = (1.0, IN_SLOPE)
IN_SWIN_STEP = {"crop": 96, "batch": 4, "steps": 2}
IN_SWIN_STEP_KERNELS = 136  # 21 norms of three kernels and 5 of one, forward and backward
IN_SWIN_STEP_VALUES = 1_159_723_008  # values the 26 norms normalize a step


def in_kernel_bytes(shape, elem: int) -> dict:
    """Bytes each of InstanceNorm's passes needs on an activation of
    ``shape``: each activation-sized input read once, each output written
    once; (B, C) statistics and sums, and the (C,) affine and gradients, at
    4 bytes."""
    b, c = shape[:2]
    a = math.prod(shape) * elem
    stats, vec = 8 * b * c, 8 * c
    return {"stats": a + stats, "normalize": 2 * a + stats + vec, "backward_reduce": 2 * a + 2 * stats + 2 * vec,
            "backward_elemt": 3 * a + 2 * stats + vec, "fused_forward": 2 * a + stats + vec,
            "fused_backward": 3 * a + 2 * stats + 2 * vec}


def in_inputs(torch, shape, seed: int):
    """A seeded bf16 channels_last_3d activation with a mean and scale of
    its own per channel, as a conv with a bias gives."""
    gen = torch.Generator(device=IN_DEVICE).manual_seed(seed)
    view = (1, shape[1]) + (1,) * (len(shape) - 2)
    x = (torch.randn(shape, generator=gen, device=IN_DEVICE) * (0.5 + torch.rand(view, generator=gen, device=IN_DEVICE))
         + torch.randn(view, generator=gen, device=IN_DEVICE))
    return x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last_3d)


def check_in_case(torch, inn, name, x, dy, w, b, slope: float = IN_SLOPE) -> tuple:
    """The kernels against their plain versions on one activation, with
    LeakyReLU's ``slope``: the statistics within 1e-5 (of invstd, and of
    |mean| + std for the mean), the same bits on a second call, y and dx
    from the same statistics and sums within 1 bf16 ulp, the sums within
    1e-5 of the sums of their terms' magnitudes. Returns the errors and the
    kernels' outputs for the timing."""
    want_mean, want_invstd = inn.statistics_reference(x, IN_EPS)
    fused = inn.launches_per_call(x) == 1
    if fused:
        y, mean, invstd = inn.fused_forward(x, w, b, IN_EPS, slope)
        again = inn.fused_forward(x, w, b, IN_EPS, slope)
        check(all(torch.equal(u, v) for u, v in zip(again, (y, mean, invstd))),
              f"in_kernels {name}: two forward calls differ")
    else:
        mean, invstd = inn.statistics(x, IN_EPS)
        check(all(torch.equal(u, v) for u, v in zip(inn.statistics(x, IN_EPS), (mean, invstd))),
              f"in_kernels {name}: two statistics calls differ")
        y = inn.normalize(x, w, b, mean, invstd, slope)
    mean_err = float(((mean - want_mean).abs() / (want_mean.abs() + 1.0 / want_invstd)).max())
    invstd_err = float(((invstd - want_invstd).abs() / want_invstd).max())
    check(mean_err <= 1e-5 and invstd_err <= 1e-5,
          f"in_kernels {name}: statistics differ from the plain version by {mean_err}, {invstd_err}")
    y_ulp = bf16_ulps(y, inn.normalize_reference(x, w, b, mean, invstd, slope))
    check(y_ulp <= 1, f"in_kernels {name}: y differs from the plain version by {y_ulp} bf16 ulp")
    if fused:
        dx, sums, _, _ = inn.fused_backward(x, dy, w, b, mean, invstd, slope)
    else:
        sums, _, _ = inn.backward_reduce(x, dy, w, b, mean, invstd, slope)
        dx = inn.backward_elemt(x, dy, w, b, mean, invstd, sums, slope)
    xhat, g = inn._through(x, dy, w, b, mean, invstd, slope)
    scale = torch.cat([g.abs().sum(1), (g * xhat).abs().sum(1)], dim=1)
    del xhat, g
    sums_err = float(((sums - inn.backward_reduce_reference(x, dy, w, b, mean, invstd, slope)).abs()
                      / scale).max())
    check(sums_err <= 1e-5, f"in_kernels {name}: backward sums differ by {sums_err} of sum |v|")
    dx_ulp = bf16_ulps(dx, inn.backward_elemt_reference(x, dy, w, b, mean, invstd, sums, slope))
    check(dx_ulp <= 1, f"in_kernels {name}: dx differs from the plain version by {dx_ulp} bf16 ulp")
    torch.cuda.synchronize()
    return dict(mean_err=mean_err, invstd_err=invstd_err, y_ulp=y_ulp, sums_err=sums_err, dx_ulp=dx_ulp), \
        (mean, invstd, sums)


def in_library_calls(torch, x, dy, w, b):
    """``F.instance_norm`` + ``F.leaky_relu`` and autograd's backward of
    them: the yardstick, never the port's path."""
    F = torch.nn.functional
    xl, wl, bl = x.detach().requires_grad_(), w.clone().requires_grad_(), b.clone().requires_grad_()
    yl = F.leaky_relu(F.instance_norm(xl, weight=wl, bias=bl, eps=IN_EPS), IN_SLOPE)
    return {"forward": lambda: F.leaky_relu(F.instance_norm(x, weight=w, bias=b, eps=IN_EPS), IN_SLOPE),
            "backward": lambda: torch.autograd.grad(yl, (xl, wl, bl), dy, retain_graph=True)}


def run_in_step(torch, task, step: dict, kernels: int, values: int, label: str) -> dict:
    """``step["steps"]`` train steps of ``task`` on seeded crops of
    ``step["crop"]``³, batch ``step["batch"]``, 3-class label maps: the
    InstanceNorm kernels launched a step, counted from 0 just before each
    (the run fails on another count than ``kernels``), the
    ``norm.instance_kernels`` and ``norm.instance_values`` counters of the
    first (``kernels`` and ``values``), the gradients and activations
    copied into channels-last, and the losses."""
    from medical_image_segmentation_tpu_torch.core import profiling
    from medical_image_segmentation_tpu_torch.ops import instance_norm as inn

    gen = torch.Generator(device=IN_DEVICE).manual_seed(5)
    size = (step["batch"], *(step["crop"],) * 3, 1)
    x = torch.randn(size, generator=gen, device=IN_DEVICE)
    labels = torch.randint(0, 3, size, generator=gen, device=IN_DEVICE).float()
    launches, copies, losses = [], [], []
    for k in range(step["steps"]):
        profiling.reset_counters()
        inn.launches = 0
        dy_before, x_before = inn.dy_copies, inn.x_copies
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) if k == 0 \
                else contextlib.nullcontext():
            losses.append(float(task.train_step(x, labels)["train/loss"]))
        if k == 0:
            counted = profiling.counters()
            check(counted.get("norm.instance_kernels") == kernels and counted.get("norm.instance_values") == values,
                  f"in_kernels {label} step: counters {counted}")
        launches.append(inn.launches)
        copies.append((inn.dy_copies - dy_before, inn.x_copies - x_before))
    profiling.reset_counters()
    inn.launches = 0  # the other paths count from here
    check(all(n == kernels for n in launches),
          f"the {label} train step launched {launches} InstanceNorm kernels a step, not {kernels}")
    check(all(math.isfinite(v) for v in losses), f"in_kernels {label} step: losses {losses}")
    return {"launches_per_step": launches[0], "dy_copies_per_step": copies[0][0], "x_copies_per_step": copies[0][1],
            "losses": losses}


def run_nnunet_step(torch) -> dict:
    """nnU-Net's train step at nnunet3d_liver.train's size (128³, batch 2,
    the published widths, bf16)."""
    from medical_image_segmentation_tpu_torch.models.plain_unet3d import nnunet_features
    from medical_image_segmentation_tpu_torch.train.seg3d_task import Segmentation3DTask

    task = Segmentation3DTask(arch="nnunet3d", n_classes=3, features=nnunet_features(), loss="dice_ce_ds",
                              learning_rate=0.01, momentum=0.99, weight_decay=3e-5, max_epochs=1000,
                              steps_per_epoch=250, dtype=torch.bfloat16, device=IN_DEVICE)
    task.init(0)
    out = run_in_step(torch, task, IN_STEP, IN_STEP_KERNELS, IN_STEP_VALUES, "nnunet")
    del task
    torch.cuda.empty_cache()
    return out


def run_swin_step(torch) -> dict:
    """Swin UNETR's train step at swin_unetr_liver.train's size (96³, batch
    4, feature size 48, bf16), in the schedule past its warmup."""
    from medical_image_segmentation_tpu_torch.train.seg3d_task import Segmentation3DTask

    task = Segmentation3DTask(arch="swin_unetr", n_classes=3, feature_size=48, learning_rate=1e-4,
                              weight_decay=1e-5, warmup_epochs=50, max_epochs=5000, steps_per_epoch=26,
                              dtype=torch.bfloat16, device=IN_DEVICE)
    task.init(0)
    task.step = 1300
    out = run_in_step(torch, task, IN_SWIN_STEP, IN_SWIN_STEP_KERNELS, IN_SWIN_STEP_VALUES, "swin_unetr")
    del task
    torch.cuda.empty_cache()
    return out


def take_in_launches(paths: dict, path: str) -> None:
    """InstanceNorm's kernel launches in this process since the last take,
    added to ``paths[path]``: none of the smoke's other paths runs nnU-Net."""
    from medical_image_segmentation_tpu_torch.ops import instance_norm as inn

    paths[path] = paths.get(path, 0) + inn.launches
    inn.launches = 0


def run_in_kernels(torch, card: str) -> dict:
    """InstanceNorm's kernels against their plain versions, timed beside
    their bounds, the plain versions and the library calls at the nnU-Net
    cell's shapes, then the nnU-Net train step's launches. Returns the
    kernels-line fields of ``instance_norm``; the other paths' launches are
    counted where they run (``take_in_launches``)."""
    from medical_image_segmentation_tpu_torch.ops import _kernels
    from medical_image_segmentation_tpu_torch.ops import instance_norm as inn

    t0 = time.time()
    so = _kernels.build_kernel("instance_norm")
    with open(so[:-3] + ".log") as f:
        ptxas = " | ".join(ln.strip() for ln in f if "registers" in ln or "spill" in ln or "stack" in ln)
    phase("build", kernel="instance_norm", seconds=round(time.time() - t0, 2), ptxas=ptxas or "(cached)")
    record = {}
    for name, shape in IN_CASES:
        x, dy = in_inputs(torch, shape, 0), in_inputs(torch, shape, 1)
        gen = torch.Generator(device=IN_DEVICE).manual_seed(2)
        w = torch.rand(shape[1], generator=gen, device=IN_DEVICE) + 0.5
        b = torch.randn(shape[1], generator=gen, device=IN_DEVICE)
        errs, (mean, invstd, sums) = check_in_case(torch, inn, name, x, dy, w, b)
        per = inn.launches_per_call(x)
        before = inn.launches
        inn.forward(x, w, b, IN_EPS, IN_SLOPE)
        inn.backward(x, dy, w, b, mean, invstd, IN_SLOPE)
        check(inn.launches - before == 2 * per, f"in_kernels {name}: {inn.launches - before} launches, not 2 × {per}")
        if per == 1:
            kernels = {"fused_forward": lambda: inn.fused_forward(x, w, b, IN_EPS, IN_SLOPE),
                       "fused_backward": lambda: inn.fused_backward(x, dy, w, b, mean, invstd, IN_SLOPE)}
            plain = {"fused_forward": lambda: inn.normalize_reference(x, w, b, *inn.statistics_reference(x, IN_EPS),
                                                                      IN_SLOPE),
                     "fused_backward": lambda: inn.backward_elemt_reference(
                         x, dy, w, b, mean, invstd, inn.backward_reduce_reference(x, dy, w, b, mean, invstd, IN_SLOPE),
                         IN_SLOPE)}
        else:
            kernels = {"stats": lambda: inn.statistics(x, IN_EPS),
                       "normalize": lambda: inn.normalize(x, w, b, mean, invstd, IN_SLOPE),
                       "backward_reduce": lambda: inn.backward_reduce(x, dy, w, b, mean, invstd, IN_SLOPE),
                       "backward_elemt": lambda: inn.backward_elemt(x, dy, w, b, mean, invstd, sums, IN_SLOPE)}
            plain = {"stats": lambda: inn.statistics_reference(x, IN_EPS),
                     "normalize": lambda: inn.normalize_reference(x, w, b, mean, invstd, IN_SLOPE),
                     "backward_reduce": lambda: inn.backward_reduce_reference(x, dy, w, b, mean, invstd, IN_SLOPE),
                     "backward_elemt": lambda: inn.backward_elemt_reference(x, dy, w, b, mean, invstd, sums,
                                                                            IN_SLOPE)}
        composite = {"forward": lambda: inn.forward(x, w, b, IN_EPS, IN_SLOPE),
                     "backward": lambda: inn.backward(x, dy, w, b, mean, invstd, IN_SLOPE)}
        try:
            library = in_library_calls(torch, x, dy, w, b)
        except RuntimeError as e:  # a yardstick that does not run here is reported, not fatal
            library = f"refused: {str(e).splitlines()[0][:80]}"
        need = in_kernel_bytes(shape, x.element_size())
        a = math.prod(shape) * x.element_size()
        fields = dict(case=name, shape=shape, launches_forward=per, launches_backward=per, **errs)
        for part in kernels:  # the kernels first, before the plain versions fill the allocator's cache
            ms = cold_ms(kernels[part], 10)
            bound_ms = need[part] / HBM_BYTES_PER_S * 1e3
            fields.update({f"{part}_ms": ms, f"{part}_bound_ms": bound_ms, f"{part}_share": bound_ms / ms,
                           f"{part}_bytes": need[part]})
        for part, moved in (("forward", 3 if per == 3 else 2), ("backward", 5 if per == 3 else 3)):
            ms = cold_ms(composite[part], 10)  # against the bytes the design moves: 3a and 5a, fused 2a and 3a
            fields.update({f"{part}_ms": ms, f"{part}_share": moved * a / HBM_BYTES_PER_S * 1e3 / ms})
        for part in composite:
            try:
                fields[f"{part}_library_ms"] = library if isinstance(library, str) else cold_ms(library[part], 5)
            except RuntimeError as e:
                fields[f"{part}_library_ms"] = f"refused: {str(e).splitlines()[0][:80]}"
        for part in plain:
            fields[f"{part}_plain_ms"] = cold_ms(plain[part], 3)
        phase("in_kernels", **fields, card=repr(card))
        record[name] = {k: v for k, v in fields.items() if k.endswith(("_ms", "_share", "_bytes"))}
        del x, dy, mean, invstd, sums, kernels, plain, composite, library
        torch.cuda.empty_cache()
    for name, shape in IN_SWIN_CASES:
        x, dy = in_inputs(torch, shape, 0), in_inputs(torch, shape, 1)
        w, b = torch.ones(shape[1], device=IN_DEVICE), torch.zeros(shape[1], device=IN_DEVICE)  # affine=False
        for slope in IN_SWIN_SLOPES:
            errs, _ = check_in_case(torch, inn, f"swin {name} slope {slope}", x, dy, w, b, slope)
            per, before = inn.launches_per_call(x), inn.launches
            _, mean, invstd = inn.forward(x, w, b, IN_EPS, slope)
            inn.backward(x, dy, w, b, mean, invstd, slope)
            check(inn.launches - before == 2 * per,
                  f"in_kernels swin {name}: {inn.launches - before} launches, not 2 × {per}")
            phase("in_kernels", case=f"swin_{name}", shape=shape, affine=False, slope=slope, launches_forward=per,
                  launches_backward=per, **errs, card=repr(card))
        del x, dy, mean, invstd
        torch.cuda.empty_cache()
    step = run_nnunet_step(torch)
    phase("in_kernels", case="nnunet_step", **step, card=repr(card))
    swin = run_swin_step(torch)
    phase("in_kernels", case="swin_unetr_step", **swin, card=repr(card))
    return dict(launches_nnunet_train_path=step["launches_per_step"], dy_copies_per_step=step["dy_copies_per_step"],
                launches_swin_unetr_train_path=swin["launches_per_step"], **record)


def run_ab(torch, fa, dm_mod, old_source: str, card: str) -> None:
    """Another version of ``csrc/two_view_augment.cu`` (same C interface)
    against this one at the main shape: both checked against the plain
    version, then timed cold in turns old, new, new, old, and L2-warm."""
    from medical_image_segmentation_tpu_torch.ops._kernels import load_kernel_library

    old_lib = load_kernel_library("two_view_augment", os.path.abspath(old_source))
    name, imgs, cfg1, cfg2, mean, std = next(iter(kernel_cases(torch, dm_mod)))
    b, h, w = imgs.shape[:3]
    params = fa.sample_view_params(torch.Generator(device="cuda").manual_seed(1), b, h, w, cfg1, cfg2)
    args = (params, imgs, cfg1.out_size, tuple(mean), tuple(std), cfg1.value_max, torch.bfloat16)
    want = fa.two_view_augment_reference(*args)
    fns = {"old": lambda: fa._launch(*args, lib=old_lib), "new": lambda: fa._launch(*args)}
    for label, fn in fns.items():
        got = fn()
        torch.cuda.synchronize()
        ulp = max(bf16_ulps(g, r) for g, r in zip(got, want))
        check(ulp <= 1, f"ab: the {label} kernel differs from the plain version by {ulp} bf16 ulp")
    order = ["old", "new", "new", "old"]
    cold = [cold_ms(fns[k], 50) for k in order]
    warm = [warm_ms(fns[k], 200) for k in order]
    prof = [profiled_us(fns[k], 20) for k in order]
    bounds = kernel_bounds(torch, fa, params, imgs, cfg1.out_size, torch.bfloat16)
    phase("ab", case=name, order=",".join(order), cold_ms=cold, warm_ms=warm, profiled_cold_us=prof,
          old_cold_ms=min(cold[0], cold[3]), new_cold_ms=min(cold[1], cold[2]),
          new_share_of_bound=bounds["bound_us"] / (1000.0 * min(cold[1], cold[2])),
          bound_us=bounds["bound_us"], bound_whole_us=bounds["bound_whole_us"], card=repr(card))
    check(max(cold[1], cold[2]) < min(cold[0], cold[3]), f"ab: the new kernel is not the faster: {cold}")
    # the same images and sampler at larger batches: a call's fixed cost
    # (the blocks' first loads and last computes) against its cost a sample
    for batch in (1024, 4096):
        big = imgs.repeat(batch // b, 1, 1, 1)
        p = fa.sample_view_params(torch.Generator(device="cuda").manual_seed(2), batch, h, w, cfg1, cfg2)
        big_args = (p, big, *args[2:])
        us = {k: profiled_us(lambda lib=lib: fa._launch(*big_args, lib=lib), 10)
              for k, lib in (("old", old_lib), ("new", None))}
        bound_us = kernel_bounds(torch, fa, p, big, cfg1.out_size, torch.bfloat16)["bound_us"]
        phase("ab_batch", batch=batch, old_profiled_us=us["old"], new_profiled_us=us["new"], bound_us=bound_us,
              new_share_of_bound=bound_us / us["new"], card=repr(card))


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
        if not keys:  # GroupNorm keeps no statistics
            continue
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
    check(result.reader == "native", f"the raw store was read by the {result.reader} reader")
    steady = result.epochs[1:]
    ms_step = 1000.0 * sum(e["seconds"] for e in steady) / sum(e["steps"] for e in steady)
    phase("train", steps=task.step, launches=launches, losses=losses, params_moved=f"{moved}/{n_params}",
          reader=result.reader, store_setup_s=round(setup_s, 2), wall_s=round(wall, 2),
          steady_ms_per_step=ms_step, steady_img_per_s=256 * 1000.0 / ms_step, card=repr(card))
    return task, launches, ckpt, ms_step


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


# The native store reader (medical_image_segmentation_tpu_torch/csrc/
# mis_loader.cpp on its own JPEG and PNG decoders, built with g++ alone)
NATIVE_EQUAL_IMAGES = 16           # images a store in the byte-equality checks
NATIVE_BATCH = 256                 # images of 256² in a timed batch
NATIVE_THREADS = (1, 8)
JPEG_QUALITY = 90                  # create_store's default
JPEG_TRAIN_DISTINCT = 256          # distinct slices behind the JPEG trainer store's 2,048 records
JPEG_TRAIN_EPOCHS, JPEG_TRAIN_STEPS = 2, 8
NATIVE_LIBS = ("linux-vdso", "libc.so", "libm.so", "libstdc++.so", "libgcc_s.so", "libpthread.so", "ld-linux")


def ct_slices(rng, n: int, size: int):
    """(n, size, size) uint8 CT-like slices: a bright ellipse of body on a
    dark field, smooth structure and noise, as JPEG stores hold them."""
    import numpy as np

    yy, xx = np.mgrid[:size, :size] / size
    out = np.empty((n, size, size), np.uint8)
    for i in range(n):
        cy, cx, ry, rx = rng.uniform(0.45, 0.55), rng.uniform(0.45, 0.55), rng.uniform(0.3, 0.4), rng.uniform(0.35, 0.45)
        body = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1
        tissue = 110 + 40 * np.sin(9 * xx + rng.uniform(0, 6)) * np.cos(7 * yy + rng.uniform(0, 6))
        out[i] = np.clip(np.where(body, tissue, 8) + rng.normal(0, 6, (size, size)), 0, 255).astype(np.uint8)
    return out


def write_payload_store(path: str, payloads, size: int, codec: int, n: int, dtype=None) -> None:
    """A store of ``n`` records cycling through pre-encoded payloads."""
    import numpy as np

    from medical_image_segmentation_tpu_torch.data.store import StoreWriter

    with StoreWriter(path, channels=1, dtype=dtype or np.uint8) as w:
        for i in range(n):
            w.add_encoded(payloads[i % len(payloads)], size, size, label=i, codec=codec)


def native_equality_stores(workdir: str) -> dict:
    """Stores from a seed, one a codec: name → path."""
    import numpy as np

    from medical_image_segmentation_tpu_torch.data.jpegls import jpeg_ls_encode
    from medical_image_segmentation_tpu_torch.data.store import CODEC_JLS, CODEC_JPEG, CODEC_PNG, CODEC_RAW
    from medical_image_segmentation_tpu_torch.data.store.writer import _encode
    from medical_image_segmentation_tpu_torch.utils.png import encode_png

    rng = np.random.default_rng(17)
    n, size = NATIVE_EQUAL_IMAGES, 256
    u8 = ct_slices(rng, n, size)
    u16 = (u8.astype(np.uint16) * 16 + rng.integers(0, 16, u8.shape)).astype(np.uint16)
    cases = {
        "raw_u8": ([_encode(im, CODEC_RAW, 0) for im in u8], CODEC_RAW, np.uint8),
        "raw_u16": ([_encode(im, CODEC_RAW, 0) for im in u16], CODEC_RAW, np.uint16),
        "jpeg_q75": ([_encode(im, CODEC_JPEG, 75) for im in u8], CODEC_JPEG, np.uint8),
        "jpeg_q95": ([_encode(im, CODEC_JPEG, 95) for im in u8], CODEC_JPEG, np.uint8),
        "png_8bit": ([encode_png(im) for im in u8], CODEC_PNG, np.uint8),
        "png_16bit": ([encode_png(im) for im in u16], CODEC_PNG, np.uint16),
        "jpegls_u8": ([jpeg_ls_encode(im, precision=8) for im in u8], CODEC_JLS, np.uint8),
        "jpegls_u16": ([jpeg_ls_encode(im, precision=16) for im in u16], CODEC_JLS, np.uint16),
    }
    out = {}
    for name, (payloads, codec, dtype) in cases.items():
        out[name] = os.path.join(workdir, f"native_{name}.mis")
        write_payload_store(out[name], payloads, size, codec, n, dtype)
    return out


def run_native_store(workdir: str, card: str) -> dict:
    """The port's native reader: its build (command, seconds, the shared
    object's libraries), byte equality of fetch and fetch_views with the
    Python reader on every codec, and ms a batch of 256 × 256² native (1
    and 8 threads) against the Python reader, on a raw and a gray JPEG
    store. Returns the timings."""
    import numpy as np

    from medical_image_segmentation_tpu_torch.data.host_precrop import fetch_views_fallback, make_view_params
    from medical_image_segmentation_tpu_torch.data.loader import Loader
    from medical_image_segmentation_tpu_torch.data.store import CODEC_JPEG, CODEC_RAW, StoreReader, native
    from medical_image_segmentation_tpu_torch.data.store.writer import _encode

    t0 = time.time()
    lib = native.get_lib()
    check(lib is not None, "the port's native library did not build")
    info = native.build_info()
    ldd = subprocess.run(["ldd", info["path"]], capture_output=True, text=True, timeout=60).stdout
    libs = sorted({ln.split()[0] for ln in ldd.splitlines() if ln.strip()})
    check(libs and all(name.startswith(NATIVE_LIBS) or name.startswith("/lib") for name in libs),
          f"the native library needs {libs}")
    check(not [a for a in info["command"] if a.startswith("-l")], f"build links libraries: {info['command']}")
    equal = {}
    for name, path in native_equality_stores(workdir).items():
        store, reader = native.NativeStore(path), StoreReader(path)
        try:
            idx = np.arange(store.num_samples)
            got, _ = store.fetch(idx, num_threads=8)
            want = np.stack([reader.image(i) for i in idx])
            params = make_view_params(5, 0, 0, len(idx), 256, 256, n_views=2)
            views, _ = store.fetch_views(idx, params, (112, 112), num_threads=8)
            want_views, _ = fetch_views_fallback(reader, idx, params, (112, 112))
        finally:
            store.close()
            reader.close()
        check(got.dtype == want.dtype and np.array_equal(got, want), f"native fetch differs from Python on {name}")
        check(np.array_equal(views, want_views), f"native fetch_views differs from Python on {name}")
        equal[name] = "fetch+views"
    rng = np.random.default_rng(23)
    slices = ct_slices(rng, NATIVE_BATCH, 256)
    timings = {}
    for name, codec in (("raw", CODEC_RAW), ("jpeg", CODEC_JPEG)):
        path = os.path.join(workdir, f"native_time_{name}.mis")
        write_payload_store(path, [_encode(im, codec, JPEG_QUALITY) for im in slices], 256, codec, NATIVE_BATCH)
        idx = np.arange(NATIVE_BATCH)
        # the Loader's own fetch of one batch: native with nt threads, or
        # the Python reader (one thread whatever nt says), timed once
        for route, nt, repeat in [("native", nt, 3) for nt in NATIVE_THREADS] + [("python", 1, 1)]:
            loader = Loader(path, NATIVE_BATCH, num_threads=nt, prefetch=0, use_native=route == "native")
            try:
                check((loader._native is not None) == (route == "native"), f"the {route} route did not serve")
                loader._fetch(idx)  # warm: page cache, the pool's threads
                ms = []
                for _ in range(repeat):
                    t1 = time.perf_counter()
                    loader._fetch(idx)
                    ms.append(1000.0 * (time.perf_counter() - t1))
            finally:
                loader.close()
            timings[f"{name}_{route}_ms" + (f"_t{nt}" if route == "native" else "")] = min(ms)
    phase("native_store", build_s=None if info["seconds"] is None else round(info["seconds"], 2),
          command=" ".join(os.path.relpath(a, ROOT) if a.startswith(ROOT) else a for a in info["command"]),
          libraries=libs, cpu_count=os.cpu_count(), byte_equal=equal, batch=f"{NATIVE_BATCH}x256x256",
          jpeg_quality=JPEG_QUALITY, **timings, seconds=round(time.time() - t0, 2), card=repr(card))
    return timings


def run_jpeg_trainer(torch, fa, workdir: str, raw_ms: float, card: str) -> int:
    """``mis-train-ssl-torch`` on a gray JPEG 256² store (2,048 records of
    JPEG_TRAIN_DISTINCT distinct slices at quality 90) for JPEG_TRAIN_EPOCHS ×
    JPEG_TRAIN_STEPS steps: the native reader decodes, the kernel makes the
    views. Returns the kernel's launches in the run."""
    import numpy as np

    from medical_image_segmentation_tpu_torch.data.store import CODEC_JPEG
    from medical_image_segmentation_tpu_torch.data.store.writer import _encode
    from medical_image_segmentation_tpu_torch.train import train_ssl

    t0 = time.time()
    store = os.path.join(workdir, "radiology_jpeg.mis")
    slices = ct_slices(np.random.default_rng(29), JPEG_TRAIN_DISTINCT, 256)
    write_payload_store(store, [_encode(im, CODEC_JPEG, JPEG_QUALITY) for im in slices], 256, CODEC_JPEG, 2048)
    setup_s = time.time() - t0
    raw_store = os.environ["RADIOLOGY_1M_TRAIN_STORE"]
    os.environ["RADIOLOGY_1M_TRAIN_STORE"] = store
    try:
        fa.fused_two_view_augment.launches = 0
        t0 = time.time()
        result = train_ssl.run(ssl_argv(workdir, "jpeg", "RADIOLOGY_1M", "--max_epochs", str(JPEG_TRAIN_EPOCHS),
                                        "--limit_steps_per_epoch", str(JPEG_TRAIN_STEPS),
                                        "--checkpoint_every_epochs", "0"))
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        os.environ["RADIOLOGY_1M_TRAIN_STORE"] = raw_store
    launches = fa.fused_two_view_augment.launches
    n_steps = JPEG_TRAIN_EPOCHS * JPEG_TRAIN_STEPS
    check(result.reader == "native", f"the JPEG store was read by the {result.reader} reader")
    check(result.used_kernel and launches >= n_steps, f"kernel launched {launches} times for {n_steps} steps")
    check(result.task.step == n_steps and all(math.isfinite(e["loss"]) for e in result.epochs),
          f"JPEG-store run: {result.task.step} steps, epochs {result.epochs}")
    steady = result.epochs[1:]
    ms_step = 1000.0 * sum(e["seconds"] for e in steady) / sum(e["steps"] for e in steady)
    phase("train_jpeg", steps=result.task.step, launches=launches, reader=result.reader,
          losses=[round(e["loss"], 4) for e in result.epochs], store_setup_s=round(setup_s, 2),
          wall_s=round(wall, 2), steady_ms_per_step=ms_step, steady_img_per_s=SSL_BATCH * 1000.0 / ms_step,
          raw_store_steady_ms_per_step=raw_ms, card=repr(card))
    return launches


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
EXPORT_BUCKETS = (1, 8, 64)


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
    check(result.reader == "native", f"the seg stores were read by the {result.reader} reader")
    steady = result.epochs[1:]
    ms_step = 1000.0 * sum(e["seconds"] for e in steady) / sum(e["steps"] for e in steady)
    phase("seg_train", steps=task.step, losses=losses, grafted=f"{len(grafted)}/{len(enc)}", reader=result.reader,
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


def served_masks(out_dir: str):
    """The masks ``mis-predict-torch`` wrote under ``out_dir``, by name."""
    from medical_image_segmentation_tpu_torch.utils.png import decode_png

    out = {}
    for name in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, name), "rb") as f:
            out[name] = decode_png(f.read())
    return out


def run_export(torch, workdir: str, ckpt: str, card: str) -> None:
    """``mis-export-torch`` on the trained checkpoint, then the artifact
    against the checkpoint-backed serving of phase 9."""
    import numpy as np

    from medical_image_segmentation_tpu_torch import serve
    from medical_image_segmentation_tpu_torch.data.datamodules import get_datamodule
    from medical_image_segmentation_tpu_torch.train import export, predict
    from medical_image_segmentation_tpu_torch.train.segmentation_task import SegmentationTask

    art = os.path.join(workdir, "model.misx")
    t0 = time.time()
    summary = export.run(["--checkpoint", os.path.dirname(ckpt), "--output", art, "--dataset", SEG_DATASET,
                          "--image_size", str(SEG_SIZE), "--batch_sizes", ",".join(map(str, EXPORT_BUCKETS)),
                          "--device", SEG_DEVICE])
    export_s = time.time() - t0
    check(summary["batch_sizes"] == sorted(EXPORT_BUCKETS) and summary["platforms"] == [torch.device(SEG_DEVICE).type]
          and summary["bytes"] == os.path.getsize(art), f"export summary {summary}")

    # served in turns from the checkpoint and from the artifact: equal masks
    store = os.path.join(workdir, "predict_batched.mis")
    ckpt_argv = ["--checkpoint", os.path.dirname(ckpt), "--dataset", SEG_DATASET, "--image_size", str(SEG_SIZE),
                 "--batch_size", str(SEG_BATCH)]
    rates, loads = [], []
    for i, route in enumerate(("checkpoint", "exported", "exported", "checkpoint")):
        out_dir = os.path.join(workdir, f"masks_turn{i}")
        out = predict.run([*(ckpt_argv if route == "checkpoint" else ["--exported", art]), "--device", SEG_DEVICE,
                           "--num_workers", "8", "--image_store", store, "--output_dir", out_dir])
        check(out["images"] == PREDICT_SLICES and out["exported"] == (route == "exported"), f"{route}: {out}")
        rates.append((route, out["images"] / out["seconds"]))
        if route == "exported":  # what the run spent deserializing its buckets, and its rate without that
            check(0.0 < out["load_seconds"] < out["seconds"], f"exported: load_seconds in {out}")
            loads.append((round(out["load_seconds"], 3), round(out["images"] / (out["seconds"] - out["load_seconds"]), 1)))
    want = served_masks(os.path.join(workdir, "masks_batched"))
    differing = 0
    for i in (1, 2):
        got = served_masks(os.path.join(workdir, f"masks_turn{i}"))
        check(sorted(got) == sorted(want), f"--exported wrote {len(got)} masks for {len(want)}")
        differing += sum(int((got[n] != want[n]).sum()) for n in want)
    check(differing == 0, f"--exported masks differ from the checkpoint-backed masks on {differing} pixels")

    # the predictor on requests of any size against the function it captured, on the same chunks
    dm = get_datamodule(SEG_DATASET)()
    task = SegmentationTask(device=SEG_DEVICE)
    task.model.load_state_dict(torch.load(ckpt, map_location=SEG_DEVICE, weights_only=True)["model"])
    fn = serve.make_predict_fn(task, float(dm.mean[0]), float(dm.std[0]))
    predictor = serve.load_predictor(art, device=SEG_DEVICE)
    rng = np.random.default_rng(2)
    whole_batch = []
    for n, chunks in ((1, [1]), (9, [8, 1]), (73, [64, 8, 1])):
        imgs = np.stack([img for img, _ in disk_slices(rng, n, SEG_SIZE)])[..., None]
        got = predictor(imgs)
        x = torch.from_numpy(imgs).to(SEG_DEVICE)
        want_n = torch.cat([fn(part) for part in torch.split(x, chunks)]).cpu().numpy()
        check(got.shape == want_n.shape and got.dtype == np.uint8 and np.array_equal(got, want_n),
              f"ServingPredictor on {n} images differs from make_predict_fn on chunks {chunks} "
              f"on {int((got != want_n).sum())} pixels")
        whole_batch.append(float((got == fn(x).cpu().numpy()).mean()))
    check(min(whole_batch) >= 0.999, f"artifact against one whole-batch forward: {whole_batch}")
    # a loaded bucket against the function it captured, per batch of 64 from host memory to host memory
    imgs = imgs[:SEG_BATCH]
    batch_ms = [(name, event_ms(torch, call, 10)) for name, call in (
        ("checkpoint", lambda: fn(torch.from_numpy(imgs).to(SEG_DEVICE)).cpu()), ("exported", lambda: predictor(imgs)),
        ("exported", lambda: predictor(imgs)), ("checkpoint", lambda: fn(torch.from_numpy(imgs).to(SEG_DEVICE)).cpu()))]

    # where a bucket's load goes: torch.export.load (the graph rebuilt in Python), .module(), the first call
    _, blobs = serve._read_container(art)
    load_parts = {}
    for b in sorted(blobs):
        t0 = time.time()
        program = torch.export.load(io.BytesIO(blobs[b]))
        t1 = time.time()
        module = program.module()
        t2 = time.time()
        with torch.no_grad():
            module(torch.zeros((b, SEG_SIZE, SEG_SIZE, 1), dtype=torch.uint8, device=SEG_DEVICE))
        torch.cuda.synchronize()
        load_parts[b] = {"export_load_s": round(t1 - t0, 3), "module_s": round(t2 - t1, 3),
                         "first_call_s": round(time.time() - t2, 3), "blob_mb": round(len(blobs[b]) / 1e6, 1)}

    # a serving host: a fresh process loads and calls the artifact without any model code
    code = ("import json, sys, time, numpy as np\n"
            "t = [time.time()]\n"
            "import torch\n"
            "t.append(time.time())\n"
            f"sys.path.insert(0, {ROOT!r})\n"
            f"from {PKG}.serve import load_predictor\n"
            "t.append(time.time())\n"
            f"torch.zeros(1, device={SEG_DEVICE!r})\n"
            "t.append(time.time())\n"
            f"predictor = load_predictor({art!r}, device={SEG_DEVICE!r})\n"
            f"imgs = np.zeros((9, {SEG_SIZE}, {SEG_SIZE}, 1), np.uint8)\n"
            "masks = predictor(imgs)\n"
            "t.append(time.time())\n"
            "predictor(imgs)\n"
            "t.append(time.time())\n"
            f"bad = [m for m in sys.modules if m.startswith(('{PKG}.models', '{PKG}.train', 'jax'))]\n"
            "names = ('import_torch_s', 'import_serve_s', 'device_init_s', 'first_request_s', 'second_request_s')\n"
            "stages = {n: round(b - a, 3) for n, a, b in zip(names, t, t[1:])}\n"
            "stages['bucket_load_s'] = round(predictor.load_seconds, 3)\n"
            "print('STAGES', json.dumps(stages))\n"
            "print('SERVED', masks.shape, 'MODEL_CODE', bad)\n")
    t0 = time.time()
    host = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    check(host.returncode == 0 and f"SERVED (9, {SEG_SIZE}, {SEG_SIZE}, 1) MODEL_CODE []" in host.stdout,
          f"the serving process: rc {host.returncode}, out {host.stdout[-300:]!r}, err {host.stderr[-600:]!r}")
    stages = json.loads(next(line for line in host.stdout.splitlines() if line.startswith("STAGES "))[7:])
    phase("export", buckets=sorted(EXPORT_BUCKETS), artifact_bytes=summary["bytes"], export_s=round(export_s, 2),
          exported_masks_differing_pixels=differing, predictor_n=[1, 9, 73], whole_batch_agreement=whole_batch,
          img_per_s_in_turns=[(r, round(v, 1)) for r, v in rates],
          exported_load_s_and_img_per_s_without_it=loads, bucket_load_parts=load_parts,
          ms_per_batch_64_in_turns=[(r, round(v, 3)) for r, v in batch_ms], serving_process_s=round(time.time() - t0, 2),
          serving_process_stages=stages, model_code_loaded_in_serving_process=[], card=repr(card))


def run_fused2d(torch, workdir: str, ckpt: str, card: str) -> None:
    """The fused sliding-window predictor against the loop, alone and
    through ``mis-predict-torch --sliding_window``."""
    import numpy as np

    from medical_image_segmentation_tpu_torch.data.datamodules import get_datamodule
    from medical_image_segmentation_tpu_torch.eval.sliding_window import make_fused_predictor_2d, sliding_window_predict
    from medical_image_segmentation_tpu_torch.serve import normalize_u8
    from medical_image_segmentation_tpu_torch.train import predict
    from medical_image_segmentation_tpu_torch.train.segmentation_task import SegmentationTask

    dm = get_datamodule(SEG_DATASET)()
    state = torch.load(ckpt, map_location=SEG_DEVICE, weights_only=True)["model"]
    img = next(disk_slices(np.random.default_rng(1), 1, PREDICT_SIZE))[0]
    x = normalize_u8(torch.from_numpy(img[..., None]).to(SEG_DEVICE), dm.mean, dm.std)
    fields = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        task = SegmentationTask(device=SEG_DEVICE, dtype=dtype)
        task.model.load_state_dict(state)
        fused = make_fused_predictor_2d(task.logits, x.shape, SEG_SIZE, device=SEG_DEVICE)
        eager, got, again = fused(x), fused(x), fused(x)  # the warm-up pass, the capture and a replay, a replay
        want = sliding_window_predict(task.logits, x, SEG_SIZE)
        rel = float((got - want).abs().max() / want.abs().max())
        check(got.shape == want.shape and rel <= 1e-5, f"fused 2D against the loop in {name}: {rel} of the largest logit")
        check(fused.replays == 2 and torch.equal(again, got) and torch.equal(eager, got),
              "the eager pass, the first replay and the second replay of the fused predictor disagree")
        fields[f"{name}_rel"] = rel
        fields[f"{name}_capture_s"] = round(fused.capture_seconds, 3)
    # bf16, as served: device time and kernels of one slice, both variants
    fields.update(loop_device_ms=event_ms(torch, lambda: sliding_window_predict(task.logits, x, SEG_SIZE), 20),
                  fused_device_ms=event_ms(torch, lambda: fused(x), 20))
    loop_kernels = device_breakdown(torch, lambda: sliding_window_predict(task.logits, x, SEG_SIZE))
    fused_kernels = device_breakdown(torch, lambda: fused(x))
    fields.update(loop_kernels_per_slice=loop_kernels["kernels"], loop_busy_ms=loop_kernels.get("busy_ms"),
                  fused_kernels_per_slice=fused_kernels["kernels"], fused_busy_ms=fused_kernels.get("busy_ms"),
                  fused_launches_per_slice="1 graph + 2 copies")

    store = os.path.join(workdir, "predict_sliding.mis")
    argv = ["--checkpoint", os.path.dirname(ckpt), "--device", SEG_DEVICE, "--dataset", SEG_DATASET,
            "--image_size", str(SEG_SIZE), "--num_workers", "8", "--image_store", store,
            "--sliding_window", str(SEG_SIZE)]
    turns = []
    for i, use_fused in enumerate((False, True, True, False)):
        out_dir = os.path.join(workdir, f"masks_sliding_turn{i}")
        out = predict.run([*argv, "--output_dir", out_dir], fused=use_fused)
        check(out["images"] == SLIDING_SLICES and out["mode"] == "sliding_window", f"sliding turn {i}: {out}")
        if use_fused:
            check(out["fused_shapes"] == 1, f"{SLIDING_SLICES} slices of one shape built {out['fused_shapes']} predictors")
        turns.append(("fused" if use_fused else "loop", 1000.0 * out["seconds"] / out["images"],
                      out.get("capture_seconds")))
    loop_masks = served_masks(os.path.join(workdir, "masks_sliding_turn0"))
    differing = sum(int((m != loop_masks[n]).sum())
                    for n, m in served_masks(os.path.join(workdir, "masks_sliding_turn1")).items())
    check(differing == 0, f"fused sliding-window masks differ from the loop's on {differing} pixels")
    phase("fused2d", slice=f"{PREDICT_SIZE}x{PREDICT_SIZE}", windows=fused.n_windows, **fields,
          cli_ms_per_slice_in_turns=[(n, round(ms, 2)) for n, ms, _ in turns],
          cli_capture_s=[round(c, 3) for _, _, c in turns if c is not None], masks_differing_pixels=differing,
          card=repr(card))


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


# The SSL phases run the BYOL trainer at full width (ResNet-18, hidden
# 4096, projection 256, batch 256) on the RADIOLOGY_1M store of phase 6,
# and on a synthetic labelled CIFAR10 store (32² RGB, 10 classes): the
# reference's default configuration.
SSL_DEVICE = "cuda"
SSL_WIDTH = ["--arch", "resnet18", "--hidden_dim", "4096", "--projection_dim", "256"]
SSL_BATCH = 256
SSL_STEPS = 8                      # steps an epoch in the precrop, resume and profile phases
RESUME_STOP = 11                   # SIGTERM after this step of 2 × SSL_STEPS
CIFAR_SPLITS = {"train": 4096, "val": 1024}
KNN_BANK, KNN_DIM, KNN_QUERIES, KNN_CHUNK = 262144, 512, 256, 65536  # the trainer's default cap and chunk


def ssl_argv(workdir: str, name: str, dataset: str, *extra) -> list:
    """The BYOL trainer's argv at full width, logs and checkpoints under
    ``<workdir>/<name>``; no validation unless ``extra`` asks for it."""
    return ["--device", SSL_DEVICE, "--dataset", dataset, *SSL_WIDTH, "--batch_size", str(SSL_BATCH),
            "--warmup_epochs", "0", "--num_workers", "8", "--seed", "0", "--val_every_epochs", "0",
            "--log_dir", os.path.join(workdir, name, "logs"), "--checkpoint_dir", os.path.join(workdir, name, "ckpt"),
            *extra]


def stopped_run(task_cls, step: int, run, argv):
    """``run(argv)`` with SIGTERM sent to this process right after the task
    takes its ``step``-th step: the trainer checkpoints and returns."""
    import signal

    original = task_cls.train_step

    def step_then_signal(self, *a, **kw):
        out = original(self, *a, **kw)
        if self.step == step:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    task_cls.train_step = step_then_signal
    try:
        return run(argv)
    finally:
        task_cls.train_step = original


def cpu_tree(obj):
    """A nested state dict with every tensor copied to the host."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: cpu_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(cpu_tree(v) for v in obj)
    return obj


def trees_equal(a, b) -> bool:
    """Bit-equal nested state dicts."""
    import torch

    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(trees_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(trees_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b.to(a.device))
    return a == b


def epoch_ms(result) -> float:
    """Trainer ms per step over the run's epochs, the first (cuDNN
    autotuning, loader start) included."""
    return 1000.0 * sum(e["seconds"] for e in result.epochs) / sum(e["steps"] for e in result.epochs)


def run_precrop(torch, fa, workdir: str, card: str) -> None:
    """``--host_precrop`` on the RADIOLOGY_1M 256² store: the tail on the
    card against the CPU on the same draws, the bytes each route ships per
    batch, and the trainer for ``SSL_STEPS`` steps without a kernel launch."""
    import contextlib

    import numpy as np

    from medical_image_segmentation_tpu_torch.data.datamodules import get_datamodule
    from medical_image_segmentation_tpu_torch.ops.augment import apply_view_tail, sample_tail_draws
    from medical_image_segmentation_tpu_torch.train import train_ssl

    dm = get_datamodule("RADIOLOGY_1M")()
    cfg1, cfg2 = dm.view_configs()
    full = dm.train_loader(SSL_BATCH, num_threads=8, seed=0)
    pre = dm.train_loader(SSL_BATCH, num_threads=8, seed=0, precrop=train_ssl.precrop_spec(dm, cfg1, cfg2))
    with contextlib.closing(full), contextlib.closing(pre):
        imgs, _ = next(iter(full))
        t0 = time.time()
        views, _ = next(iter(pre))
        fetch_s = time.time() - t0
    check(views.shape == (2 * SSL_BATCH, dm.crop_size, dm.crop_size, 1) and views.dtype == np.uint8,
          f"pre-cropped batch {views.shape} {views.dtype}")
    gen = torch.Generator(device=SSL_DEVICE).manual_seed(5)
    on_card = torch.from_numpy(views).to(SSL_DEVICE)
    worst = 0
    for v, cfg in enumerate((cfg1, cfg2)):
        draws = sample_tail_draws(gen, SSL_BATCH, 1, cfg)
        got = apply_view_tail(draws, on_card[v::2], cfg, dm.train_mean, dm.train_std, torch.bfloat16)
        want = apply_view_tail({k: d.cpu() for k, d in draws.items()}, on_card[v::2].cpu(), cfg,
                               dm.train_mean, dm.train_std, torch.bfloat16)
        worst = max(worst, bf16_ulps(got.cpu(), want))
    check(worst <= 1, f"precrop tail: card and CPU differ by {worst} bf16 ulp")

    fa.fused_two_view_augment.launches = 0
    t0 = time.time()
    result = train_ssl.run(ssl_argv(workdir, "precrop", "RADIOLOGY_1M", "--host_precrop", "--max_epochs", "1",
                                    "--limit_steps_per_epoch", str(SSL_STEPS), "--checkpoint_every_epochs", "0"))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = fa.fused_two_view_augment.launches
    check(launches == 0 and not result.used_kernel, f"the precrop route launched the kernel {launches} times")
    check(result.reader == "native", f"the precrop store was read by the {result.reader} reader")
    check(result.task.step == SSL_STEPS and all(math.isfinite(e["loss"]) for e in result.epochs),
          f"precrop run: {result.task.step} steps, epochs {result.epochs}")
    phase("precrop", steps=result.task.step, kernel_launches=launches, tail_max_bf16_ulp=worst,
          h2d_bytes_per_batch_precrop=views.nbytes, h2d_bytes_per_batch_full=imgs.nbytes,
          h2d_ratio=imgs.nbytes / views.nbytes, reader=result.reader, host_fetch_s_per_batch=round(fetch_s, 3),
          ms_per_step=epoch_ms(result), wall_s=round(wall, 2), card=repr(card))


def run_resume(torch, fa, workdir: str, card: str) -> None:
    """Both trainers stopped by SIGTERM mid-epoch and resumed: they end at
    the last step having skipped exactly the trained batches, every step
    ran at the schedule's LR (and τ) once, and a checkpoint restores bit
    for bit."""
    from medical_image_segmentation_tpu_torch.core.checkpoint import load_checkpoint
    from medical_image_segmentation_tpu_torch.data.datamodules import get_datamodule
    from medical_image_segmentation_tpu_torch.train import train_segmentation, train_ssl
    from medical_image_segmentation_tpu_torch.train.byol_task import BYOLTask
    from medical_image_segmentation_tpu_torch.train.segmentation_task import SegmentationTask

    total, skip = 2 * SSL_STEPS, RESUME_STOP % SSL_STEPS
    argv = ssl_argv(workdir, "resume", "RADIOLOGY_1M", "--max_epochs", "2", "--limit_steps_per_epoch", str(SSL_STEPS))
    fa.fused_two_view_augment.launches = 0
    t0 = time.time()
    first = stopped_run(BYOLTask, RESUME_STOP, train_ssl.run, argv)
    second = train_ssl.run(argv + ["--resume"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = fa.fused_two_view_augment.launches
    task = second.task
    check(first.stopped and first.task.step == RESUME_STOP, f"BYOL stopped at {first.task.step}")
    check(second.resumed_from == RESUME_STOP and second.skipped == skip and task.step == total,
          f"BYOL resumed from {second.resumed_from}, skipped {second.skipped}, ended at {task.step}")
    want = [(s, task.schedule(s), task.ema_schedule(s, task.total_steps)) for s in range(total)]
    check(first.schedule + second.schedule == want, "BYOL: the steps' lr/tau differ from an uninterrupted run's")
    check(launches >= total, f"kernel launched {launches} times for {total} steps")
    saved = load_checkpoint(os.path.join(workdir, "resume", "ckpt", f"{RESUME_STOP}.pt"))
    fresh = train_ssl._make_task(train_ssl.parse_args(argv), get_datamodule("RADIOLOGY_1M")(), torch.bfloat16,
                                 torch.device(SSL_DEVICE), SSL_STEPS)
    fresh.load_state_dict(saved)
    gen = torch.Generator(device=SSL_DEVICE)
    gen.set_state(saved["aug_generator"])
    restored = {**cpu_tree(fresh.state_dict()), "epoch": saved["epoch"], "aug_generator": gen.get_state()}
    check(trees_equal(restored, saved), "BYOL: the restored state differs from the saved one")
    del fresh, first, second, task

    seg_argv = ["--device", SEG_DEVICE, "--dataset", SEG_DATASET, "--images_dir", workdir, "--masks_dir", workdir,
                "--seg_store_prefix", os.path.join(workdir, "seg"), "--arch", "resnet18", "--batch_size",
                str(SEG_BATCH), "--image_size", str(SEG_SIZE), "--max_epochs", "2", "--limit_steps_per_epoch",
                str(SEG_STEPS), "--warmup_epochs", "0", "--num_workers", "8", "--seed", "0",
                "--checkpoint_every_epochs", "0", "--checkpoint_dir", os.path.join(workdir, "seg_resume"),
                "--log_dir", os.path.join(workdir, "seg_resume_logs")]
    seg_total, seg_skip = 2 * SEG_STEPS, RESUME_STOP % SEG_STEPS
    t0 = time.time()
    seg_first = stopped_run(SegmentationTask, RESUME_STOP, train_segmentation.run, seg_argv)
    seg_second = train_segmentation.run(seg_argv + ["--resume"])
    torch.cuda.synchronize()
    seg_wall = time.time() - t0
    stask = seg_second.task
    check(seg_first.stopped and seg_first.task.step == RESUME_STOP, f"seg stopped at {seg_first.task.step}")
    check(seg_second.resumed_from == RESUME_STOP and seg_second.skipped == seg_skip and stask.step == seg_total,
          f"seg resumed from {seg_second.resumed_from}, skipped {seg_second.skipped}, ended at {stask.step}")
    check(seg_first.schedule + seg_second.schedule == [(s, stask.schedule(s)) for s in range(seg_total)],
          "seg: the steps' lr differ from an uninterrupted run's")
    seg_saved = load_checkpoint(seg_first.checkpoint)
    fresh = SegmentationTask(device=SEG_DEVICE)
    fresh.load_state_dict(seg_saved)
    gen = torch.Generator(device=SEG_DEVICE)
    gen.set_state(seg_saved["aug_generator"])
    restored = {**cpu_tree(fresh.state_dict()), "epoch": seg_saved["epoch"], "aug_generator": gen.get_state()}
    check(trees_equal(restored, seg_saved), "seg: the restored state differs from the saved one")
    phase("resume", byol_steps=f"{RESUME_STOP}+{total - RESUME_STOP}", byol_skipped=skip,
          byol_launches=launches, seg_steps=f"{RESUME_STOP}+{seg_total - RESUME_STOP}", seg_skipped=seg_skip,
          restored_bit_equal=True, byol_wall_s=round(wall, 2), seg_wall_s=round(seg_wall, 2), card=repr(card))


def write_labelled_store(path: str, n: int, size: int, channels: int, classes: int, seed: int) -> None:
    import numpy as np

    from medical_image_segmentation_tpu_torch.data.store import CODEC_RAW, StoreWriter

    rng = np.random.default_rng(seed)
    with StoreWriter(path, channels=channels, with_labels=True) as w:
        for i in range(n):
            w.add(rng.integers(0, 256, size=(size, size, channels), dtype=np.uint8), label=i % classes,
                  codec=CODEC_RAW)


def event_ms(torch, fn, n: int = 10) -> float:
    """Mean device time of ``fn`` over ``n`` back-to-back runs after
    three warm-up runs, from CUDA events."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def run_ssl_eval(torch, fa, workdir: str, card: str) -> None:
    """The reference's default configuration (CIFAR10: 32² RGB, low-res
    stem, 10 classes, train labels) through the trainer with the KNN probe
    each epoch on a bank larger than its chunk, then the linear probe CLI
    on its checkpoint; then the chunked KNN against the unchunked one at
    the trainer's default bank cap."""
    import torch.nn.functional as F

    from medical_image_segmentation_tpu_torch.eval import run_linear_probe
    from medical_image_segmentation_tpu_torch.eval.knn import knn_predict, knn_predict_chunked
    from medical_image_segmentation_tpu_torch.train import train_ssl

    t0 = time.time()
    for split, n in CIFAR_SPLITS.items():
        path = os.path.join(workdir, f"cifar10_{split}.mis")
        write_labelled_store(path, n, 32, 3, 10, seed=len(split))
        os.environ[f"CIFAR10_{split.upper()}_STORE"] = path
    setup_s = time.time() - t0
    steps = CIFAR_SPLITS["train"] // SSL_BATCH
    fa.fused_two_view_augment.launches = 0
    t0 = time.time()
    result = train_ssl.run(ssl_argv(workdir, "cifar", "CIFAR10", "--max_epochs", "1", "--val_every_epochs", "1",
                                    "--knn_every_epochs", "1", "--knn_bank_chunk", str(CIFAR_SPLITS["train"] // 4)))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = fa.fused_two_view_augment.launches
    check(result.used_kernel and launches >= steps, f"CIFAR10: {launches} kernel launches for {steps} steps")
    check(result.task.step == steps and result.knn_acc is not None and 0.0 <= result.knn_acc <= 1.0,
          f"CIFAR10: {result.task.step} steps, KNN accuracy {result.knn_acc}")
    check(result.val is not None and all(math.isfinite(v) for v in result.val.values()), f"val {result.val}")
    t0 = time.time()
    probe = run_linear_probe.run(["--checkpoint", os.path.join(workdir, "cifar", "ckpt"), "--dataset", "CIFAR10",
                                  *SSL_WIDTH, "--batch_size", str(SSL_BATCH), "--epochs", "2",
                                  "--device", SSL_DEVICE])
    probe_s = time.time() - t0
    check(0.0 <= probe.get("online_val_acc", -1.0) <= 1.0, f"linear probe {probe}")

    g = torch.Generator(device=SSL_DEVICE).manual_seed(7)
    bank = F.normalize(torch.randn(KNN_BANK, KNN_DIM, generator=g, device=SSL_DEVICE), dim=1)
    labels = torch.randint(0, 10, (KNN_BANK,), generator=g, device=SSL_DEVICE)
    queries = torch.randn(KNN_QUERIES, KNN_DIM, generator=g, device=SSL_DEVICE)
    full = knn_predict(queries, bank, labels, 10)
    chunked = knn_predict_chunked(queries, bank, labels, 10, chunk_size=KNN_CHUNK)
    argmax_equal = int((full.argmax(1) == chunked.argmax(1)).sum())
    rel = float(((full - chunked).abs() / full.abs().clamp_min(1e-30)).max())
    check(argmax_equal == KNN_QUERIES and rel <= 1e-4, f"chunked KNN: {argmax_equal}/{KNN_QUERIES} argmax, rel {rel}")
    ms = {"unchunked": event_ms(torch, lambda: knn_predict(queries, bank, labels, 10)),
          "chunked": event_ms(torch, lambda: knn_predict_chunked(queries, bank, labels, 10, chunk_size=KNN_CHUNK))}
    phase("ssl_eval", dataset="CIFAR10", steps=result.task.step, kernel_launches=launches,
          online_knn_val_acc=result.knn_acc, val_acc1=result.val["val/acc@1"],
          linear_probe_val_acc=probe["online_val_acc"], store_setup_s=round(setup_s, 2), train_wall_s=round(wall, 2),
          probe_wall_s=round(probe_s, 2), knn_bank=f"{KNN_BANK}x{KNN_DIM}", knn_queries=KNN_QUERIES,
          knn_chunk=KNN_CHUNK, knn_argmax_equal=f"{argmax_equal}/{KNN_QUERIES}", knn_scores_max_rel=rel,
          knn_ms_per_query_batch_unchunked=ms["unchunked"], knn_ms_per_query_batch_chunked=ms["chunked"],
          card=repr(card))


def run_profile(torch, fa, workdir: str, card: str) -> None:
    """``--profile 4``: the trace file names the augmentation kernel, and
    the loader's stage report is printed."""
    import contextlib
    import io

    from medical_image_segmentation_tpu_torch.train import train_ssl

    err = io.StringIO()
    fa.fused_two_view_augment.launches = 0
    t0 = time.time()
    with contextlib.redirect_stderr(err):
        result = train_ssl.run(ssl_argv(workdir, "profile", "RADIOLOGY_1M", "--profile", "4", "--max_epochs", "1",
                                        "--limit_steps_per_epoch", "6", "--checkpoint_every_epochs", "0"))
    torch.cuda.synchronize()
    wall = time.time() - t0
    sys.stderr.write(err.getvalue())
    launches = fa.fused_two_view_augment.launches
    check(result.trace and os.path.exists(result.trace), f"no trace file ({result.trace})")
    with open(result.trace) as f:
        trace = f.read()
    hits = trace.count("two_view_augment_kernel")
    check(hits > 0, "the trace does not name the two_view_augment kernel")
    check("loader stages (epoch 0):\ndecode:" in err.getvalue(), "no loader stage report")
    check(launches >= 6, f"kernel launched {launches} times for 6 steps")
    phase("profile", traced_steps=4, kernel_launches=launches, trace_bytes=len(trace), kernel_events=hits,
          loader_report=True, wall_s=round(wall, 2), card=repr(card))


def _peak_step(torch, make_task, batch):
    """Loss, BatchNorm running statistics and peak device memory of a fresh
    task's first step."""
    task = make_task()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    m = task.train_step(*batch)
    loss = float(m["loss"] if "loss" in m else m["train/loss"])
    peak = torch.cuda.max_memory_allocated()
    model = getattr(task, "online", None) or task.model
    stats = {k: v.detach().cpu().clone() for k, v in model.state_dict().items() if "running" in k}
    del task, m
    torch.cuda.empty_cache()
    return loss, stats, peak


def run_remat(torch, fa, card: str) -> None:
    """One BYOL step (batch 256) and one U-Net step (batch 64, 224²), each
    with and without remat from the same weights and batch: the same
    forward (loss and BatchNorm statistics), a lower peak with remat."""
    import numpy as np

    from medical_image_segmentation_tpu_torch.data.datamodules import get_datamodule
    from medical_image_segmentation_tpu_torch.ops.augment import segmentation_augment
    from medical_image_segmentation_tpu_torch.train.byol_task import BYOLTask
    from medical_image_segmentation_tpu_torch.train.segmentation_task import SegmentationTask

    rad = get_datamodule("RADIOLOGY_1M")()
    cfg1, cfg2 = rad.view_configs()
    gen = torch.Generator(device=SSL_DEVICE).manual_seed(11)
    imgs = torch.randint(0, 256, (SSL_BATCH, 256, 256, 1), generator=gen, device=SSL_DEVICE, dtype=torch.uint8)
    views = fa.fused_two_view_augment(imgs, cfg1, cfg2, rad.train_mean, rad.train_std, torch.bfloat16, generator=gen)
    liver = get_datamodule(SEG_DATASET)()
    x, m = (np.stack(a)[..., None] for a in zip(*disk_slices(np.random.default_rng(6), SEG_BATCH, SEG_SIZE)))
    seg_batch = segmentation_augment(gen, torch.from_numpy(x).to(SEG_DEVICE),
                                     torch.from_numpy(m.astype(np.float32)).to(SEG_DEVICE),
                                     (SEG_SIZE, SEG_SIZE), liver.mean, liver.std, train=True)

    def byol(remat):
        def make():
            task = BYOLTask(arch="resnet18", in_channels=1, hidden_dim=4096, proj_dim=256, warmup_epochs=0,
                            device=SSL_DEVICE, remat=remat)
            task.init(0)
            return task
        return make

    def seg(remat):
        def make():
            task = SegmentationTask(device=SEG_DEVICE, warmup_epochs=0, remat=remat)
            task.init(0)
            return task
        return make

    fields = {}
    for name, make, batch in (("byol", byol, views), ("unet", seg, seg_batch)):
        plain, remat = _peak_step(torch, make(False), batch), _peak_step(torch, make(True), batch)
        loss_rel = abs(plain[0] - remat[0]) / abs(plain[0])
        bn_rel = max(float((remat[1][k] - plain[1][k]).abs().max()) / max(float(plain[1][k].abs().max()), 1e-30)
                     for k in plain[1])
        check(loss_rel <= 1e-6 and bn_rel <= 1e-6, f"{name}: remat changed the forward: loss {loss_rel}, BN {bn_rel}")
        check(remat[2] < plain[2], f"{name}: remat peak {remat[2]} not under the plain peak {plain[2]}")
        fields.update({f"{name}_loss_rel": loss_rel, f"{name}_bn_rel": bn_rel,
                       f"{name}_peak_gib_plain": plain[2] / 2**30, f"{name}_peak_gib_remat": remat[2] / 2**30})
    phase("remat", byol_batch=SSL_BATCH, unet_batch=SEG_BATCH, unet_size=SEG_SIZE, **fields, card=repr(card))


def run_hbm(torch, fa, card: str) -> None:
    """The memory guard on the BYOL and U-Net configurations: its report,
    and the state bit-equal across its probe step."""
    from medical_image_segmentation_tpu_torch.core import hbm
    from medical_image_segmentation_tpu_torch.data.datamodules import get_datamodule
    from medical_image_segmentation_tpu_torch.ops.augment import segmentation_augment
    from medical_image_segmentation_tpu_torch.train.byol_task import BYOLTask
    from medical_image_segmentation_tpu_torch.train.segmentation_task import SegmentationTask

    rad, liver = get_datamodule("RADIOLOGY_1M")(), get_datamodule(SEG_DATASET)()
    cfg1, cfg2 = rad.view_configs()
    fields = {}
    for name in ("byol", "seg"):
        gen = torch.Generator(device=SSL_DEVICE).manual_seed(13)
        if name == "byol":
            task = BYOLTask(arch="resnet18", in_channels=1, hidden_dim=4096, proj_dim=256, device=SSL_DEVICE)
            imgs = torch.zeros(SSL_BATCH, 256, 256, 1, dtype=torch.uint8, device=SSL_DEVICE)

            def step():
                task.train_step(*fa.fused_two_view_augment(imgs, cfg1, cfg2, rad.train_mean, rad.train_std,
                                                           torch.bfloat16, generator=gen))
        else:
            task = SegmentationTask(device=SEG_DEVICE)
            imgs = torch.zeros(SEG_BATCH, SEG_SIZE, SEG_SIZE, 1, dtype=torch.uint8, device=SEG_DEVICE)

            def step():
                task.train_step(*segmentation_augment(gen, imgs, imgs.float(), (SEG_SIZE, SEG_SIZE), liver.mean,
                                                      liver.std, train=True))
        task.init(0)
        before, gen_before = cpu_tree(task.state_dict()), gen.get_state()

        def probe():
            with hbm.preserved(task, gen):
                step()

        mem = hbm.guard_step(probe, label=f"{name} train step", device=SSL_DEVICE)
        equal = trees_equal(cpu_tree(task.state_dict()), before) and torch.equal(gen.get_state(), gen_before)
        check(mem is not None and not mem["oversubscribed"], f"{name}: guard report {mem}")
        check(equal, f"{name}: the probe step changed the task's state")
        fields.update({f"{name}_peak_gib": mem["projected_peak"] / 2**30, f"{name}_state_bit_equal": equal})
        capacity = mem["capacity"]
        del task
        torch.cuda.empty_cache()
    phase("hbm", byol_batch=SSL_BATCH, seg_batch=SEG_BATCH, **fields, capacity_gib=capacity / 2**30,
          card=repr(card))


# The volumetric phases run the 3D trainers' defaults at full width
# (``train/train_segmentation3d.py``: UNet3D (32, 64, 128, 256), GroupNorm,
# bf16, volume 64×96×96, crop 32×64×64, batch 4; ``train/train_ssl3d.py``:
# hidden 4096, projection 256) on synthetic NIfTI volumes.
INGEST_DICOMS = 64                 # distinct 300×300 uint16 DICOMs, plus INGEST_DUPLICATES copies of some
INGEST_DUPLICATES = 8
INGEST_DICOM_SIZE = 300
INGEST_VOLUMES = 4                 # Decathlon NIfTI pairs of INGEST_VOLUME (X, Y, Z)
INGEST_VOLUME = (256, 256, 12)
INGEST_VAL_PNGS = 8
INGEST_PROCS = 2
INGEST_IMAGE_SIZE = 224
PARITY_DEVICE = "cuda"
# the canonical width (resnet18, the trainers' default heads, bf16), depth cut by flags
PARITY_FLAGS = ["--subset_size", "64", "--image_size", "224", "--ssl_epochs", "1", "--ssl_batch_size", "64",
                "--seg_epochs", "1", "--seg_batch_size", "16", "--fractions", "100", "--arch", "resnet18"]


class blocked_image_libraries:
    """Within the block, ``import cv2`` and ``import PIL`` fail, so the port
    takes its numpy routes: where the libraries do not import nothing changes;
    where they are installed, ``sys.modules`` holds None for them and a
    directory at the front of ``sys.path`` holds modules that raise on
    import, which the ingest CLIs' spawned workers inherit with the path.
    ``state`` says which for each: ``absent`` (it does not import) or
    ``blocked`` (it imports outside the block)."""

    def __init__(self, workdir: str):
        import importlib

        self.shim = os.path.join(workdir, "blocked_modules")
        self.names = ("cv2", "PIL")
        self.state = {}
        for n in self.names:
            try:
                importlib.import_module(n)
                self.state[n] = "blocked"
            except ImportError:
                self.state[n] = "absent"

    def __enter__(self):
        self.saved = {n: sys.modules.get(n, "unset") for n in self.names}
        if "blocked" in self.state.values():
            os.makedirs(os.path.join(self.shim, "PIL"), exist_ok=True)
            for path in ("cv2.py", os.path.join("PIL", "__init__.py")):
                with open(os.path.join(self.shim, path), "w") as f:
                    f.write("raise ImportError('blocked: the port takes its numpy image routes here')\n")
            sys.path.insert(0, self.shim)
        for n in self.names:
            sys.modules[n] = None
        return self

    def __exit__(self, *exc):
        if self.shim in sys.path:
            sys.path.remove(self.shim)
        for n, mod in self.saved.items():
            if mod == "unset":
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = mod
        return False


def write_ingest_data(root: str) -> dict:
    """Synthetic raw inputs of the curation path, from a seed, written with
    the port's own writers: TCIA-style DICOM trees (INGEST_DICOMS distinct
    images and INGEST_DUPLICATES pixel copies), Decathlon NIfTI pairs with a
    mask blob, and a val tree of 16-bit PNGs."""
    import numpy as np

    from medical_image_segmentation_tpu_torch.data.dicom import write_dicom
    from medical_image_segmentation_tpu_torch.data.nifti import write_nifti
    from medical_image_segmentation_tpu_torch.utils.png import write_png

    rng = np.random.default_rng(0)
    n = INGEST_DICOM_SIZE
    y, x = np.mgrid[:n, :n]
    dicoms = os.path.join(root, "med_datasets")
    for i in range(INGEST_DICOMS):
        ds = os.path.join(dicoms, ("pancreasct", "ctcolongraphy", "hcctaceseg")[i % 3])
        os.makedirs(ds, exist_ok=True)
        body = 1500 * np.exp(-(((x - n / 2 - 20 * np.sin(i)) / (60 + i)) ** 2 + ((y - n / 2) / 90) ** 2))
        arr = (body + rng.integers(0, 400, size=(n, n))).astype(np.uint16)
        write_dicom(os.path.join(ds, f"img{i:03d}.dcm"), arr)
        if i < INGEST_DUPLICATES:
            write_dicom(os.path.join(ds, f"copy{i:03d}.dcm"), arr)
    task = os.path.join(root, "Task03_Liver")
    for sub in ("imagesTr", "labelsTr"):
        os.makedirs(os.path.join(task, sub), exist_ok=True)
    X, Y, Z = INGEST_VOLUME
    gx, gy, gz = np.mgrid[:X, :Y, :Z]
    for v in range(INGEST_VOLUMES):
        blob = ((gx - X / 2 - 10 * v) / (X / 5)) ** 2 + ((gy - Y / 2) / (Y / 6)) ** 2 + ((gz - Z / 2) / (Z / 2.5)) ** 2 < 1
        vol = rng.normal(0, 30, size=INGEST_VOLUME) - 100 + 180 * blob
        write_nifti(os.path.join(task, "imagesTr", f"liver_{v}.nii.gz"), vol.astype(np.float32))
        write_nifti(os.path.join(task, "labelsTr", f"liver_{v}.nii.gz"), blob.astype(np.uint8))
    val = os.path.join(root, "nih_test_pngs")
    os.makedirs(val, exist_ok=True)
    for i in range(INGEST_VAL_PNGS):
        write_png(os.path.join(val, f"val{i}.png"), rng.integers(0, 65536, size=(256, 256)).astype(np.uint16))
    return dict(dicoms=dicoms, images=os.path.join(task, "imagesTr"), labels=os.path.join(task, "labelsTr"),
                val=val)


def codec_ms(store: str, png_dir: str) -> dict:
    """Host milliseconds an image of the numpy routes on this machine: JPEG
    encode and decode of the store's 224² images, INTER_AREA of the curated
    16-bit PNGs to 224."""
    import glob

    from medical_image_segmentation_tpu_torch.data.store import StoreReader
    from medical_image_segmentation_tpu_torch.utils.imageio import read_image
    from medical_image_segmentation_tpu_torch.utils.jpeg import decode_jpeg_numpy, encode_jpeg_numpy
    from medical_image_segmentation_tpu_torch.utils.resize import resize_numpy

    reader = StoreReader(store)
    payloads = [reader.payload(i) for i in range(8)]
    images = [reader.image(i)[..., 0] for i in range(8)]
    reader.close()
    pngs = [read_image(p) for p in sorted(glob.glob(os.path.join(png_dir, "*", "*.png")))[:8]]
    out = {}
    for name, fn, items in (("jpeg_decode", decode_jpeg_numpy, payloads),
                            ("jpeg_encode", lambda im: encode_jpeg_numpy(im, 90), images),
                            ("inter_area", lambda im: resize_numpy(
                                im, (INGEST_IMAGE_SIZE, INGEST_IMAGE_SIZE), "area"), pngs)):
        t0 = time.perf_counter()
        for item in items:
            fn(item)
        out[f"{name}_ms_per_image"] = 1000.0 * (time.perf_counter() - t0) / len(items)
    return out


def native_codec_routes() -> dict:
    """The port's native library must be loaded: JPEG-LS and DICOM JPEG
    Lossless then decode through it. A 128² 16-bit slice through each
    codec's native and Python routes: equal, and ms of each."""
    import numpy as np

    from medical_image_segmentation_tpu_torch.data import dicom_codecs, jpegls
    from medical_image_segmentation_tpu_torch.data.store import native

    check(native.get_lib() is not None, "the port's native library is not loaded")
    img = (1000 + np.random.default_rng(31).integers(0, 3000, (128, 128))).astype(np.uint16)
    out = {"native_lib": os.path.basename(native.build_info()["path"])}
    for name, data, fast, slow in (
            ("jpegls", jpegls.jpeg_ls_encode(img, precision=16), jpegls.jpeg_ls_decode, jpegls.jpeg_ls_decode_py),
            ("jpeg_lossless", dicom_codecs.jpeg_lossless_encode(img, precision=16),
             dicom_codecs.jpeg_lossless_decode, dicom_codecs.jpeg_lossless_decode_py)):
        ms = {}
        for route, fn in (("native", fast), ("python", slow)):
            t0 = time.perf_counter()
            got = fn(data)
            ms[route] = 1000.0 * (time.perf_counter() - t0)
            check(np.array_equal(np.asarray(got).reshape(img.shape), img), f"{name} {route} decode is not lossless")
        out[f"{name}_route"] = "native"
        out[f"{name}_native_ms"] = round(ms["native"], 3)
        out[f"{name}_python_ms"] = round(ms["python"], 1)
    return out


def run_ingest(torch, fa, workdir: str, card: str) -> dict:
    """The curation CLIs on synthetic raw data, cv2 and PIL absent or
    blocked, with worker pools of INGEST_PROCS: scans and the curated
    subset, a JPEG store at 224, its statistics, Decathlon slices, splits
    and paired seg stores. No kernel lies on this path."""
    import json as _json

    import numpy as np

    from medical_image_segmentation_tpu_torch.data.ingest import (
        compute_stats, create_seg_store, create_splits, create_store, create_subset, slice_decathlon)
    from medical_image_segmentation_tpu_torch.data.store import StoreReader

    t0 = time.time()
    raw = write_ingest_data(os.path.join(workdir, "raw"))
    write_s = time.time() - t0
    out = os.path.join(workdir, "ingest")
    os.makedirs(out, exist_ok=True)
    procs = str(INGEST_PROCS)
    seconds = {}

    def stage(name, fn, argv):
        t0 = time.time()
        check(fn(argv) == 0, f"ingest stage {name} failed")
        seconds[name] = round(time.time() - t0, 2)

    fa.fused_two_view_augment.launches = 0
    with blocked_image_libraries(workdir) as libs:
        for cmd in ("dicom_sizes", "dicom_hashes"):
            stage(cmd, create_subset.main, [cmd, raw["dicoms"], "--output", os.path.join(out, f"{cmd}.json"),
                                            "--num_processes", procs])
        stage("write_subset", create_subset.main, [
            "write_subset", "--dimensions_map", os.path.join(out, "dicom_sizes.json"),
            "--hashes_map", os.path.join(out, "dicom_hashes.json"), "--output_dir", os.path.join(out, "subset"),
            "--size", str(INGEST_DICOMS), "--num_processes", procs,
            "--mapping_output", os.path.join(out, "subset_map.json")])
        store = os.path.join(out, "radiology_train.mis")
        stage("create_store", create_store.main, ["--png_dir", os.path.join(out, "subset"), "--output", store,
                                                  "--max_resolution", str(INGEST_IMAGE_SIZE), "--num_workers", procs])
        stats_json = os.path.join(out, "stats.json")
        stage("compute_stats", compute_stats.main, ["--store", store, "--center_crop", str(INGEST_IMAGE_SIZE),
                                                    "--output", stats_json])
        slices = os.path.join(out, "slices")
        stage("slice_decathlon", slice_decathlon.main, [
            "--images_dir", raw["images"], "--labels_dir", raw["labels"], "--images_out",
            os.path.join(slices, "images"), "--masks_out", os.path.join(slices, "masks"), "--num_processes", procs])
        stage("create_splits", create_splits.main, ["--images_dir", os.path.join(slices, "images"),
                                                    "--output_dir", os.path.join(out, "splits")])
        stage("create_seg_store", create_seg_store.main, [
            "--images_dir", os.path.join(slices, "images"), "--masks_dir", os.path.join(slices, "masks"),
            "--output_prefix", os.path.join(out, "seg", "liver"),
            "--split_file", os.path.join(out, "splits", "split_100_percent_train.json"),
            "--image_size", str(INGEST_IMAGE_SIZE)])
        for n in libs.names:
            try:
                __import__(n)
                check(False, f"{n} imported inside the ingest phase")
            except ImportError:
                pass
        timing = codec_ms(store, os.path.join(out, "subset"))
        routes = native_codec_routes()
    launches = fa.fused_two_view_augment.launches
    check(launches == 0, f"the ingest path launched two_view_augment {launches} times")

    with open(os.path.join(out, "dicom_hashes.json")) as f:
        hashes = _json.load(f)
    with open(os.path.join(out, "subset_map.json")) as f:
        curated = _json.load(f)
    check(len(hashes) == INGEST_DICOMS + INGEST_DUPLICATES, f"{len(hashes)} DICOMs hashed")
    check(len(set(hashes.values())) == INGEST_DICOMS and len(curated) == INGEST_DICOMS,
          f"dedup kept {len(curated)} of {len(set(hashes.values()))} distinct images")
    reader = StoreReader(store)
    imgs = [reader.image(i) for i in range(len(reader))]
    reader.close()
    check(len(imgs) == INGEST_DICOMS and all(im.shape == (INGEST_IMAGE_SIZE, INGEST_IMAGE_SIZE, 1) for im in imgs),
          "store images of the wrong count or shape")
    with open(stats_json) as f:
        stats = _json.load(f)
    check(all(math.isfinite(v) for v in stats["mean"] + stats["std"]) and 0 < stats["mean"][0] < 255,
          f"bad store statistics {stats}")
    n_slices = len(os.listdir(os.path.join(slices, "images")))
    check(n_slices == INGEST_VOLUMES * INGEST_VOLUME[2], f"{n_slices} slices")
    with open(os.path.join(out, "seg", "liver_manifest.json")) as f:
        seg_counts = _json.load(f)["counts"]
    check(sum(seg_counts.values()) == n_slices, f"seg stores hold {seg_counts}")
    masks = StoreReader(os.path.join(out, "seg", f"liver_{next(iter(seg_counts))}_masks.mis"))
    check(set(np.unique(masks.image(INGEST_VOLUME[2] // 2))) <= {0, 1}, "seg masks are not 0/1")
    masks.close()
    phase("ingest", opencv=libs.state["cv2"], pil=libs.state["PIL"], procs=INGEST_PROCS, start_method="spawn",
          write_inputs_s=round(write_s, 2), **{f"{k}_s": v for k, v in seconds.items()},
          dicoms=len(hashes), curated=len(curated), store_images=len(imgs), stats=stats, slices=n_slices,
          seg_counts=seg_counts, kernel_launches=launches,
          **{k: round(v, 3) for k, v in timing.items()}, **routes, card=repr(card))
    return raw


def run_parity_harness(torch, fa, workdir: str, raw: dict, card: str) -> tuple:
    """``mis-parity-torch`` at the canonical width on the ingest phase's raw
    data, cv2 and PIL absent or blocked: every stage, a report with both
    inits' test Dice in [0, 1], then a second call that re-runs nothing.
    Then the kernel against its plain version at the pretrain's shape (a
    batch of the harness's own 224² store). Returns the kernel's launches in
    the harness and the pretrain-shape record."""
    import json as _json

    from medical_image_segmentation_tpu_torch.data import datamodules as dm_mod
    from medical_image_segmentation_tpu_torch.data.store import StoreReader
    from medical_image_segmentation_tpu_torch.eval import parity

    ws = os.path.join(workdir, "parity")
    argv = ["--workdir", ws, "--dicom_dirs", raw["dicoms"], "--decathlon_images", raw["images"],
            "--decathlon_labels", raw["labels"], "--val_png_dir", raw["val"], "--num_workers", "8",
            "--num_processes", str(INGEST_PROCS), "--device", PARITY_DEVICE, *PARITY_FLAGS]
    with blocked_image_libraries(workdir) as libs:
        fa.fused_two_view_augment.launches = 0
        t0 = time.time()
        check(parity.main(argv) == 0, "mis-parity-torch failed")
        wall = time.time() - t0
        launches = fa.fused_two_view_augment.launches
        with open(os.path.join(ws, "parity_report.json")) as f:
            report = _json.load(f)
        t0 = time.time()
        check(parity.main(argv) == 0, "mis-parity-torch failed on its second call")
        again_s = time.time() - t0
        with open(os.path.join(ws, "parity_report.json")) as f:
            report2 = _json.load(f)
    routes = native_codec_routes()
    check(launches >= 1, f"two_view_augment launched {launches} times in the pretrain stage")
    check(fa.fused_two_view_augment.launches == launches, "the second call launched the kernel")
    check(report2["stage_seconds"] == {} and report2["finetune"] == report["finetune"],
          f"the second call re-ran {sorted(report2['stage_seconds'])}")
    dice = {r["init"]: r.get("test/dice") for r in report["finetune"]}
    check(set(dice) == {"scratch", "ssl"} and all(d is not None and 0.0 <= d <= 1.0 for d in dice.values()),
          f"test Dice {dice}")
    stages = report["stage_seconds"]
    check(set(stages) >= {"scan", "curate", "store", "stats", "val_store", "val_stats", "pretrain", "slice",
                          "splits", "seg_scratch_100pct", "seg_ssl_100pct"}, f"stages run {sorted(stages)}")
    ds = report["dataset_stats"]

    # the kernel at the pretrain's shape: a batch of the harness's own store
    import numpy as np

    reader = StoreReader(os.path.join(ws, "radiology_train.mis"))
    batch = np.stack([reader.image(i) for i in range(min(64, len(reader)))])
    reader.close()
    record = {}
    if PARITY_DEVICE == "cuda":
        rad = dm_mod.get_datamodule("RADIOLOGY_1M")()
        c1, c2 = rad.view_configs()
        imgs = torch.from_numpy(batch).cuda()
        b, h, w = imgs.shape[:3]
        params = fa.sample_view_params(torch.Generator(device="cuda").manual_seed(3), b, h, w, c1, c2)
        mean, std = tuple(rad.train_mean), tuple(rad.train_std)
        got = fa.fused_two_view_augment(imgs, c1, c2, mean, std, torch.bfloat16, params=params)
        want = fa.two_view_augment_reference(params, imgs, c1.out_size, mean, std, c1.value_max,
                                             dtype=torch.bfloat16)
        ulp = max(bf16_ulps(g, r) for g, r in zip(got, want))
        check(ulp <= 1, f"pretrain shape: kernel and plain version differ by {ulp} bf16 ulp")
        kernel_ms = cold_ms(lambda: fa.fused_two_view_augment(imgs, c1, c2, mean, std, torch.bfloat16,
                                                             params=params), 20)
        plain_ms = cold_ms(lambda: fa.two_view_augment_reference(params, imgs, c1.out_size, mean, std,
                                                                c1.value_max, dtype=torch.bfloat16), 5)
        bounds = kernel_bounds(torch, fa, params, imgs, c1.out_size, torch.bfloat16)
        record = dict(pretrain_shape=tuple(imgs.shape), pretrain_max_bf16_ulp=ulp,
                      pretrain_max_abs_err=max(float((g.float() - r.float()).abs().max()) for g, r in zip(got, want)),
                      pretrain_kernel_ms=kernel_ms, pretrain_plain_ms=plain_ms,
                      pretrain_bound_ms=bounds["bound_us"] / 1000.0)
        fa.fused_two_view_augment.launches = launches  # the comparison's launches do not count
    phase("parity", opencv=libs.state["cv2"], pil=libs.state["PIL"], device=PARITY_DEVICE, wall_s=round(wall, 2),
          second_call_s=round(again_s, 2), stage_seconds=stages, measured_mean=ds["measured_mean"],
          measured_std=ds["measured_std"], val_mean=ds.get("val_measured_mean"), val_std=ds.get("val_measured_std"),
          ssl_loss=report["ssl"].get("loss"), dice=dice, kernel_launches=launches, **record,
          native_lib=routes["native_lib"], jpegls_route=routes["jpegls_route"], card=repr(card))
    return launches, record


VOL_DEVICE = "cuda"
VOL_FEATURES = (32, 64, 128, 256)
VOL_SIZE, VOL_CROP, VOL_BATCH = (64, 96, 96), (32, 64, 64), 4
VOL_DISK, VOL_RAGGED = (96, 96, 64), 8                  # (X, Y, Z) on disk, ± this much on each axis
VOL_SPLITS = {"train": 24, "val": 4, "test": 4}
VOL_EPOCHS, VOL_STEPS, VOL_RESUME_STOP = 2, 6, 8
VOL_HIDDEN, VOL_PROJ = 4096, 256
VOL_PREDICT = [(160, 160, 80), (160, 160, 80), (160, 152, 80), (160, 160, 80)]   # (X, Y, Z) of the volumes to serve
VOL_PREDICT_WINDOWS = 64                                # windows of VOL_CROP each of them takes
VOL_SAME_SHAPE = 32                                     # volumes of one shape (resampled scans) served in turns
VOL_STEP_BATCHES = (4, 32)
VOL_PARITY = dict(features=(8, 16, 32), crop=(16, 32, 32), batch=2)


def sphere_volume(rng, shape):
    """(int16 CT-like volume, 0/1 uint8 mask) of ``shape``: a bright ball of
    random centre and radius on noise."""
    import numpy as np

    axes = np.ogrid[tuple(slice(n) for n in shape)]
    centre = [rng.integers(n // 3, 2 * n // 3 + 1) for n in shape]
    r = rng.integers(min(shape) // 6, min(shape) // 3)
    mask = sum((a - c) ** 2 for a, c in zip(axes, centre)) <= r * r
    img = rng.normal(-150.0, 80.0, shape).astype(np.float32) + 450.0 * mask
    return img.astype(np.int16), mask.astype(np.uint8)


def write_volumes(workdir: str):
    """The Decathlon-style directory (imagesTr, labelsTr, split.json) and
    the directory of larger volumes to serve; returns both and the names."""
    import numpy as np

    from medical_image_segmentation_tpu_torch.data.nifti import write_nifti

    rng = np.random.default_rng(0)
    root = os.path.join(workdir, "task3d")
    for sub in ("imagesTr", "labelsTr", "serve"):
        os.makedirs(os.path.join(root, sub))
    names = [f"vol_{i:03d}" for i in range(sum(VOL_SPLITS.values()))]
    for name in names:
        shape = tuple(int(n + rng.integers(-VOL_RAGGED, VOL_RAGGED + 1)) for n in VOL_DISK)
        img, mask = sphere_volume(rng, shape)
        write_nifti(os.path.join(root, "imagesTr", f"{name}.nii.gz"), img)
        write_nifti(os.path.join(root, "labelsTr", f"{name}.nii.gz"), mask)
    split, start = {}, 0
    for k, n in VOL_SPLITS.items():
        split[k] = names[start:start + n]
        start += n
    with open(os.path.join(root, "split.json"), "w") as f:
        json.dump(split, f)
    for i, shape in enumerate(VOL_PREDICT):
        write_nifti(os.path.join(root, "serve", f"scan_{i}.nii.gz"), sphere_volume(rng, shape)[0])
    return root


def spheres_batch(torch, rng, batch: int, dims):
    """A (B, D, H, W, 1) f32 volume batch in 0..1 and its masks, on the card."""
    import numpy as np

    pairs = [sphere_volume(rng, dims) for _ in range(batch)]
    vols = np.stack([(v - v.min()) / float(v.max() - v.min()) for v, _ in pairs]).astype(np.float32)[..., None]
    masks = np.stack([m for _, m in pairs]).astype(np.float32)[..., None]
    return torch.from_numpy(vols).to(VOL_DEVICE), torch.from_numpy(masks).to(VOL_DEVICE)


def run_vol_parity(torch, device: str = "cuda"):
    """3D U-Net segmentation at a small width (GroupNorm, Dice)."""
    import numpy as np

    from medical_image_segmentation_tpu_torch.train.seg3d_task import Segmentation3DTask

    kw = dict(features=VOL_PARITY["features"], learning_rate=0.5, warmup_epochs=0, max_epochs=2, min_lr=0.01,
              steps_per_epoch=1, dtype=torch.float32)
    rng = np.random.default_rng(8)
    batches = []
    for _ in range(2):
        pairs = [sphere_volume(rng, VOL_PARITY["crop"]) for _ in range(VOL_PARITY["batch"])]
        x = (np.stack([v for v, _ in pairs])[..., None].astype(np.float32) + 100.0) / 250.0
        batches.append((torch.from_numpy(x), torch.from_numpy(np.stack([m for _, m in pairs])[..., None].astype(np.float32))))

    def train(dev, scale):
        task = Segmentation3DTask(device=dev, **kw)
        task.init(0)
        losses = [float(task.train_step((x * scale).to(dev), m.to(dev))["train/loss"]) for x, m in batches]
        names = {k for k, _ in task.model.named_parameters()}
        return losses, {k: v.detach().cpu() for k, v in task.model.state_dict().items()}, names

    step_parity("vol_parity", train, device)


def vol_argv(root: str, workdir: str, name: str, *extra) -> list:
    """The 3D segmentation trainer's argv at full width, logs and
    checkpoints under ``<workdir>/<name>``."""
    return ["--device", VOL_DEVICE, "--images_dir", os.path.join(root, "imagesTr"),
            "--masks_dir", os.path.join(root, "labelsTr"), "--split_file", os.path.join(root, "split.json"),
            "--volume_size", *map(str, VOL_SIZE), "--crop_size", *map(str, VOL_CROP),
            "--features", *map(str, VOL_FEATURES), "--batch_size", str(VOL_BATCH), "--warmup_epochs", "0",
            "--seed", "0", "--log_dir", os.path.join(workdir, name, "logs"),
            "--checkpoint_dir", os.path.join(workdir, name, "ckpt"), *extra]


def steady_ms(result) -> float:
    """Trainer ms per step over the epochs after the first."""
    steady = result.epochs[1:]
    return 1000.0 * sum(e["seconds"] for e in steady) / sum(e["steps"] for e in steady)


def run_ssl3d_train(torch, root: str, workdir: str, card: str) -> str:
    """The volumetric BYOL trainer at full width with the corpus on the
    card; returns the final checkpoint's path."""
    from medical_image_segmentation_tpu_torch.train import train_ssl3d
    from medical_image_segmentation_tpu_torch.train.byol_task import BYOLTask

    n_steps = VOL_EPOCHS * VOL_STEPS
    argv = ["--device", VOL_DEVICE, "--images_dir", os.path.join(root, "imagesTr"),
            "--volume_size", *map(str, VOL_SIZE), "--crop_size", *map(str, VOL_CROP),
            "--features", *map(str, VOL_FEATURES), "--hidden_dim", str(VOL_HIDDEN), "--projection_dim", str(VOL_PROJ),
            "--batch_size", str(VOL_BATCH),
            "--max_epochs", str(VOL_EPOCHS), "--limit_steps_per_epoch", str(VOL_STEPS), "--warmup_epochs", "0",
            "--checkpoint_every_epochs", "0", "--device_cache", "--seed", "0",
            "--log_dir", os.path.join(workdir, "ssl3d", "logs"), "--checkpoint_dir", os.path.join(workdir, "ssl3d", "ckpt")]
    t0 = time.time()
    result = train_ssl3d.run(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    task = result.task
    check(task.step == n_steps and not result.stopped, f"ssl3d trainer ran {task.step} steps, expected {n_steps}")
    losses = [float(x) for x in result.losses]
    check(len(losses) == n_steps and all(math.isfinite(x) and 0.0 <= x <= 4.0 for x in losses), f"bad losses {losses}")
    init = BYOLTask(volumetric=True, features3d=VOL_FEATURES, in_channels=1, hidden_dim=VOL_HIDDEN,
                    proj_dim=VOL_PROJ, num_classes=2, device="cpu")
    init.init(0)
    init_sd = init.online.state_dict()
    params = dict(task.online.named_parameters())
    still = [k for k, p in params.items() if torch.equal(p.detach().cpu(), init_sd[k])]
    backbone = [k for k in params if k.startswith("encoder.backbone.")]
    # without a probe loss the probe gets no gradient: its bias (rank 1, not decayed) stays
    check(backbone and set(still) <= {"probe.bias"}, f"parameters that did not move: {still}")
    n_vols = sum(VOL_SPLITS.values())
    check(result.corpus_bytes == n_vols * VOL_SIZE[0] * VOL_SIZE[1] * VOL_SIZE[2] * 4,
          f"corpus on the card: {result.corpus_bytes} bytes")
    check(result.hbm is not None and not result.hbm["oversubscribed"], f"ssl3d guard report {result.hbm}")
    check(os.path.exists(result.checkpoint) and result.checkpoint.endswith(f"{n_steps}.pt"),
          f"no final volumetric BYOL checkpoint ({result.checkpoint})")
    phase("ssl3d_train", steps=task.step, losses=[round(x, 4) for x in losses],
          backbone_params_moved=f"{len(set(backbone) - set(still))}/{len(backbone)}",
          params_moved=f"{len(params) - len(still)}/{len(params)}", corpus_mib=result.corpus_bytes / 2**20,
          guard_peak_gib=result.hbm["projected_peak"] / 2**30, wall_s=round(wall, 2),
          first_epoch_ms_per_step=1000.0 * result.epochs[0]["seconds"] / result.epochs[0]["steps"],
          steady_ms_per_step=steady_ms(result), steady_vol_per_s=VOL_BATCH * 1000.0 / steady_ms(result),
          card=repr(card))
    return result.checkpoint


def run_seg3d_train(torch, root: str, workdir: str, ssl_ckpt: str, card: str) -> str:
    """The 3D segmentation trainer at full width, its encoder grafted from
    the volumetric BYOL checkpoint; then one epoch from the corpus on the
    card against the plain route's first epoch. Returns the checkpoint."""
    from medical_image_segmentation_tpu_torch.train import train_segmentation3d

    n_steps = VOL_EPOCHS * VOL_STEPS
    common = ["--limit_steps_per_epoch", str(VOL_STEPS), "--ssl_checkpoint", ssl_ckpt]
    t0 = time.time()
    result = train_segmentation3d.run(vol_argv(root, workdir, "seg3d", *common, "--max_epochs", str(VOL_EPOCHS),
                                               "--full_res_window", *map(str, VOL_CROP)))
    torch.cuda.synchronize()
    wall = time.time() - t0

    online = torch.load(ssl_ckpt, map_location="cpu", weights_only=True)["online"]
    enc = [k for k in result.start_state if k.startswith(("enc", "down"))]
    grafted = [k for k in enc if torch.equal(result.start_state[k], online["encoder.backbone." + k])]
    check(enc and len(grafted) == len(enc), f"encoder after the graft: {len(grafted)}/{len(enc)} equal to BYOL online")
    task = result.task
    check(task.step == n_steps and not result.stopped, f"seg3d trainer ran {task.step} steps, expected {n_steps}")
    losses = [float(x) for x in result.losses]
    check(len(losses) == n_steps and all(math.isfinite(x) and 0.0 <= x <= 1.0 for x in losses), f"bad losses {losses}")
    params = dict(task.model.named_parameters())
    still = [k for k, p in params.items() if torch.equal(p.detach().cpu(), result.start_state[k])]
    check(not still, f"parameters that did not move: {still}")
    metrics = {**result.val, **result.test, **result.full_res}
    check(len(metrics) == 8 and all(0.0 <= v <= 1.0 for v in metrics.values()), f"bad val/test metrics {metrics}")
    check(os.path.exists(result.checkpoint) and result.checkpoint.endswith(f"{n_steps}.pt"),
          f"no final checkpoint ({result.checkpoint})")
    check(result.hbm is not None and not result.hbm["oversubscribed"] and result.corpus_bytes == 0,
          f"seg3d guard report {result.hbm}")

    t0 = time.time()
    cached = train_segmentation3d.run(vol_argv(root, workdir, "seg3d_cache", *common, "--max_epochs", "1",
                                               "--device_cache", "--checkpoint_every_epochs", "0"))
    torch.cuda.synchronize()
    cache_wall = time.time() - t0
    cached_losses = [float(x) for x in cached.losses]
    n_vols = sum(VOL_SPLITS.values())
    check(cached.corpus_bytes == n_vols * VOL_SIZE[0] * VOL_SIZE[1] * VOL_SIZE[2] * 5,
          f"corpora on the card: {cached.corpus_bytes} bytes")
    check(len(cached_losses) == VOL_STEPS and cached_losses[0] == losses[0],
          f"--device_cache: first loss {cached_losses[0]} against the plain route's {losses[0]}")
    cache_rel = max(abs(a - b) / abs(b) for a, b in zip(cached_losses, losses))
    check(cache_rel <= 1e-2, f"--device_cache: first-epoch losses differ by {cache_rel} rel: {cached_losses} {losses}")
    check(cached.hbm is not None and not cached.hbm["oversubscribed"]
          and cached.hbm["projected_peak"] >= cached.corpus_bytes, f"--device_cache guard report {cached.hbm}")
    phase("seg3d_train", steps=task.step, losses=[round(x, 4) for x in losses], grafted=f"{len(grafted)}/{len(enc)}",
          params_moved=f"{len(params) - len(still)}/{len(params)}",
          **{k.replace("/", "_"): v for k, v in metrics.items()}, wall_s=round(wall, 2),
          first_epoch_ms_per_step=1000.0 * result.epochs[0]["seconds"] / result.epochs[0]["steps"],
          steady_ms_per_step=steady_ms(result), steady_vol_per_s=VOL_BATCH * 1000.0 / steady_ms(result),
          guard_peak_gib=result.hbm["projected_peak"] / 2**30,
          cache_epoch_losses_bit_equal=cached_losses == losses[:VOL_STEPS], cache_losses_max_rel=cache_rel,
          cache_corpus_mib=cached.corpus_bytes / 2**20, cache_guard_peak_gib=cached.hbm["projected_peak"] / 2**30,
          cache_ms_per_step=epoch_ms(cached), cache_wall_s=round(cache_wall, 2), card=repr(card))
    return result.checkpoint


def run_resume3d(torch, root: str, workdir: str, card: str) -> None:
    """The 3D segmentation trainer stopped by SIGTERM mid-epoch and resumed,
    held as the 2D trainers are in ``run_resume``."""
    from medical_image_segmentation_tpu_torch.core.checkpoint import load_checkpoint
    from medical_image_segmentation_tpu_torch.train import train_segmentation3d
    from medical_image_segmentation_tpu_torch.train.seg3d_task import Segmentation3DTask

    total, skip = VOL_EPOCHS * VOL_STEPS, VOL_RESUME_STOP % VOL_STEPS
    argv = vol_argv(root, workdir, "resume3d", "--max_epochs", str(VOL_EPOCHS), "--limit_steps_per_epoch",
                    str(VOL_STEPS), "--checkpoint_every_epochs", "0", "--eval_every_epochs", "0")
    t0 = time.time()
    first = stopped_run(Segmentation3DTask, VOL_RESUME_STOP, train_segmentation3d.run, argv)
    second = train_segmentation3d.run(argv + ["--resume"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    task = second.task
    check(first.stopped and first.task.step == VOL_RESUME_STOP and first.test is None,
          f"seg3d stopped at {first.task.step}")
    check(second.resumed_from == VOL_RESUME_STOP and second.skipped == skip and task.step == total,
          f"seg3d resumed from {second.resumed_from}, skipped {second.skipped}, ended at {task.step}")
    check(first.schedule + second.schedule == [(s, task.schedule(s)) for s in range(total)],
          "seg3d: the steps' lr differ from an uninterrupted run's")
    check(second.val is None and second.test is not None, "seg3d: --eval_every_epochs 0 ran a val pass or no test")
    saved = load_checkpoint(first.checkpoint)
    check(saved["epoch"] == VOL_RESUME_STOP // VOL_STEPS, f"the stopped checkpoint's epoch is {saved['epoch']}")
    fresh = Segmentation3DTask(features=VOL_FEATURES, device=VOL_DEVICE)
    fresh.load_state_dict(saved)
    gen = torch.Generator(device=VOL_DEVICE)
    gen.set_state(saved["aug_generator"])
    restored = {**cpu_tree(fresh.state_dict()), "epoch": saved["epoch"], "aug_generator": gen.get_state()}
    check(trees_equal(restored, saved), "seg3d: the restored state differs from the saved one")
    phase("resume3d", steps=f"{VOL_RESUME_STOP}+{total - VOL_RESUME_STOP}", skipped=skip, restored_bit_equal=True,
          wall_s=round(wall, 2), card=repr(card))


def run_predict3d(torch, root: str, workdir: str, ckpt: str, card: str) -> None:
    """The predict3d entry point on the volumes to serve, cold then warm."""
    import numpy as np

    from medical_image_segmentation_tpu_torch.data.nifti import read_nifti
    from medical_image_segmentation_tpu_torch.data.volumes import minmax_unit, read_volume
    from medical_image_segmentation_tpu_torch.eval.sliding_window import count_windows_3d, sliding_window_predict_3d
    from medical_image_segmentation_tpu_torch.train import predict3d
    from medical_image_segmentation_tpu_torch.train.seg3d_task import Segmentation3DTask

    serve = os.path.join(root, "serve")
    n_win = [count_windows_3d((z, x, y), VOL_CROP) for x, y, z in VOL_PREDICT]
    check(all(n == VOL_PREDICT_WINDOWS for n in n_win),
          f"the volumes take {n_win} windows of {VOL_CROP}, expected {VOL_PREDICT_WINDOWS} each")
    summaries = {}
    for run in ("cold", "warm"):
        out_dir = os.path.join(workdir, f"masks3d_{run}")
        summaries[run] = predict3d.run(["--checkpoint", os.path.dirname(ckpt), "--device", VOL_DEVICE,
                                        "--features", *map(str, VOL_FEATURES), "--window", *map(str, VOL_CROP),
                                        "--images_dir", serve, "--output_dir", out_dir])
        check(summaries[run]["volumes"] == len(VOL_PREDICT) and summaries[run]["windows"] == sum(n_win),
              f"predict3d {run}: {summaries[run]}")
        files = sorted(os.listdir(out_dir))
        check(files == [f"scan_{i}_mask.nii.gz" for i in range(len(VOL_PREDICT))], f"predict3d {run}: wrote {files}")
    masks = [np.asarray(read_nifti(os.path.join(workdir, "masks3d_warm", f"scan_{i}_mask.nii.gz")).data)
             for i in range(len(VOL_PREDICT))]
    for mask, shape in zip(masks, VOL_PREDICT):  # the file's own (X, Y, Z), not the network's (Z, X, Y)
        check(mask.shape == shape and mask.dtype == np.uint8 and set(np.unique(mask)) <= {0, 1},
              f"mask {mask.shape} {mask.dtype} for a volume of {shape}")

    # the ragged volume's mask against the task's own prediction on the (Z, X, Y) volume
    args = predict3d.parse_args(["--images_dir", serve, "--output_dir", workdir])
    task = Segmentation3DTask(features=VOL_FEATURES, device=VOL_DEVICE)
    task.model.load_state_dict(torch.load(ckpt, map_location=VOL_DEVICE, weights_only=True)["model"])
    x = torch.from_numpy(minmax_unit(read_volume(os.path.join(serve, "scan_2.nii.gz")))[..., None]).to(VOL_DEVICE)
    sx, sy, sz = VOL_PREDICT[2]
    check(tuple(x.shape[:3]) == (sz, sx, sy), f"the (Z, X, Y) volume is {tuple(x.shape)}")
    logits = sliding_window_predict_3d(task.logits, (x - args.mean) / args.std, window=VOL_CROP)
    want = np.moveaxis((torch.sigmoid(logits[..., 0]) > 0.5).cpu().numpy().astype(np.uint8), 0, -1)
    agreement = float((masks[2] == want).mean())
    check(agreement >= 0.999, f"the written mask agrees with the task's prediction on {agreement:.5f} of voxels")

    # one window of the sliding path is the plain f32 eval forward
    task32 = Segmentation3DTask(features=VOL_FEATURES, device=VOL_DEVICE, dtype=torch.float32)
    task32.model.load_state_dict(task.model.state_dict())
    one = ((x - args.mean) / args.std)[:VOL_CROP[0], :VOL_CROP[1], :VOL_CROP[2]].contiguous()
    got = sliding_window_predict_3d(task32.logits, one, window=VOL_CROP, batch_windows=1)
    ref = task32.logits(one[None])[0]
    one_window_rel = float((got - ref).abs().max() / ref.abs().max())
    check(got.shape == ref.shape and one_window_rel <= 1e-5,
          f"one-window sliding logits differ from the forward by {one_window_rel} rel")

    warm = summaries["warm"]["seconds_per_volume"]
    phase("predict3d", volumes=len(VOL_PREDICT), windows_per_volume=n_win[0], mvox_per_volume=masks[0].size / 1e6,
          mvox_per_s_cold=summaries["cold"]["value"], mvox_per_s_warm=summaries["warm"]["value"],
          first_volume_s_cold=round(summaries["cold"]["seconds_per_volume"][0], 3),
          s_per_volume_warm=[round(t, 3) for t in warm], mask_agreement=agreement,
          mask_on_share=float(np.mean([m.mean() for m in masks])), one_window_rel=one_window_rel, card=repr(card))


def run_export3d(torch, root: str, workdir: str, ckpt: str, card: str) -> str:
    """``mis-export3d-torch`` on the trained checkpoint, then
    ``mis-predict3d-torch --exported`` against phase 21's masks; returns the
    artifact's path."""
    import numpy as np

    from medical_image_segmentation_tpu_torch.data.nifti import read_nifti
    from medical_image_segmentation_tpu_torch.train import export3d, predict3d

    art = os.path.join(workdir, "window.misx")
    t0 = time.time()
    summary = export3d.run(["--checkpoint", os.path.dirname(ckpt), "--output", art, "--device", VOL_DEVICE,
                            "--features", *map(str, VOL_FEATURES), "--window", *map(str, VOL_CROP),
                            "--batch_windows", str(VOL_BATCH)])
    export_s = time.time() - t0
    check(summary["window"] == list(VOL_CROP) and summary["batch_windows"] == VOL_BATCH
          and summary["bytes"] == os.path.getsize(art), f"export3d summary {summary}")
    out_dir = os.path.join(workdir, "masks3d_exported")
    served = predict3d.run(["--exported", art, "--device", VOL_DEVICE, "--images_dir", os.path.join(root, "serve"),
                            "--output_dir", out_dir])
    check(served["exported"] and served["volumes"] == len(VOL_PREDICT) and served["window"] == list(VOL_CROP)
          and served["windows"] == VOL_PREDICT_WINDOWS * len(VOL_PREDICT), f"predict3d --exported: {served}")
    agreement = []
    for i in range(len(VOL_PREDICT)):
        got, want = (np.asarray(read_nifti(os.path.join(workdir, d, f"scan_{i}_mask.nii.gz")).data)
                     for d in ("masks3d_exported", "masks3d_warm"))
        check(got.shape == want.shape and got.dtype == np.uint8, f"exported mask {got.shape} {got.dtype}")
        agreement.append(float((got == want).mean()))
    check(min(agreement) >= 0.999, f"--exported masks agree with the checkpoint-backed masks on {agreement} of voxels")
    phase("export3d", window=VOL_CROP, batch_windows=VOL_BATCH, artifact_bytes=summary["bytes"],
          export_s=round(export_s, 2), mask_agreement=agreement, mvox_per_s=served["value"],
          s_per_volume=[round(t, 3) for t in served["seconds_per_volume"]],
          capture_s=round(served["capture_seconds"], 3), card=repr(card))
    return art


def run_fused3d(torch, root: str, workdir: str, ckpt: str, art: str, card: str) -> None:
    """The fused volumetric predictor against the loop, alone and through
    ``mis-predict3d-torch``."""
    from medical_image_segmentation_tpu_torch import serve
    from medical_image_segmentation_tpu_torch.data.volumes import minmax_unit, read_volume
    from medical_image_segmentation_tpu_torch.eval.sliding_window import make_fused_predictor_3d, sliding_window_predict_3d
    from medical_image_segmentation_tpu_torch.train import predict3d
    from medical_image_segmentation_tpu_torch.train.seg3d_task import Segmentation3DTask

    served_dir = os.path.join(root, "serve")
    args = predict3d.parse_args(["--images_dir", served_dir, "--output_dir", workdir])
    state = torch.load(ckpt, map_location=VOL_DEVICE, weights_only=True)["model"]
    x01 = torch.from_numpy(minmax_unit(read_volume(os.path.join(served_dir, "scan_0.nii.gz")))[..., None]).to(VOL_DEVICE)
    x = serve.normalize_unit(x01, args.mean, args.std)
    fields = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        task = Segmentation3DTask(features=VOL_FEATURES, device=VOL_DEVICE, dtype=dtype)
        task.model.load_state_dict(state)
        fused = make_fused_predictor_3d(task.logits, x.shape, VOL_CROP, batch_windows=VOL_BATCH, device=VOL_DEVICE)
        eager, got = fused(x), fused(x)  # the warm-up pass, then the capture and a replay
        want = sliding_window_predict_3d(task.logits, x, VOL_CROP, batch_windows=VOL_BATCH)
        rel = float((got - want).abs().max() / want.abs().max())
        check(got.shape == want.shape and rel <= 1e-5, f"fused 3D against the loop in {name}: {rel} of the largest logit")
        check(fused.replays == 1 and torch.equal(eager, got), "the eager pass and the replay of the fused predictor disagree")
        fields[f"{name}_rel"] = rel
        fields[f"{name}_capture_s"] = round(fused.capture_seconds, 3)
    check(fused.n_windows == VOL_PREDICT_WINDOWS, f"the fused predictor tiles {fused.n_windows} windows")
    _, window_fn = serve.load_window_predictor(art, device=VOL_DEVICE)
    fused_art = make_fused_predictor_3d(window_fn, x01.shape, VOL_CROP, batch_windows=VOL_BATCH, device=VOL_DEVICE)
    fused_art(x01)
    rel = float((fused_art(x01) - want).abs().max() / want.abs().max())
    check(rel <= 1e-5, f"the artifact replayed inside a captured graph differs from the checkpoint's loop by {rel}")
    loop = lambda: sliding_window_predict_3d(task.logits, x, VOL_CROP, batch_windows=VOL_BATCH)  # noqa: E731
    fields.update(artifact_in_graph_rel=rel, artifact_capture_s=round(fused_art.capture_seconds, 3),
                  loop_device_ms=event_ms(torch, loop, 5), fused_device_ms=event_ms(torch, lambda: fused(x), 5),
                  fused_artifact_device_ms=event_ms(torch, lambda: fused_art(x01), 5),
                  loop_kernels_per_volume=device_breakdown(torch, loop, 2)["kernels"],
                  graph_pool_gib=round(torch.cuda.memory_reserved() / 2**30, 2))

    argv = ["--checkpoint", os.path.dirname(ckpt), "--device", VOL_DEVICE, "--features", *map(str, VOL_FEATURES),
            "--window", *map(str, VOL_CROP), "--batch_windows", str(VOL_BATCH), "--images_dir", served_dir]
    turns = []
    for i, use_fused in enumerate((False, True, True, False)):
        out = predict3d.run([*argv, "--output_dir", os.path.join(workdir, f"masks3d_turn{i}")], fused=use_fused)
        check(out["volumes"] == len(VOL_PREDICT), f"predict3d turn {i}: {out}")
        if use_fused:
            check(out["fused_shapes"] == len(set(VOL_PREDICT)), f"built {out['fused_shapes']} predictors")
        turns.append(("fused" if use_fused else "loop", out["value"], [round(t, 3) for t in out["seconds_per_volume"]],
                      out.get("capture_seconds")))

    # the traffic a captured graph is for: a directory of scans resampled to one grid, so every
    # volume after the second replays. Copies of one file: reading, min-max and gzip cost the same.
    same_dir = os.path.join(workdir, "serve_same")
    os.makedirs(same_dir)
    for i in range(VOL_SAME_SHAPE):
        shutil.copy(os.path.join(served_dir, "scan_0.nii.gz"), os.path.join(same_dir, f"scan_{i:02d}.nii.gz"))
    same_argv = [*argv[:-1], same_dir]
    same = []
    for i, use_fused in enumerate((False, True, True, False)):
        out = predict3d.run([*same_argv, "--output_dir", os.path.join(workdir, f"masks3d_same{i}")], fused=use_fused)
        check(out["volumes"] == VOL_SAME_SHAPE and (not use_fused or out["fused_shapes"] == 1), f"same-shape turn {i}: {out}")
        steady = sorted(out["seconds_per_volume"][2:])
        same.append(("fused" if use_fused else "loop", out["value"], round(steady[len(steady) // 2], 4),
                     out.get("capture_seconds")))
    phase("fused3d", volume="x".join(map(str, VOL_PREDICT[0])), windows=fused.n_windows, **fields,
          cli_mvox_per_s_in_turns=[(n, v) for n, v, _, _ in turns],
          cli_s_per_volume_in_turns=[(n, t) for n, _, t, _ in turns],
          cli_capture_s=[round(c, 3) for _, _, _, c in turns if c is not None],
          same_shape_volumes=VOL_SAME_SHAPE, same_shape_mvox_per_s_in_turns=[(n, v) for n, v, _, _ in same],
          same_shape_median_s_per_volume_in_turns=[(n, t) for n, _, t, _ in same],
          same_shape_capture_s=[round(c, 3) for _, _, _, c in same if c is not None], card=repr(card))


def device_breakdown(torch, fn, steps: int = 3) -> dict:
    """Kernels a call of ``fn`` and their device time by kind, from
    ``torch.profiler`` over ``steps`` calls: the busy milliseconds a call and
    the share of convolutions and matrix products, of reductions, of
    elementwise and copy kernels, and of the rest."""
    from torch.profiler import ProfilerActivity, profile

    kinds = (("conv", ("conv", "gemm", "cudnn", "cutlass", "xmma", "wgrad", "dgrad", "nchwtonhwc", "nhwctonchw")),
             ("reduce", ("reduce", "welford", "var_mean")),
             ("elementwise", ("elementwise", "vectorized", "copy", "cat", "index", "gather", "fill")))
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    total, count, by_kind = 0.0, 0, {k: 0.0 for k, _ in kinds}
    by_kind["other"] = 0.0
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
        if not us:
            continue
        name = e.key.lower()
        kind = next((k for k, words in kinds if any(w in name for w in words)), "other")
        by_kind[kind] += us
        total += us
        count += e.count
    if not total:
        return {"kernels": 0}
    return {"kernels": count // steps, "busy_ms": total / steps / 1000.0,
            **{f"{k}_share": round(v / total, 3) for k, v in by_kind.items()}}


def run_seg3d_step(torch, card: str) -> None:
    """Device-resident 3D augmentation + step at full width: CUDA-event
    times at batch 4 and 32, FLOPs, peaks with and without remat, the
    volumetric BYOL step, and the memory guard's report."""
    import numpy as np
    from torch.utils.flop_counter import FlopCounterMode

    from medical_image_segmentation_tpu_torch.core import hbm
    from medical_image_segmentation_tpu_torch.ops.augment3d import byol_two_view_augment_3d, segmentation_augment_3d
    from medical_image_segmentation_tpu_torch.train.byol_task import BYOLTask
    from medical_image_segmentation_tpu_torch.train.seg3d_task import Segmentation3DTask

    rng = np.random.default_rng(9)
    base_vols, base_masks = spheres_batch(torch, rng, VOL_STEP_BATCHES[0], VOL_SIZE)
    gen = torch.Generator(device=VOL_DEVICE).manual_seed(3)

    def make(remat: bool):
        task = Segmentation3DTask(features=VOL_FEATURES, device=VOL_DEVICE, warmup_epochs=0, max_epochs=100,
                                  steps_per_epoch=10, remat=remat)
        task.init(0)
        return task

    fields = {}
    for batch in VOL_STEP_BATCHES:
        reps = batch // VOL_STEP_BATCHES[0]
        vols, masks = base_vols.repeat(reps, 1, 1, 1, 1), base_masks.repeat(reps, 1, 1, 1, 1)

        def augment():
            return segmentation_augment_3d(gen, vols, masks, out_size=VOL_CROP, train=True)

        x, y = augment()
        peaks, losses = {}, {}
        for remat in (False, True):  # a fresh task's first step, from the same weights and batch
            task = make(remat)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            losses[remat] = float(task.train_step(x, y)["train/loss"])
            peaks[remat] = torch.cuda.max_memory_allocated()
            del task
            torch.cuda.empty_cache()
        loss_rel = abs(losses[True] - losses[False]) / abs(losses[False])
        check(loss_rel <= 1e-6, f"seg3d batch {batch}: remat changed the forward: loss rel {loss_rel}")
        check(peaks[True] < peaks[False], f"seg3d batch {batch}: remat peak {peaks[True]} not under {peaks[False]}")

        task = make(False)
        with FlopCounterMode(display=False) as flops:
            task.train_step(x, y)
        step_tflop = flops.get_total_flops() / 1e12
        n = 20 if batch == VOL_STEP_BATCHES[0] else 5
        ms = {"aug_step": event_ms(torch, lambda: task.train_step(*augment()), n),
              "step": event_ms(torch, lambda: task.train_step(x, y), n),
              "aug": event_ms(torch, augment, n),
              "fwd": event_ms(torch, lambda: task.logits(x), n)}
        t0 = time.perf_counter()
        for _ in range(n):
            task.train_step(x, y)
        host_ms = 1000.0 * (time.perf_counter() - t0) / n   # the host's time to queue a step, no sync inside
        torch.cuda.synchronize()
        check(math.isfinite(float(task.train_step(x, y)["train/loss"])), "non-finite loss in the timed 3D steps")
        fields.update({f"b{batch}_ms_{k}": v for k, v in ms.items()})
        fields.update({f"b{batch}_host_queue_ms_step": host_ms, f"b{batch}_vol_per_s": batch * 1000.0 / ms["aug_step"],
                       f"b{batch}_step_tflop": step_tflop, f"b{batch}_tflop_per_s": step_tflop / ms["step"] * 1000.0,
                       f"b{batch}_peak_gib_plain": peaks[False] / 2**30, f"b{batch}_peak_gib_remat": peaks[True] / 2**30,
                       f"b{batch}_remat_loss_rel": loss_rel})
        fields.update({f"b{batch}_step_{k}": v for k, v in device_breakdown(torch, lambda: task.train_step(x, y)).items()})
        if batch == VOL_STEP_BATCHES[0]:  # the guard on this configuration; the state bit-equal across its probe
            before, gen_before = cpu_tree(task.state_dict()), gen.get_state()

            def probe():
                with hbm.preserved(task, gen):
                    task.train_step(*augment())

            mem = hbm.guard_step(probe, label=f"seg3d train step (batch {batch})", device=VOL_DEVICE)
            equal = trees_equal(cpu_tree(task.state_dict()), before) and torch.equal(gen.get_state(), gen_before)
            check(mem is not None and not mem["oversubscribed"] and equal, f"seg3d guard: {mem}, state equal {equal}")
            fields.update(guard_peak_gib=mem["projected_peak"] / 2**30, guard_state_bit_equal=equal)
        del task, vols, masks, x, y
        torch.cuda.empty_cache()

    byol = BYOLTask(volumetric=True, features3d=VOL_FEATURES, in_channels=1, hidden_dim=VOL_HIDDEN,
                    proj_dim=VOL_PROJ, num_classes=2, probe_loss_weight=0.0, warmup_epochs=0, device=VOL_DEVICE)
    byol.init(0)

    def views():
        return byol_two_view_augment_3d(gen, base_vols, out_size=VOL_CROP)

    torch.cuda.reset_peak_memory_stats()
    fields.update(byol_b4_ms_aug_step=event_ms(torch, lambda: byol.train_step(*views()), 20),
                  byol_b4_ms_aug=event_ms(torch, views, 20), byol_b4_peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    check(math.isfinite(float(byol.train_step(*views())["loss"])), "non-finite loss in the timed volumetric BYOL steps")
    phase("seg3d_step", features=VOL_FEATURES, crop=VOL_CROP, **fields, card=repr(card))


# ------------------------------------------------------------ several ranks

DIST_DEVICE = "cuda"
DIST_RANKS = 2
DIST_BYOL = dict(arch="resnet18", in_channels=1, hidden_dim=4096, proj_dim=256, num_classes=10, learning_rate=0.1,
                 warmup_epochs=0, max_epochs=2, total_steps=2, steps_per_epoch=1)
DIST_BYOL_BATCH, DIST_VIEW = 256, 112
DIST_SEG = dict(arch="resnet18", learning_rate=0.5, warmup_epochs=0, max_epochs=2, min_lr=0.01, steps_per_epoch=1)
DIST_SEG_BATCH, DIST_SEG_SIZE = 64, 224
DIST_SEG3D = dict(features=(32, 64, 128, 256), learning_rate=0.5, warmup_epochs=0, max_epochs=2, min_lr=0.01,
                  steps_per_epoch=1)
DIST_SEG3D_BATCH, DIST_SEG3D_CROP = 4, (32, 64, 64)
DIST_CASES = ("byol", "tp", "seg", "seg3d_group", "seg3d_batch")
DIST_TRAIN_EPOCHS, DIST_TRAIN_STEPS = 2, 4


def dist_batches(torch, case: str, device, scale: float = 1.0):
    """Two global f32 batches of ``case``, made from a seed on the CPU (the
    same in every process), the first input scaled by ``scale``."""
    import numpy as np

    gen = torch.Generator().manual_seed(11)
    if case in ("byol", "tp"):
        shape = (DIST_BYOL_BATCH, DIST_VIEW, DIST_VIEW, 1)
        steps = [(torch.randn(shape, generator=gen), torch.randn(shape, generator=gen),
                  torch.randint(0, 10, (DIST_BYOL_BATCH,), generator=gen)) for _ in range(2)]
    elif case == "seg":
        rng = np.random.default_rng(5)
        steps = []
        for _ in range(2):
            imgs, masks = zip(*disk_slices(rng, DIST_SEG_BATCH, DIST_SEG_SIZE))
            x = (np.stack(imgs)[..., None].astype(np.float32) - 110.0) / 60.0
            steps.append((torch.from_numpy(x), torch.from_numpy(np.stack(masks)[..., None].astype(np.float32))))
    else:
        rng = np.random.default_rng(6)
        steps = []
        for _ in range(2):
            pairs = [sphere_volume(rng, DIST_SEG3D_CROP) for _ in range(DIST_SEG3D_BATCH)]
            vols = np.stack([(v - v.min()) / float(v.max() - v.min()) for v, _ in pairs]).astype(np.float32)
            masks = np.stack([m for _, m in pairs]).astype(np.float32)
            steps.append((torch.from_numpy((vols[..., None] - 0.2) / 0.2), torch.from_numpy(masks[..., None])))
    return [((b[0] * scale).to(device),) + tuple(t.to(device) for t in b[1:]) for b in steps]


def dist_case(torch, case: str, mesh, device, scale: float = 1.0) -> dict:
    """Two f32 steps of ``case`` from the seeded initial weights, this
    rank's rows (and, for the 3D cases, depth slab) of the global batches
    (all of them without a mesh): the losses and the whole state on the
    CPU."""
    from medical_image_segmentation_tpu_torch.parallel.mesh import data_rows, depth_slab
    from medical_image_segmentation_tpu_torch.train.byol_task import BYOLTask
    from medical_image_segmentation_tpu_torch.train.seg3d_task import Segmentation3DTask
    from medical_image_segmentation_tpu_torch.train.segmentation_task import SegmentationTask

    if case in ("byol", "tp"):
        task = BYOLTask(dtype=torch.float32, device=device, mesh=mesh, **DIST_BYOL)
    elif case == "seg":
        task = SegmentationTask(dtype=torch.float32, device=device, mesh=mesh, **DIST_SEG)
    else:
        task = Segmentation3DTask(norm=case.split("_")[1], dtype=torch.float32, device=device, mesh=mesh,
                                  **DIST_SEG3D)
    task.init(0)
    losses = []
    for batch in dist_batches(torch, case, device, scale):
        rows = data_rows(mesh, batch[0].shape[0])
        if case.startswith("seg3d"):
            slab = depth_slab(mesh, batch[0].shape[1])
            batch = tuple(t[:, slab] for t in batch)
        m = task.train_step(*(t[rows] for t in batch))
        losses.append(float(m["loss" if case in ("byol", "tp") else "train/loss"]))
    state = task.state_dict()
    sides = ("online", "target") if case in ("byol", "tp") else ("model",)
    return {"losses": losses, "state": {side: {k: v.detach().cpu() for k, v in state[side].items()}
                                        for side in sides}}


def dist_config() -> dict:
    """The module's DIST_* and SPACE_* settings, which a spawned rank takes
    over."""
    return {k: v for k, v in globals().items() if k.startswith(("DIST_", "SPACE_")) and k.isupper()}


def _dist_rank(rank: int, port: int, out_path: str, config: dict, space: int = 1) -> None:
    """One rank of the step cases: joins a gloo group of DIST_RANKS ranks on
    the one card and runs every case (the ``tp`` case on a (data=1,
    model=DIST_RANKS) mesh); with ``space`` > 1 the 3D cases of
    SPACE_CASES on a (data, space) = (DIST_RANKS / space, space) mesh."""
    globals().update(config)
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(DIST_RANKS), "LOCAL_RANK": str(rank),
                       "LOCAL_WORLD_SIZE": str(DIST_RANKS), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)})
    sys.path.insert(0, ROOT)
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from medical_image_segmentation_tpu_torch.parallel.mesh import (
        initialize_distributed, make_mesh, shutdown_distributed,
    )

    try:
        proc = initialize_distributed(DIST_DEVICE)
        if space > 1:
            mesh = make_mesh(("data", "space"), (DIST_RANKS // space, space), device=proc.device)
            meshes = {case: mesh for case in SPACE_CASES}
        else:
            dp = make_mesh(device=proc.device)
            tp = make_mesh(("data", "model"), (1, DIST_RANKS), device=proc.device)
            meshes = {case: tp if case == "tp" else dp for case in DIST_CASES}
        out = {"backend": proc.backend, "device": str(proc.device), "sharing": proc.ranks_per_device}
        from medical_image_segmentation_tpu_torch.ops import fused_augment as fa

        calls = BatchNormCalls(torch)
        for case, mesh in meshes.items():
            t0 = time.time()
            out[case] = dist_case(torch, case, mesh, proc.device)
            out[case]["seconds"] = time.time() - t0
            out[case]["bn"] = calls.take()
        out["launches"] = fa.fused_two_view_augment.launches
        torch.save(("ok", out), out_path)
    except BaseException:
        import traceback

        torch.save(("error", traceback.format_exc()), out_path)
    finally:
        shutdown_distributed()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _group_err(a, b, keys) -> float:
    return (max(float((a[k].double() - b[k].double()).abs().max()) for k in keys)
            / max(float(b[k].abs().max()) for k in keys))


def spawn_dist_ranks(workdir: str, name: str, space: int = 1):
    """DIST_RANKS spawned ``_dist_rank`` processes; returns them and their
    result paths."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    port = free_port()
    paths = [os.path.join(workdir, f"{name}_rank{r}.pt") for r in range(DIST_RANKS)]
    procs = [ctx.Process(target=_dist_rank, args=(r, port, paths[r], dist_config(), space))
             for r in range(DIST_RANKS)]
    for p in procs:
        p.start()
    return procs, paths


def join_dist_ranks(torch, procs, paths, name: str) -> list:
    """The ranks' results, once each rank finished and reported gloo on the
    shared card; fails on a rank that hung, died or raised."""
    for p in procs:
        p.join(600)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    check(not alive, f"{len(alive)} {name} ranks did not finish")
    ranks = []
    for r, path in enumerate(paths):
        check(os.path.exists(path), f"{name} rank {r} exited with code {procs[r].exitcode} and no result")
        status, value = torch.load(path, weights_only=False)
        check(status == "ok", f"{name} rank {r} failed:\n{value}")
        ranks.append(value)
    on_card = DIST_DEVICE == "cuda"
    check(all(r["backend"] == "gloo" and r["device"] == ("cuda:0" if on_card else DIST_DEVICE) and
              r["sharing"] == (DIST_RANKS if on_card else 1) for r in ranks),
          f"{name} ranks ran on {[(r['backend'], r['device'], r['sharing']) for r in ranks]}")
    return ranks


def run_dist_steps(torch, workdir: str, card: str, space: int = 1):
    """The step cases in DIST_RANKS gloo ranks sharing the card, against one
    process on the whole batch. Parameters and statistics per group within
    three times the one-process step's own spread under a 1e-6 change of
    the input, and never looser than 1e-3 is needed (the card/CPU parity
    phases' rule: the ranks' convolutions run at half the batch, where
    cuDNN may sum in another order, and BatchNorm biases have gradients of
    rounding noise); step-1 losses to 1e-4; the ranks equal to the bit.
    ``space`` > 1 also starts the depth-sharded ranks of ``space_steps``
    (they run beside these; their start-up is most of their time). Returns
    the one-process references (and their spreads) by case, and the
    depth-sharded ranks (or None)."""
    torch.cuda.empty_cache()
    t0 = time.time()
    procs, paths = spawn_dist_ranks(workdir, "dist")
    space_ranks = spawn_dist_ranks(workdir, "space", space) if space > 1 else None
    # the one-process references meanwhile (the ranks' host-side all-reduces leave the card idle)
    refs = {}
    for case in DIST_CASES:
        if case == "tp":
            continue  # the tensor-parallel step is held against the replicated BYOL step
        refs[case] = (dist_case(torch, case, None, DIST_DEVICE), dist_case(torch, case, None, DIST_DEVICE, 1 + 1e-6))
    torch.cuda.empty_cache()
    ranks = join_dist_ranks(torch, procs, paths, "dist")
    ranks_s = time.time() - t0
    hold_dist_cases(torch, "dist", ranks, refs, DIST_CASES)
    phase("dist_steps", ranks=DIST_RANKS, backend="gloo", ranks_seconds=round(ranks_s, 2), card=repr(card))
    return refs, space_ranks


def hold_dist_cases(torch, name: str, ranks: list, refs: dict, cases) -> dict:
    """Each case of the ranks against its one-process reference; prints a
    ``<name>_<case>`` line each and returns their fields."""
    out = {}
    for case in cases:
        one, spread = refs["byol" if case == "tp" else case]
        fields = dict(ranks=DIST_RANKS, rank_seconds=round(ranks[0][case]["seconds"], 2),
                      losses=ranks[0][case]["losses"], one_process_losses=one["losses"])
        for r, rank in enumerate(ranks):  # tp's data group is one rank: its BatchNorm stays local
            check_global_bn(f"{name}_{case} rank {r}", rank[case]["bn"], global_path=case != "tp")
        if case == "byol":
            want = len(ranks[0][case]["losses"]) * BN_STEP_KERNELS
            check(ranks[0][case]["bn"]["launches"] == want,
                  f"{name}_byol: {ranks[0][case]['bn']['launches']} global BatchNorm launches, not {want}")
        fields["bn_launches"] = [rank[case]["bn"]["launches"] for rank in ranks]
        loss_rel = abs(ranks[0][case]["losses"][0] - one["losses"][0]) / abs(one["losses"][0])
        check(loss_rel <= 1e-4, f"{name} {case}: step-1 loss {ranks[0][case]['losses'][0]} vs {one['losses'][0]}")
        fields["loss_rel"] = loss_rel
        for side, sd in one["state"].items():
            for r in ranks[1:]:
                check(all(torch.equal(r[case]["state"][side][k], ranks[0][case]["state"][side][k]) for k in sd),
                      f"{name} {case}: the ranks' {side} states differ")
            stats = [k for k in sd if "running_" in k]
            for group, keys in (("params", [k for k in sd if k not in stats]), ("stats", stats)):
                if not keys:
                    continue
                err = _group_err(ranks[0][case]["state"][side], sd, keys)
                own = _group_err(spread["state"][side], sd, keys)
                check(err <= max(1e-3, 3 * own), f"{name} {case}: {side} {group} {err} (one-process spread {own})")
                fields[f"{side}_{group}_rel"] = err
                fields[f"{side}_{group}_spread"] = own
        phase(f"{name}_{case}", **fields)
        out[case] = fields
    return out


DIST_TRAIN_RUNNER = r"""
import hashlib, json, os, sys, time
root, out_path = sys.argv[1:3]
sys.path.insert(0, root)
import torch
import chip_smoke as cs
from medical_image_segmentation_tpu_torch.data.datamodules import get_datamodule
from medical_image_segmentation_tpu_torch.ops import fused_augment as fa
from medical_image_segmentation_tpu_torch.parallel.mesh import shutdown_distributed
from medical_image_segmentation_tpu_torch.train import train_ssl

try:
    fa.fused_two_view_augment.launches = 0
    calls = cs.BatchNormCalls(torch)
    t0 = time.time()
    result = train_ssl.run(sys.argv[3:])
    if result.task.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.time() - t0
    launches = fa.fused_two_view_augment.launches
    bn = calls.take()
    digest = hashlib.sha256()
    state = result.task.state_dict()
    for side in ("online", "target"):
        for k, v in state[side].items():
            digest.update(k.encode())
            digest.update(v.detach().cpu().contiguous().numpy().tobytes())
    # the kernel at this rank's shape against its plain version, then timed
    dm = get_datamodule("RADIOLOGY_1M")()
    cfg1, cfg2 = dm.view_configs()
    rank = int(os.environ["RANK"])
    gen = torch.Generator(device=result.task.device).manual_seed(100 + rank)
    b = int(sys.argv[sys.argv.index("--batch_size") + 1]) // int(os.environ["WORLD_SIZE"])
    imgs = torch.randint(0, 256, (b, 256, 256, 1), generator=gen, device=result.task.device, dtype=torch.uint8)
    params = fa.sample_view_params(gen, b, 256, 256, cfg1, cfg2)
    mean, std = tuple(dm.train_mean), tuple(dm.train_std)
    got = fa.fused_two_view_augment(imgs, cfg1, cfg2, mean, std, torch.bfloat16, params=params)
    want = fa.two_view_augment_reference(params, imgs, cfg1.out_size, mean, std, cfg1.value_max, dtype=torch.bfloat16)
    ulps = max(cs.bf16_ulps(g, w) for g, w in zip(got, want))
    err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    kernel_ms = plain_ms = None
    if imgs.is_cuda:
        kernel_ms = cs.cold_ms(lambda: fa.fused_two_view_augment(imgs, cfg1, cfg2, mean, std, torch.bfloat16,
                                                                   params=params), 20)
        plain_ms = cs.cold_ms(lambda: fa.two_view_augment_reference(params, imgs, cfg1.out_size, mean, std,
                                                                     cfg1.value_max, dtype=torch.bfloat16), 5)
    bounds = cs.kernel_bounds(torch, fa, params, imgs, cfg1.out_size, torch.bfloat16)
    steady = result.epochs[1:] or result.epochs
    ms_step = 1000.0 * sum(e["seconds"] for e in steady) / sum(e["steps"] for e in steady)
    out = {"ok": True, "rank": rank, "launches": launches, "bn": bn, "steps": result.task.step,
           "digest": digest.hexdigest(),
           "used_kernel": result.used_kernel, "losses": [e["loss"] for e in result.epochs], "wall_s": wall,
           "ms_per_step": ms_step, "hbm": result.hbm, "kernel_batch": b, "kernel_max_bf16_ulp": ulps,
           "kernel_max_abs_err": err, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "bound_ms": bounds["bound_us"] / 1000.0, "bound_by": bounds["bound_by"]}
except BaseException:
    import traceback
    out = {"ok": False, "error": traceback.format_exc()}
finally:
    shutdown_distributed()
with open(out_path, "w") as f:
    json.dump(out, f)
"""


def dist_train_argv(workdir: str, name: str) -> list:
    return ["--device", DIST_DEVICE, "--dataset", "RADIOLOGY_1M", *SSL_WIDTH, "--batch_size", str(SSL_BATCH),
            "--max_epochs", str(DIST_TRAIN_EPOCHS), "--limit_steps_per_epoch", str(DIST_TRAIN_STEPS),
            "--warmup_epochs", "0", "--checkpoint_every_epochs", str(DIST_TRAIN_EPOCHS), "--val_every_epochs", "0",
            "--num_workers", "4", "--seed", "0", "--log_dir", os.path.join(workdir, f"{name}_logs"),
            "--checkpoint_dir", os.path.join(workdir, name)]


def run_dist_train(torch, fa, workdir: str, card: str) -> list:
    """``mis-train-ssl-torch`` at full width (global batch SSL_BATCH) in
    DIST_RANKS gloo ranks on the card: the ranks end bit-equal, each
    launched the kernel once a step and once for the memory guard's probe,
    and each rank's kernel output at its batch equals the plain version
    within 1 bf16 ulp. Returns the ranks' records."""
    port = free_port()
    argv = dist_train_argv(workdir, "dist_ssl")
    outs = [os.path.join(workdir, f"dist_train{r}.json") for r in range(DIST_RANKS)]
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    procs = [subprocess.Popen([sys.executable, "-c", DIST_TRAIN_RUNNER, ROOT, outs[r], *argv], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env={**env, "RANK": str(r), "WORLD_SIZE": str(DIST_RANKS), "LOCAL_RANK": str(r),
                                   "LOCAL_WORLD_SIZE": str(DIST_RANKS), "MASTER_ADDR": "127.0.0.1",
                                   "MASTER_PORT": str(port)})
             for r in range(DIST_RANKS)]
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=600)[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    recs = []
    for r, (p, path) in enumerate(zip(procs, outs)):
        check(os.path.exists(path), f"dist train rank {r} exited with code {p.returncode}:\n{errs[r][-3000:]}")
        with open(path) as f:
            rec = json.load(f)
        check(rec["ok"], f"dist train rank {r} failed:\n{rec.get('error')}")
        check(f"process {r}/{DIST_RANKS}:" in errs[r] and "backend gloo" in errs[r],
              f"rank {r} printed no gloo process line")
        recs.append(rec)
    steps = DIST_TRAIN_EPOCHS * DIST_TRAIN_STEPS
    for rec in recs:
        check(rec["used_kernel"], f"rank {rec['rank']} did not route the views through the kernel")
        check(rec["steps"] == steps, f"rank {rec['rank']} ran {rec['steps']} steps")
        check(rec["launches"] == steps + 1, f"rank {rec['rank']} launched the kernel {rec['launches']} times for "
                                            f"{steps} steps and one guard probe")
        check_global_bn(f"dist_train rank {rec['rank']}", rec["bn"])
        check(rec["bn"]["forwards"] > 0, f"dist_train rank {rec['rank']}: no BatchNorm took the global path")
        check(rec["kernel_max_bf16_ulp"] <= 1, f"rank {rec['rank']}: kernel and plain differ by "
                                               f"{rec['kernel_max_bf16_ulp']} bf16 ulp")
        check(all(math.isfinite(x) for x in rec["losses"]), f"rank {rec['rank']}: losses {rec['losses']}")
    check(len({rec["digest"] for rec in recs}) == 1, "the ranks' parameters differ")
    check(sorted(os.listdir(os.path.join(workdir, "dist_ssl"))) == [f"{steps}.pt"],
          f"checkpoints written: {os.listdir(os.path.join(workdir, 'dist_ssl'))}")
    r0 = recs[0]
    phase("dist_train", ranks=DIST_RANKS, steps=steps, launches=[r["launches"] for r in recs],
          bn_launches=[r["bn"]["launches"] for r in recs],
          ms_per_step=[r["ms_per_step"] for r in recs], img_per_s=SSL_BATCH * 1000.0 / r0["ms_per_step"],
          losses=r0["losses"], wall_s=[round(r["wall_s"], 2) for r in recs], hbm=r0["hbm"],
          kernel_batch=r0["kernel_batch"], kernel_ms=[r["kernel_ms"] for r in recs],
          kernel_plain_ms=[r["plain_ms"] for r in recs], kernel_bound_ms=r0["bound_ms"],
          kernel_share_of_bound=r0["bound_ms"] / r0["kernel_ms"] if r0["kernel_ms"] else None,
          kernel_max_bf16_ulp=[r["kernel_max_bf16_ulp"] for r in recs], card=repr(card))
    return recs


def run_dist_nccl(torch, fa, workdir: str, card: str) -> dict:
    """The same run in this process, plain (no group) and then as the one
    rank of an NCCL group, where every collective of the data-parallel
    path (the gradient all-reduce, the metrics, the weights' broadcast, the
    checkpoint barrier) runs through NCCL on the card. Both in one process,
    so cuDNN's autotuner picks the same algorithms: the guard probe's and
    the first step's losses must be equal (the same weights and batch), the
    later ones within 1e-3 relative and the parameters within 1e-3 of the
    largest (a backward convolution may sum in another order from run to
    run; equal is expected). Returns ms a step of both."""
    import torch.distributed as dist

    from medical_image_segmentation_tpu_torch.parallel.mesh import shutdown_distributed
    from medical_image_segmentation_tpu_torch.train import train_ssl
    from medical_image_segmentation_tpu_torch.train.byol_task import BYOLTask

    original = BYOLTask.train_step
    losses = []

    def recorded(self, *a, **kw):
        m = original(self, *a, **kw)
        losses[-1].append(float(m["loss"]))
        return m

    runs = {}
    launch_env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1",
                  "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
    BYOLTask.train_step = recorded
    try:
        for name in ("plain", "nccl"):
            losses.append([])
            if name == "nccl":
                os.environ.update(launch_env)
            try:
                fa.fused_two_view_augment.launches = 0
                result = train_ssl.run(dist_train_argv(workdir, f"dist_{name}"))
                launches = fa.fused_two_view_augment.launches
                backend = dist.get_backend() if dist.is_initialized() else None
            finally:
                shutdown_distributed()
                for k in launch_env:
                    os.environ.pop(k, None)
            steady = result.epochs[1:]
            state = result.task.state_dict()
            runs[name] = dict(backend=backend, launches=launches, losses=losses[-1], state={side: {k: v.detach().cpu() for k, v in
                                                                              state[side].items()}
                                                                       for side in ("online", "target")},
                              ms=1000.0 * sum(e["seconds"] for e in steady) / sum(e["steps"] for e in steady))
            del result, state
            torch.cuda.empty_cache()
    finally:
        BYOLTask.train_step = original
    plain, nccl = runs["plain"], runs["nccl"]
    check(plain["backend"] is None and nccl["backend"] == "nccl", f"backends {plain['backend']}, {nccl['backend']}")
    check(nccl["losses"][:2] == plain["losses"][:2] and len(nccl["losses"]) == len(plain["losses"]) and
          all(abs(a - b) <= 1e-3 * abs(b) for a, b in zip(nccl["losses"], plain["losses"])),
          f"one-rank NCCL losses {nccl['losses']} vs plain {plain['losses']}")
    errs = {side: _group_err(nccl["state"][side], plain["state"][side], list(plain["state"][side]))
            for side in ("online", "target")}
    equal = all(torch.equal(nccl["state"][s][k], plain["state"][s][k]) for s in errs for k in plain["state"][s])
    check(max(errs.values()) <= 1e-3, f"one-rank NCCL parameters vs plain: {errs}")
    steps = DIST_TRAIN_EPOCHS * DIST_TRAIN_STEPS
    check(nccl["launches"] == plain["launches"] == steps + 1, f"launches {plain['launches']}, {nccl['launches']}")
    phase("dist_nccl", ranks=1, backend="nccl", launches=nccl["launches"], first_loss=nccl["losses"][1],
          losses_equal=nccl["losses"] == plain["losses"],
          params_bit_equal=equal, params_rel=errs, ms_per_step_plain=plain["ms"], ms_per_step_nccl=nccl["ms"],
          card=repr(card))
    return {"plain": plain["ms"], "nccl": nccl["ms"], "launches": nccl["launches"]}


def run_dist(torch, fa, workdir: str, card: str):
    """The data-parallel phases: the step cases (and beside them the
    depth-sharded 3D steps, ``space_steps``), the trainer in two gloo ranks
    and in a one-rank NCCL group. Returns the kernel launches of each rank
    of the two-rank trainer and of the NCCL run, and the fields of the
    depth-sharded steps."""
    t0 = time.time()
    refs, space_ranks = run_dist_steps(torch, workdir, card, SPACE_RANKS)
    space_fields = run_space_steps(torch, refs, space_ranks, card)
    recs = run_dist_train(torch, fa, workdir, card)
    ms = run_dist_nccl(torch, fa, workdir, card)
    phase("dist", seconds=round(time.time() - t0, 2), ms_per_step_1_rank=ms["plain"],
          ms_per_step_1_rank_nccl=ms["nccl"], ms_per_step_2_ranks_gloo=recs[0]["ms_per_step"],
          note="two ranks share one card and all-reduce through the host (gloo): no measure of multi-card scaling",
          card=repr(card))
    return {"launches_data_parallel_path": [r["launches"] for r in recs], "launches_nccl_path": ms["launches"],
            "data_parallel_kernel_batch": recs[0]["kernel_batch"], "data_parallel_ms": recs[0]["kernel_ms"],
            "data_parallel_bound_ms": recs[0]["bound_ms"],
            "data_parallel_max_bf16_ulp": max(r["kernel_max_bf16_ulp"] for r in recs)}, space_fields


# ------------------------------------------------- depth sharding, replicas

SPACE_RANKS = 2                                       # one space group of DIST_RANKS ranks: (data, space) = (1, 2)
SPACE_CASES = ("seg3d_group", "seg3d_batch")
SPACE_EPOCHS, SPACE_STEPS = 2, 4
MULTI_DEVICES = ("cuda:0", "cuda:0")                  # two replicas on the one card
MULTI_BATCHED_SLICES = 64


def halo_bytes(features, crop, batch: int, space: int, itemsize: int, in_channels: int = 1) -> dict:
    """Bytes of the halo slot buffers one rank all-reduces in a ``UNet3D``
    step (forward and backward), from the shapes: each sharded convolution
    all-reduces (space, batch, left + right, H, W, C_in) values; and what
    point-to-point transfers would move (each rank's left + right slices)."""
    n = len(features)
    convs = []                                   # (level, C_in, left + right)
    for i, f in enumerate(features):
        convs += [(i, in_channels if i == 0 else features[i - 1], 2), (i, f, 2)]
        if i < n - 1:
            convs.append((i, f, 1))              # down{i}: one slice on the left
    for i in reversed(range(n - 1)):
        convs += [(i, features[i + 1] + features[i], 2), (i, features[i], 2)]
    per_pass = sum(space * batch * lr * (crop[1] >> lvl) * (crop[2] >> lvl) * c * itemsize for lvl, c, lr in convs)
    return {"slot_bytes_per_step": 2 * per_pass, "point_to_point_bytes_per_step": 2 * per_pass // space,
            "sharded_convolutions": len(convs)}


def run_space_steps(torch, refs: dict, space_ranks, card: str) -> dict:
    """The 3D step cases (GroupNorm, then BatchNorm) in DIST_RANKS gloo
    ranks sharing the card on a (data, space) = (1, SPACE_RANKS) mesh
    (``space_ranks``, started by ``run_dist_steps``), each rank on its depth
    slab of the whole global batch, against the dist phase's one-process
    steps on the whole batch, held as those are."""
    t0 = time.time()
    ranks = join_dist_ranks(torch, *space_ranks, "space")
    fields = hold_dist_cases(torch, "space", ranks, refs, SPACE_CASES)
    check(all(r["launches"] == 0 for r in ranks), f"space step ranks launched two_view_augment "
                                                  f"{[r['launches'] for r in ranks]} times")
    halo = halo_bytes(DIST_SEG3D["features"], DIST_SEG3D_CROP, DIST_SEG3D_BATCH, SPACE_RANKS, 4)
    phase("space_steps", ranks=DIST_RANKS, mesh=f"(data, space) = (1, {SPACE_RANKS})", backend="gloo",
          join_seconds=round(time.time() - t0, 2), f32_halo=halo, launches=[r["launches"] for r in ranks],
          card=repr(card))
    return {"cases": fields, "launches": sum(r["launches"] for r in ranks)}


SPACE_TRAIN_RUNNER = r"""
import hashlib, json, os, sys, time
root, out_path = sys.argv[1:3]
sys.path.insert(0, root)
import torch
from medical_image_segmentation_tpu_torch.ops import fused_augment as fa
from medical_image_segmentation_tpu_torch.parallel.mesh import shutdown_distributed
from medical_image_segmentation_tpu_torch.train import train_segmentation3d
import chip_smoke as cs

try:
    calls = cs.BatchNormCalls(torch)
    t0 = time.time()
    result = train_segmentation3d.run(sys.argv[3:])
    if result.task.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.time() - t0
    digest = hashlib.sha256()
    for k, v in result.task.model.state_dict().items():
        digest.update(k.encode())
        digest.update(v.detach().cpu().contiguous().numpy().tobytes())
    steady = result.epochs[1:] or result.epochs
    out = {"ok": True, "rank": int(os.environ["RANK"]), "launches": fa.fused_two_view_augment.launches,
           "bn": calls.take(), "steps": result.task.step, "losses": [float(x) for x in result.losses], "digest": digest.hexdigest(),
           "ms_per_step": 1000.0 * sum(e["seconds"] for e in steady) / sum(e["steps"] for e in steady),
           "wall_s": wall, "val": result.val, "test": result.test, "checkpoint": result.checkpoint,
           "hbm": result.hbm}
except BaseException:
    import traceback
    out = {"ok": False, "error": traceback.format_exc()}
finally:
    shutdown_distributed()
with open(out_path, "w") as f:
    json.dump(out, f)
"""


def run_space_train(torch, fa, root: str, workdir: str, steps: dict, card: str) -> int:
    """``mis-train-segmentation3d-torch --space_shards SPACE_RANKS`` in bf16
    at full width in DIST_RANKS gloo ranks sharing the card, SPACE_EPOCHS ×
    SPACE_STEPS steps: the ranks end equal to the bit with finite losses,
    only rank 0 writes the checkpoint; then ``--resume`` of that checkpoint
    in this process under ``--space_shards 1`` for one more epoch. Prints
    the ``space`` line with ``steps`` (what ``run_space_steps`` returned).
    Returns the kernel launches on this path."""
    from medical_image_segmentation_tpu_torch.train import train_segmentation3d

    before = fa.fused_two_view_augment.launches
    t0 = time.time()
    port = free_port()
    n_steps = SPACE_EPOCHS * SPACE_STEPS
    argv = vol_argv(root, workdir, "space", "--space_shards", str(SPACE_RANKS), "--max_epochs", str(SPACE_EPOCHS),
                    "--limit_steps_per_epoch", str(SPACE_STEPS), "--checkpoint_every_epochs", str(SPACE_EPOCHS))
    outs = [os.path.join(workdir, f"space_train{r}.json") for r in range(DIST_RANKS)]
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    procs = [subprocess.Popen([sys.executable, "-c", SPACE_TRAIN_RUNNER, ROOT, outs[r], *argv], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env={**env, "RANK": str(r), "WORLD_SIZE": str(DIST_RANKS), "LOCAL_RANK": str(r),
                                   "LOCAL_WORLD_SIZE": str(DIST_RANKS), "MASTER_ADDR": "127.0.0.1",
                                   "MASTER_PORT": str(port)})
             for r in range(DIST_RANKS)]
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=600)[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    recs = []
    for r, (p, path) in enumerate(zip(procs, outs)):
        check(os.path.exists(path), f"space train rank {r} exited with code {p.returncode}:\n{errs[r][-3000:]}")
        with open(path) as f:
            rec = json.load(f)
        check(rec["ok"], f"space train rank {r} failed:\n{rec.get('error')}")
        check(f"process {r}/{DIST_RANKS}:" in errs[r] and "backend gloo" in errs[r],
              f"space rank {r} printed no gloo process line")
        check(rec["steps"] == n_steps and len(rec["losses"]) == n_steps and
              all(math.isfinite(x) and 0.0 <= x <= 1.0 for x in rec["losses"]),
              f"space rank {r}: {rec['steps']} steps, losses {rec['losses']}")
        check(rec["launches"] == 0, f"space rank {r} launched two_view_augment {rec['launches']} times")
        check_global_bn(f"space_train rank {r}", rec["bn"])
        recs.append(rec)
    check(len({rec["digest"] for rec in recs}) == 1 and recs[0]["losses"] == recs[1]["losses"],
          "the space ranks' parameters or losses differ")
    ckpt_dir = os.path.join(workdir, "space", "ckpt")
    check(sorted(os.listdir(ckpt_dir)) == [f"{n_steps}.pt"], f"checkpoints written: {os.listdir(ckpt_dir)}")
    ranks_s = time.time() - t0

    # the checkpoint of the depth-sharded run resumes in one process, unsharded
    t1 = time.time()
    resumed = train_segmentation3d.run(vol_argv(root, workdir, "space", "--resume", "--space_shards", "1",
                                                "--max_epochs", str(SPACE_EPOCHS + 1),
                                                "--limit_steps_per_epoch", str(SPACE_STEPS)))
    torch.cuda.synchronize()
    resume_s = time.time() - t1
    more = [float(x) for x in resumed.losses]
    check(resumed.resumed_from == n_steps and resumed.task.step == n_steps + SPACE_STEPS and len(more) == SPACE_STEPS
          and all(math.isfinite(x) for x in more), f"resume under one space shard: from {resumed.resumed_from}, "
                                                    f"step {resumed.task.step}, losses {more}")
    launches = fa.fused_two_view_augment.launches - before
    check(launches == 0, f"the space path launched two_view_augment {launches} times in this process")
    halo = halo_bytes(VOL_FEATURES, VOL_CROP, VOL_BATCH, SPACE_RANKS, 2)
    r0 = recs[0]
    phase("space", ranks=DIST_RANKS, space_shards=SPACE_RANKS, steps=n_steps, losses=[round(x, 4) for x in r0["losses"]],
          ms_per_step=[round(r["ms_per_step"], 2) for r in recs], vol_per_s=VOL_BATCH * 1000.0 / r0["ms_per_step"],
          wall_s=[round(r["wall_s"], 2) for r in recs], ranks_seconds=round(ranks_s, 2),
          val=r0["val"], test=r0["test"], guard_peak_gib=r0["hbm"]["projected_peak"] / 2**30 if r0["hbm"] else None,
          bf16_halo=halo, halo_mb_per_step=halo["slot_bytes_per_step"] / 1e6,
          resumed_one_shard_from=resumed.resumed_from, resumed_losses=[round(x, 4) for x in more],
          resume_s=round(resume_s, 2),
          group_steps={case: {k: v for k, v in f.items() if k.endswith(("_rel", "_spread"))}
                       for case, f in steps["cases"].items()},
          launches=[r["launches"] for r in recs] + [launches], bn_launches=[r["bn"]["launches"] for r in recs],
          note="two ranks share one card and all-reduce through the host (gloo): no measure of multi-card scaling",
          card=repr(card))
    return launches


def _diff(a, b) -> dict:
    """Masks differing and the largest |logit| difference of two logit
    tensors."""
    return {"masks_differing": int(((a > 0) != (b > 0)).sum()), "max_abs_logit_diff": float((a - b).abs().max())}


def run_multicard_2d(torch, fa, workdir: str, ckpt: str, card: str) -> int:
    """Replicas MULTI_DEVICES against one card on seg_train's checkpoint: the
    logits of a batch of MULTI_BATCHED_SLICES 224² slices and of one 512²
    slice through the sliding-window loop (two devices) against the fused
    predictor (one); then ``mis-predict-torch`` batched on
    MULTI_BATCHED_SLICES slices of 512² and ``--sliding_window`` on the 16
    slices, one device and two in turns (one, two, two, one): equal masks or
    the pixels that differ, images a second. Returns the kernel launches."""
    import numpy as np

    from medical_image_segmentation_tpu_torch.data.datamodules import get_datamodule
    from medical_image_segmentation_tpu_torch.data.store import CODEC_RAW, StoreWriter
    from medical_image_segmentation_tpu_torch.eval.sliding_window import (
        make_fused_predictor_2d, sliding_window_predict,
    )
    from medical_image_segmentation_tpu_torch.serve import normalize_u8
    from medical_image_segmentation_tpu_torch.train import predict
    from medical_image_segmentation_tpu_torch.train.segmentation_task import SegmentationTask

    before = fa.fused_two_view_augment.launches
    devices = [torch.device(d) for d in MULTI_DEVICES]
    dm = get_datamodule(SEG_DATASET)()
    task = SegmentationTask(device=SEG_DEVICE)
    task.model.load_state_dict(torch.load(ckpt, map_location=SEG_DEVICE, weights_only=True)["model"])
    replicas = task.replicas(devices)
    slices = [img for img, _ in disk_slices(np.random.default_rng(1), MULTI_BATCHED_SLICES, PREDICT_SIZE)]
    batch = np.stack([predict._resize_nearest(img, (SEG_SIZE, SEG_SIZE)) for img in slices])
    x = normalize_u8(torch.from_numpy(batch[..., None]).to(SEG_DEVICE), dm.mean, dm.std)
    fields = {"batched_logits": _diff(replicas(x), task.logits(x))}
    xs = normalize_u8(torch.from_numpy(slices[0][..., None]).to(SEG_DEVICE), dm.mean, dm.std)
    fused = make_fused_predictor_2d(task.logits, xs.shape, SEG_SIZE, device=SEG_DEVICE)
    fused(xs)
    fields["sliding_logits"] = _diff(sliding_window_predict(replicas, xs, SEG_SIZE, devices=devices), fused(xs))

    store = os.path.join(workdir, "multicard_batched.mis")
    with StoreWriter(store, channels=1) as w:
        for img in slices:
            w.add(img[..., None], codec=CODEC_RAW)
    base = ["--checkpoint", os.path.dirname(ckpt), "--device", SEG_DEVICE, "--dataset", SEG_DATASET,
            "--image_size", str(SEG_SIZE), "--batch_size", str(SEG_BATCH), "--num_workers", "8"]
    for mode, extra, n in (("batched", ["--image_store", store], MULTI_BATCHED_SLICES),
                           ("sliding", ["--image_store", os.path.join(workdir, "predict_sliding.mis"),
                                        "--sliding_window", str(SEG_SIZE)], SLIDING_SLICES)):
        rates, masks = {1: [], 2: []}, {}
        for i, n_dev in enumerate((1, 2, 2, 1)):
            out_dir = os.path.join(workdir, f"multicard_{mode}_{i}")
            out = predict.run([*base, *extra, "--output_dir", out_dir], devices=devices[:n_dev])
            check(out["images"] == n and out["devices"] == n_dev, f"multicard {mode} turn {i}: {out}")
            rates[n_dev].append(out["images"] / out["seconds"])
            masks.setdefault(n_dev, served_masks(out_dir))
        differing = sum(int((m != masks[1][k]).sum()) for k, m in masks[2].items())
        fields[f"{mode}_masks_differing_pixels"] = differing
        fields[f"{mode}_img_per_s_one_device"] = [round(r, 2) for r in rates[1]]
        fields[f"{mode}_img_per_s_two_replicas"] = [round(r, 2) for r in rates[2]]
    launches = fa.fused_two_view_augment.launches - before
    check(launches == 0, f"the multi-device serving path launched two_view_augment {launches} times")
    phase("multicard_2d", devices=[str(d) for d in devices], batched_slices=MULTI_BATCHED_SLICES,
          sliding_slices=SLIDING_SLICES, **fields, launches=launches,
          note="two replicas on one card: the split and gather run, no second card to gain from", card=repr(card))
    return launches


def run_multicard_3d(torch, fa, root: str, workdir: str, ckpt: str, card: str) -> int:
    """The same for ``mis-predict3d-torch`` on seg3d_train's checkpoint and the four
    160×160×80 volumes: one volume's logits through the loop over two
    replicas against the fused predictor, then the CLI in turns (one, two,
    two, one): equal masks or the voxels that differ, megavoxels a second.
    Returns the kernel launches."""
    import numpy as np

    from medical_image_segmentation_tpu_torch.data.nifti import read_nifti
    from medical_image_segmentation_tpu_torch.data.volumes import minmax_unit, read_volume
    from medical_image_segmentation_tpu_torch.eval.sliding_window import (
        make_fused_predictor_3d, sliding_window_predict_3d,
    )
    from medical_image_segmentation_tpu_torch.serve import normalize_unit
    from medical_image_segmentation_tpu_torch.train import predict3d
    from medical_image_segmentation_tpu_torch.train.seg3d_task import Segmentation3DTask

    before = fa.fused_two_view_augment.launches
    devices = [torch.device(d) for d in MULTI_DEVICES]
    task = Segmentation3DTask(features=VOL_FEATURES, device=VOL_DEVICE)
    task.model.load_state_dict(torch.load(ckpt, map_location=VOL_DEVICE, weights_only=True)["model"])
    serve = os.path.join(root, "serve")
    vol = minmax_unit(read_volume(os.path.join(serve, sorted(os.listdir(serve))[0])))
    x = normalize_unit(torch.from_numpy(vol[..., None]).to(VOL_DEVICE), 0.2089, 0.2109)
    fused = make_fused_predictor_3d(task.logits, x.shape, VOL_CROP, batch_windows=VOL_BATCH, device=VOL_DEVICE)
    fused(x)
    fields = {"volume_logits": _diff(sliding_window_predict_3d(task.replicas(devices), x, VOL_CROP,
                                                               batch_windows=VOL_BATCH, devices=devices), fused(x))}
    argv = ["--checkpoint", os.path.dirname(ckpt), "--features", *map(str, VOL_FEATURES), "--images_dir", serve,
            "--window", *map(str, VOL_CROP), "--batch_windows", str(VOL_BATCH), "--device", VOL_DEVICE]
    rates, masks = {1: [], 2: []}, {}
    for i, n_dev in enumerate((1, 2, 2, 1)):
        out_dir = os.path.join(workdir, f"multicard3d_{i}")
        out = predict3d.run([*argv, "--output_dir", out_dir], devices=devices[:n_dev])
        check(out["volumes"] == len(VOL_PREDICT) and out["devices"] == n_dev, f"multicard 3D turn {i}: {out}")
        rates[n_dev].append(out["value"])
        masks.setdefault(n_dev, {f: read_nifti(os.path.join(out_dir, f)).get_fdata() for f in sorted(os.listdir(out_dir))})
    differing = sum(int((m != masks[1][k]).sum()) for k, m in masks[2].items())
    launches = fa.fused_two_view_augment.launches - before
    check(launches == 0, f"the multi-device volumetric serving path launched two_view_augment {launches} times")
    phase("multicard_3d", devices=[str(d) for d in devices], volumes=len(VOL_PREDICT), **fields,
          masks_differing_voxels=differing, mvox_per_s_one_device=rates[1], mvox_per_s_two_replicas=rates[2],
          launches=launches, note="two replicas on one card: the split and gather run, no second card to gain from",
          card=repr(card))
    return launches


# The port's benchmark programs at their default widths and batches
BENCH_DEVICE = "cuda"
BENCH_FLAGS = ["--steps", "5", "--warmup", "2"]
BENCH_STORE = ["--task", "byol", "--store", "auto", "--store_images", "512", "--batch_size", "256"]
BENCH_RUNS = {
    "byol": ["--task", "byol"],
    "byol_store_raw": BENCH_STORE + ["--store_codec", "raw"],
    "byol_store_jpeg": BENCH_STORE + ["--store_codec", "jpeg"],
    "seg": ["--task", "seg"],
    "seg3d": ["--task", "seg3d"],
    "predict": ["--task", "predict"],
    "predict3d": ["--task", "predict3d"],
}
BENCH_METRICS = {"byol": "aug_train_images_per_sec_per_chip", "seg": "seg_train_images_per_sec_per_chip",
                 "seg3d": "seg3d_train_volumes_per_sec_per_chip", "predict": "predict_images_per_sec_per_chip",
                 "predict3d": "predict3d_volumes_per_sec_per_chip"}
BENCH_LOADER = ["--codec", "jpeg", "--threads", "1", "8"]


def captured_main(main, argv):
    """(exit code, stdout lines) of ``main(argv)`` run in this process."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue().strip().splitlines()


def run_bench_programs(torch, fa, card: str) -> int:
    """``bench_torch.py`` for each task and ``tools/bench_loader_torch.py``,
    in this process (phase 23). Returns the kernel's launches in the byol
    runs and each run's ``value``."""
    import bench_torch

    spec = importlib.util.spec_from_file_location("bench_loader_torch", os.path.join(ROOT, "tools",
                                                                                     "bench_loader_torch.py"))
    loader_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(loader_tool)
    steps_run = 2 + 5 + 5 + 1  # warmup, timed, the probe's min(steps, 12), the FLOP count's
    byol_launches = 0
    seconds, values = {}, {}
    torch.backends.cudnn.allow_tf32 = True
    try:
        for name, argv in BENCH_RUNS.items():
            torch.cuda.empty_cache()
            fa.fused_two_view_augment.launches = 0
            t0 = time.time()
            rc, lines = captured_main(bench_torch.main, argv + BENCH_FLAGS + ["--device", BENCH_DEVICE])
            seconds[name] = round(time.time() - t0, 2)
            launches = fa.fused_two_view_augment.launches
            check(rc == 0 and lines, f"bench_torch {' '.join(argv)}: exit {rc}, {len(lines)} lines")
            line = json.loads(lines[-1])
            print(f"[bench_{name}] {json.dumps(line)}", flush=True)
            values[name] = line.get("value")
            task = name.split("_")[0]
            check(line.get("metric") == BENCH_METRICS[task], f"bench {name}: metric {line.get('metric')!r}")
            check(isinstance(line.get("mfu"), float) and line["mfu"] > 0, f"bench {name}: mfu {line.get('mfu')!r}")
            check(line.get("device_name") and line.get("gpus") == 1 and "power_limit_w" in line,
                  f"bench {name}: card fields {line.get('device_name')!r}, {line.get('power_limit_w')!r}")
            if "store" in name:
                check(line.get("reader") == "native", f"bench {name} read through the {line.get('reader')} reader")
            if task == "byol":
                check(launches == steps_run == line["steps_run"],
                      f"bench {name} launched two_view_augment {launches} times for {line['steps_run']} steps")
                byol_launches += launches
            else:
                check(launches == 0, f"bench {name} launched two_view_augment {launches} times")
        torch.cuda.empty_cache()
        hbm_rc, lines = captured_main(bench_torch.main, ["--task", "seg3d", "--hbm_check", "--device", BENCH_DEVICE])
        check(hbm_rc in (0, 2) and lines, f"bench_torch --task seg3d --hbm_check: exit {hbm_rc}")
        hbm = json.loads(lines[-1])
        print(f"[bench_seg3d_hbm_check] {json.dumps(hbm)}", flush=True)
        check(hbm.get("metric") == "seg3d_projected_hbm_gb" and hbm.get("value") is not None,
              f"bench --hbm_check line {hbm}")
        t0 = time.time()
        rc, lines = captured_main(loader_tool.main, BENCH_LOADER)
        seconds["bench_loader"] = round(time.time() - t0, 2)
        check(rc == 0 and lines, f"tools/bench_loader_torch.py {' '.join(BENCH_LOADER)}: exit {rc}")
        loader = json.loads(lines[-1])
        print(f"[bench_loader] {json.dumps(loader)}", flush=True)
        check(loader.get("reader") == "native" and loader.get("codec") == "jpeg", f"bench_loader line {loader}")
    finally:
        torch.backends.cudnn.allow_tf32 = False
    phase("bench", runs=len(BENCH_RUNS), byol_launches=byol_launches, hbm_check_exit=hbm_rc, seconds=seconds,
          card=repr(card))
    return byol_launches, values


# bench_torch.py over the ranks of a launch (phase 24)
BENCH_RANKS_NCCL = {"byol": ["--task", "byol"], "seg": ["--task", "seg"]}
BENCH_RANKS_GLOO = {"byol": ["--task", "byol", "--batch_size", "256"], "seg3d": ["--task", "seg3d"]}
BENCH_RANKS = 2
BENCH_RANKS_PREDICT = ["--task", "predict"]
BENCH_REPLICAS = ("cuda:0", "cuda:0")                 # two replicas on the one card
BENCH_VALUE_DIGITS = {"seg3d": 2}                     # the line's rounding of value (1 elsewhere)

BENCH_RANKS_RUNNER = r"""
import contextlib, io, json, os, sys, traceback
root, out_path, device = sys.argv[1:4]
runs = json.loads(sys.argv[4])
sys.path.insert(0, root)
import torch
import bench_torch
import chip_smoke as cs
from medical_image_segmentation_tpu_torch.ops import fused_augment as fa
from medical_image_segmentation_tpu_torch.parallel.mesh import initialize_distributed, shutdown_distributed

out = {"ok": False, "rank": int(os.environ["RANK"]), "runs": {}}
try:
    torch.backends.cudnn.allow_tf32 = True
    proc = initialize_distributed(device)
    out.update(backend=proc.backend, device=str(proc.device), sharing=proc.ranks_per_device)
    calls = cs.BatchNormCalls(torch)
    for name, argv in runs.items():
        fa.fused_two_view_augment.launches = 0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = bench_torch.main(argv)
        out["runs"][name] = {"rc": rc, "stdout": buf.getvalue().strip().splitlines(),
                             "launches": fa.fused_two_view_augment.launches, "bn": calls.take()}
    out["ok"] = True
except BaseException:
    out["error"] = traceback.format_exc()
finally:
    shutdown_distributed()
with open(out_path, "w") as f:
    json.dump(out, f)
"""


def check_bench_ranks_line(name: str, line: dict, ranks: int, backend: str, chips: int) -> None:
    """The group's fields of a bench line and ``value`` = ``total_per_sec``
    over the chips, at the line's rounding."""
    task = name.split("_")[0]
    check(line.get("metric") == BENCH_METRICS[task], f"bench_ranks {name}: metric {line.get('metric')!r}")
    check((line.get("ranks"), line.get("backend")) == (ranks, backend),
          f"bench_ranks {name}: ranks {line.get('ranks')!r}, backend {line.get('backend')!r}")
    on_card = BENCH_DEVICE == "cuda"
    check(line.get("gpus") == (1 if on_card else 0), f"bench_ranks {name}: gpus {line.get('gpus')!r}")
    total = line.get("total_per_sec")
    check(isinstance(total, float) and total > 0 and
          line["value"] == round(total / chips, BENCH_VALUE_DIGITS.get(task, 1)),
          f"bench_ranks {name}: value {line.get('value')!r}, total_per_sec {total!r} over {chips}")
    check(not on_card or (isinstance(line.get("mfu"), float) and line["mfu"] > 0),
          f"bench_ranks {name}: mfu {line.get('mfu')!r}")


def bench_nccl_runs(torch, fa) -> dict:
    """BENCH_RANKS_NCCL in this process as the one rank of a torchrun
    launch: the lines and each run's kernel launches."""
    import bench_torch

    steps_run = 2 + 5 + 5 + 1
    out = {}
    for name, argv in BENCH_RANKS_NCCL.items():
        torch.cuda.empty_cache()
        env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1",
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        fa.fused_two_view_augment.launches = 0
        try:
            t0 = time.time()
            rc, lines = captured_main(bench_torch.main, argv + BENCH_FLAGS + ["--device", BENCH_DEVICE])
            seconds = time.time() - t0
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        launches = fa.fused_two_view_augment.launches
        check(rc == 0 and lines, f"bench_torch {' '.join(argv)} as one NCCL rank: exit {rc}")
        line = json.loads(lines[-1])
        print(f"[bench_ranks_nccl_{name}] {json.dumps(line)}", flush=True)
        check_bench_ranks_line(name, line, 1, "nccl" if BENCH_DEVICE == "cuda" else "gloo", 1)
        want = steps_run if name == "byol" else 0
        check(launches == want, f"bench_ranks nccl {name} launched two_view_augment {launches} times, not {want}")
        out[name] = {"line": line, "launches": launches, "seconds": round(seconds, 2)}
    return out


def bench_gloo_runs(workdir: str) -> dict:
    """BENCH_RANKS_GLOO in BENCH_RANKS spawned ranks sharing the card over
    gloo: rank 0's lines, and each rank's kernel launches by run."""
    port = free_port()
    outs = [os.path.join(workdir, f"bench_ranks{r}.json") for r in range(BENCH_RANKS)]
    runs = {name: argv + BENCH_FLAGS + ["--device", BENCH_DEVICE] for name, argv in BENCH_RANKS_GLOO.items()}
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    t0 = time.time()
    procs = [subprocess.Popen([sys.executable, "-c", BENCH_RANKS_RUNNER, ROOT, outs[r], BENCH_DEVICE,
                               json.dumps(runs)], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True,
                              env={**env, "RANK": str(r), "WORLD_SIZE": str(BENCH_RANKS), "LOCAL_RANK": str(r),
                                   "LOCAL_WORLD_SIZE": str(BENCH_RANKS), "MASTER_ADDR": "127.0.0.1",
                                   "MASTER_PORT": str(port)})
             for r in range(BENCH_RANKS)]
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=600)[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.time() - t0
    recs = []
    for r, (p, path) in enumerate(zip(procs, outs)):
        check(os.path.exists(path), f"bench_ranks rank {r} exited with code {p.returncode}:\n{errs[r][-3000:]}")
        with open(path) as f:
            rec = json.load(f)
        check(rec["ok"], f"bench_ranks rank {r} failed:\n{rec.get('error')}\n{errs[r][-2000:]}")
        check(rec["backend"] == "gloo", f"bench_ranks rank {r} joined {rec['backend']}")
        recs.append(rec)
    steps_run = 2 + 5 + 5 + 1
    out = {"seconds": round(seconds, 2)}
    for name in BENCH_RANKS_GLOO:
        runs_r = [rec["runs"][name] for rec in recs]
        check(all(run["rc"] == 0 for run in runs_r), f"bench_ranks gloo {name}: exits {[x['rc'] for x in runs_r]}")
        check(runs_r[0]["stdout"] and all(not run["stdout"] for run in runs_r[1:]),
              f"bench_ranks gloo {name}: stdout lines by rank {[len(x['stdout']) for x in runs_r]}")
        line = json.loads(runs_r[0]["stdout"][-1])
        print(f"[bench_ranks_gloo_{name}] {json.dumps(line)}", flush=True)
        check_bench_ranks_line(name, line, BENCH_RANKS, "gloo", BENCH_RANKS)
        want = steps_run if name == "byol" else 0
        launches = [run["launches"] for run in runs_r]
        check(launches == [want] * BENCH_RANKS,
              f"bench_ranks gloo {name}: two_view_augment launched {launches} times by rank, not {want} each")
        for r, run in enumerate(runs_r):
            check_global_bn(f"bench_ranks_gloo_{name} rank {r}", run["bn"])
        out[name] = {"line": line, "launches": launches}
    return out


def bench_replica_run(torch, fa) -> dict:
    """``--task predict`` with ``local_devices`` forced to BENCH_REPLICAS."""
    import bench_torch

    from medical_image_segmentation_tpu_torch.parallel import replicas

    torch.cuda.empty_cache()
    chosen = replicas.local_devices
    replicas.local_devices = lambda name: [torch.device(d) for d in BENCH_REPLICAS]
    fa.fused_two_view_augment.launches = 0
    try:
        rc, lines = captured_main(bench_torch.main, [*BENCH_RANKS_PREDICT, *BENCH_FLAGS, "--device", BENCH_DEVICE])
    finally:
        replicas.local_devices = chosen
    check(rc == 0 and lines, f"bench_torch --task predict over {BENCH_REPLICAS}: exit {rc}")
    line = json.loads(lines[-1])
    print(f"[bench_ranks_predict_replicas] {json.dumps(line)}", flush=True)
    check(line.get("devices") == len(BENCH_REPLICAS), f"bench_ranks predict: devices {line.get('devices')!r}")
    check_bench_ranks_line("predict", line, 1, None, len(BENCH_REPLICAS))
    launches = fa.fused_two_view_augment.launches
    check(launches == 0, f"bench_ranks predict launched two_view_augment {launches} times")
    return {"line": line}


def run_bench_ranks(torch, fa, workdir: str, one_process: dict, card: str) -> dict:
    """Phase 24. ``one_process``: phase 23's values by run. Returns the
    byol launches by route and rank."""
    t0 = time.time()
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True
    try:
        gloo = bench_gloo_runs(workdir)
        nccl = bench_nccl_runs(torch, fa)
        replica = bench_replica_run(torch, fa)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    over_one = {name: (round(run["line"]["value"] / one_process[name], 4) if one_process.get(name) else None)
                for name, run in nccl.items()}
    phase("bench_ranks", nccl_value_over_one_process=over_one,
          nccl_seconds={name: run["seconds"] for name, run in nccl.items()}, gloo_seconds=gloo["seconds"],
          gloo_byol_ms_per_step=gloo["byol"]["line"].get("step_ms_p50"),
          predict_replicas_value=replica["line"]["value"], seconds=round(time.time() - t0, 2), card=repr(card))
    return {"nccl": nccl["byol"]["launches"], "gloo": gloo["byol"]["launches"]}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.")
    ap.add_argument("--ab-old-source", default=None,
                    help="another version of csrc/two_view_augment.cu: run only the device, build and "
                         "kernel phases, then time that version against this one in turns")
    ab_old_source = ap.parse_args(argv).ab_old_source
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
    import importlib.util

    phase("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda, tf32="off",
          triton_imports=importlib.util.find_spec("triton") is not None, card=repr(card))

    from medical_image_segmentation_tpu_torch.data import datamodules as dm_mod
    from medical_image_segmentation_tpu_torch.data.store import native
    from medical_image_segmentation_tpu_torch.ops import _kernels
    from medical_image_segmentation_tpu_torch.ops import fused_augment as fa

    # g++ builds the native store reader while nvcc builds the kernel and the
    # kernel phase runs; native_store waits for it
    native_build = threading.Thread(target=native.get_lib)
    if not ab_old_source:
        native_build.start()
    try:
        t0 = time.time()
        so = _kernels.build_kernel("two_view_augment")
        with open(so[:-3] + ".log") as f:
            ptxas = " | ".join(ln.strip() for ln in f if "registers" in ln or "spill" in ln)
        phase("build", kernel="two_view_augment", seconds=round(time.time() - t0, 2), ptxas=ptxas or "(cached)")
        kernel_record = run_kernel_checks(torch, fa, dm_mod)
        if ab_old_source:
            run_ab(torch, fa, dm_mod, ab_old_source, card)
            return finish(torch, card, None)
        bn_record = run_bn_kernels(torch, card)
        bn_calls = BatchNormCalls(torch)
        bn_paths = {}  # BatchNorm's kernel launches in this process by path: one card, parity, serving, bench
        in_record = run_in_kernels(torch, card)
        in_paths = {}  # InstanceNorm's launches on the same paths: none runs nnU-Net
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        native_build.join()
        with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as workdir:
            run_native_store(workdir, card)
        run_parity(torch)
        run_seg_parity(torch)
        take_bn_launches(bn_calls, bn_paths, "parity")
        take_in_launches(in_paths, "parity")
        with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as workdir:
            task, launches, ssl_ckpt, raw_ms = run_trainer(torch, fa, workdir, card)
            run_step_timing(torch, fa, task, card)
            del task
            jpeg_launches = run_jpeg_trainer(torch, fa, workdir, raw_ms, card)
            # the depth-sharded steps run beside dist's; no TPU kernel lies on their path
            dist_record, space_steps = run_dist(torch, fa, workdir, card)
            space_launches = space_steps["launches"]
            seg_ckpt = run_seg_train(torch, workdir, ssl_ckpt, card)
            run_predict(torch, workdir, seg_ckpt, card)
            take_bn_launches(bn_calls, bn_paths, "one_card")
            take_in_launches(in_paths, "byol_unet2d")
            # the serving path: no TPU kernel lies on it, so none is launched
            before = fa.fused_two_view_augment.launches
            run_export(torch, workdir, seg_ckpt, card)
            run_fused2d(torch, workdir, seg_ckpt, card)
            serving_launches = fa.fused_two_view_augment.launches - before
            multicard_launches = run_multicard_2d(torch, fa, workdir, seg_ckpt, card)
            take_bn_launches(bn_calls, bn_paths, "serving")
            take_in_launches(in_paths, "serving")
            run_seg_step(torch, card)
            run_precrop(torch, fa, workdir, card)
            run_resume(torch, fa, workdir, card)
            run_ssl_eval(torch, fa, workdir, card)
            run_profile(torch, fa, workdir, card)
        run_remat(torch, fa, card)
        run_hbm(torch, fa, card)
        # the data-curation path (no kernel lies on it), then the parity
        # harness, whose pretrain stage launches the kernel
        with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as workdir:
            raw = run_ingest(torch, fa, workdir, card)
            ingest_launches = fa.fused_two_view_augment.launches
            take_bn_launches(bn_calls, bn_paths, "one_card")
            take_in_launches(in_paths, "ingest")
            parity_launches, _ = run_parity_harness(torch, fa, workdir, raw, card)
            take_bn_launches(bn_calls, bn_paths, "parity")
            take_in_launches(in_paths, "parity")
        # the volumetric path: no TPU kernel lies on it, so none is launched
        fa.fused_two_view_augment.launches = 0
        run_vol_parity(torch)
        with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as workdir:
            t0 = time.time()
            root = write_volumes(workdir)
            phase("volumes", labelled=sum(VOL_SPLITS.values()), served=len(VOL_PREDICT), seconds=round(time.time() - t0, 2))
            ssl3d_ckpt = run_ssl3d_train(torch, root, workdir, card)
            seg3d_ckpt = run_seg3d_train(torch, root, workdir, ssl3d_ckpt, card)
            run_resume3d(torch, root, workdir, card)
            run_predict3d(torch, root, workdir, seg3d_ckpt, card)
            vol_launches = fa.fused_two_view_augment.launches
            take_bn_launches(bn_calls, bn_paths, "one_card")
            take_in_launches(in_paths, "unet3d")
            window_art = run_export3d(torch, root, workdir, seg3d_ckpt, card)
            run_fused3d(torch, root, workdir, seg3d_ckpt, window_art, card)
            serving_launches += fa.fused_two_view_augment.launches - vol_launches
            fa.fused_two_view_augment.launches = vol_launches
            multicard_launches += run_multicard_3d(torch, fa, root, workdir, seg3d_ckpt, card)
            take_bn_launches(bn_calls, bn_paths, "serving")
            take_in_launches(in_paths, "serving")
            space_launches += run_space_train(torch, fa, root, workdir, space_steps, card)
            fa.fused_two_view_augment.launches = vol_launches
        run_seg3d_step(torch, card)
        take_bn_launches(bn_calls, bn_paths, "one_card")
        take_in_launches(in_paths, "unet3d")
        vol_launches = fa.fused_two_view_augment.launches
        check(vol_launches == 0, f"the volumetric path launched two_view_augment {vol_launches} times")
        check(serving_launches == 0, f"the serving path launched two_view_augment {serving_launches} times")
        check(space_launches == 0, f"the depth-sharded path launched two_view_augment {space_launches} times")
        check(multicard_launches == 0, f"the multi-device path launched two_view_augment {multicard_launches} times")
        bench_launches, bench_values = run_bench_programs(torch, fa, card)
        with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as workdir:
            bench_ranks_launches = run_bench_ranks(torch, fa, workdir, bench_values, card)
        take_bn_launches(bn_calls, bn_paths, "bench")
        take_in_launches(in_paths, "bench")
        bn_calls.handle.remove()
        check(bn_paths["serving"] == 0, f"BatchNorm's kernels launched {bn_paths['serving']} times on the serving path")
        check(not any(in_paths.values()), f"InstanceNorm's kernels launched off the nnU-Net path: {in_paths}")
        return finish(torch, card, [{"name": "two_view_augment", "route": "cuda", "source": KERNEL_SOURCE,
                                     "replaces": REPLACES, "launches": launches,
                                     "launches_volumetric_path": vol_launches,
                                     "launches_serving_path": serving_launches,
                                     "launches_space_path": space_launches,
                                     "launches_multicard_path": multicard_launches,
                                     "launches_ingest_path": ingest_launches,
                                     "launches_jpeg_store_path": jpeg_launches,
                                     "launches_parity_path": parity_launches,
                                     "launches_bench_path": bench_launches,
                                     "launches_bench_ranks_path": bench_ranks_launches, **dist_record,
                                     **kernel_record},
                                    {"name": "global_batchnorm", "route": "cuda", "source": BN_KERNEL_SOURCE,
                                     "replaces": "none: flax's BatchNorm is left to XLA",
                                     **{f"launches_{path}_path": n for path, n in bn_paths.items()},
                                     "library_calls_by_path": BN_LIBRARY_CALLS,
                                     "launches_by_rank": BN_RANK_LAUNCHES, **bn_record},
                                    {"name": "instance_norm", "route": "cuda", "source": IN_KERNEL_SOURCE,
                                     "replaces": "none: flax's GroupNorm is left to XLA",
                                     **{f"launches_{path}_path": n for path, n in in_paths.items()}, **in_record}])
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1


def finish(torch, card: str, kernels) -> int:
    """The last checks, then the card line, the kernels line (none in an
    A/B run) and the result line."""
    check("jax" not in sys.modules, "the port imported jax")
    jax_pkg = sorted(m for m in sys.modules if m.split(".")[0] == "medical_image_segmentation_tpu")
    check(not jax_pkg, f"the port imported the JAX package: {jax_pkg[:5]}")
    print(card)
    if kernels is not None:
        print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
