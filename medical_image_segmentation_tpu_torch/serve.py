"""The deployed serving functions and their exported artifacts (``.misx``).
Port of ``serve.py:32-280``.

``make_predict_fn`` is the 2D serving function: uint8 batch → /255 →
optional multi-window channels → normalize → U-Net eval forward → sigmoid
threshold → uint8 0/1 masks. ``mis-predict-torch`` serves with it, and
``mis-export-torch`` (``train/export.py``) captures that same function with
``torch.export``, once per static batch bucket, with the trained weights
inside. ``mis-export3d-torch`` captures the volumetric WINDOW function
(raw 0..1 windows in, f32 logits out, windowing and normalization inside)
for the sliding-window predictors of ``eval/sliding_window.py``.

An artifact is one self-contained file. A serving host reads it with
``load_predictor`` / ``load_window_predictor`` and calls it: no model code
(this module imports nothing of ``models/`` or ``train/``), no checkpoint.

- **Static batch buckets.** A request of any N is decomposed greedily over
  the largest buckets that fit; only a remainder smaller than every bucket
  is padded, by repeating its last sample, and the padding is dropped.
- **Size scales with buckets.** Each bucket's program carries its own copy
  of the weights: the file is about buckets × parameters (f32).
- **One device type.** A captured program holds the device of its
  constants, so an artifact serves on the device type it was exported on
  (``meta["platforms"]``); another device is refused by name.

Container layout (the JAX package's, under another magic so that each
package refuses the other's files): ``MISXT1\\n``, a u32 little-endian
JSON-header length, the JSON header ``{"meta": ..., "buckets": {"<B>":
[offset, size]}}`` (offsets from the end of the header), then the
concatenated blobs, each the bytes of ``torch.export.save``.
"""

from __future__ import annotations

import io
import json
import struct
import time
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from medical_image_segmentation_tpu_torch.core.profiling import span
from medical_image_segmentation_tpu_torch.ops.augment import apply_hu_windows
from medical_image_segmentation_tpu_torch.ops.dice import post_process_masks

Stats = Union[float, Sequence[float]]

_MAGIC = b"MISXT1\n"
_JAX_MAGIC = b"MISX1\n"


def normalize_u8(imgs_u8: torch.Tensor, mean: Stats, std: Stats,
                 hu_windows: Sequence[Tuple[float, float]] = ()) -> torch.Tensor:
    """(..., 1) uint8 → f32 network input on the 0-1 scale's stats."""
    return normalize_unit(imgs_u8.float() / torch.tensor(255.0, device=imgs_u8.device), mean, std, hu_windows)


def normalize_unit(x01: torch.Tensor, mean: Stats, std: Stats,
                   hu_windows: Sequence[Tuple[float, float]] = ()) -> torch.Tensor:
    """(..., 1) f32 on the 0-1 scale → windowed, normalized network input.
    The statistics are device tensors, so the division is a true one on
    every device (by a Python number, CUDA multiplies by the reciprocal)."""
    x = apply_hu_windows(x01, hu_windows)
    mean_t = torch.tensor(mean, dtype=torch.float32, device=x.device).reshape(-1)
    std_t = torch.tensor(std, dtype=torch.float32, device=x.device).reshape(-1)
    return (x - mean_t) / std_t


def make_predict_fn(task, mean: Stats, std: Stats, threshold: float = 0.5,
                    hu_windows: Sequence[Tuple[float, float]] = (),
                    logits: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """(B, H, W, 1) uint8 on the task's device → (B, H, W, 1) uint8 masks.
    The compute dtype is the task's (bf16 autocast, or f32). ``logits``
    replaces ``task.logits`` (``task.replicas(devices)``: the batch split
    over several devices). Under a profiler a call is a ``serve.request``
    span holding ``serve.normalize``, ``serve.forward`` and
    ``serve.post_process``."""
    logits_fn = task.logits if logits is None else logits

    def fn(imgs_u8: torch.Tensor) -> torch.Tensor:
        with span("serve.request"):
            with span("serve.normalize"):
                x = normalize_u8(imgs_u8, mean, std, hu_windows)
            with span("serve.forward"):
                logits = logits_fn(x)
            with span("serve.post_process"):
                return post_process_masks(logits, threshold=threshold).to(torch.uint8)

    return fn


def make_window_fn(task, mean: Stats, std: Stats,
                   hu_windows: Sequence[Tuple[float, float]] = ()) -> Callable[[torch.Tensor], torch.Tensor]:
    """The volumetric window function an artifact holds: raw 0..1 windows
    (B, d, h, w, 1) f32 → windowed, normalized → eval forward → f32 logits
    (B, d, h, w, K) (``serve.py:140-143``)."""

    def fn(windows01: torch.Tensor) -> torch.Tensor:
        return task.logits(normalize_unit(windows01, mean, std, hu_windows)).float()

    return fn


def _export(task, fn: Callable[[torch.Tensor], torch.Tensor], example: torch.Tensor):
    """``fn`` (a closure over ``task``) captured at ``example``'s shape. The
    wrapper owns the task's network, so its weights travel in the program."""

    class Served(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = task.model

        def forward(self, x):
            return fn(x)

    with torch.no_grad():
        return torch.export.export(Served(), (example,))


def export_predictor(task, image_size: int, mean: Stats, std: Stats, threshold: float = 0.5,
                     batch_sizes: Sequence[int] = (1, 8, 64),
                     hu_windows: Sequence[Tuple[float, float]] = ()) -> Dict[int, object]:
    """``make_predict_fn`` captured at each batch bucket →
    ``{B: ExportedProgram}``, on the task's device and in its compute dtype
    (a bf16 task exports the bf16 function, as ``mis-predict-torch`` serves
    it)."""
    fn = make_predict_fn(task, mean, std, threshold=threshold, hu_windows=tuple(tuple(w) for w in hu_windows))
    out = {}
    for b in sorted(set(int(b) for b in batch_sizes)):
        if b < 1:
            raise ValueError(f"batch bucket must be >= 1, got {b}")
        example = torch.zeros((b, image_size, image_size, 1), dtype=torch.uint8, device=task.device)
        out[b] = _export(task, fn, example)
    return out


def export_window_predictor(task, window: Sequence[int], mean: Stats, std: Stats, batch_windows: int = 4,
                            hu_windows: Sequence[Tuple[float, float]] = ()) -> Dict[int, object]:
    """``make_window_fn`` captured at ``(batch_windows, d, h, w, 1)`` →
    ``{batch_windows: ExportedProgram}``: exactly one bucket, since the
    sliding-window predictors pad every batch to one size."""
    fn = make_window_fn(task, mean, std, tuple(tuple(w) for w in hu_windows))
    d, h, w = (int(v) for v in window)
    example = torch.zeros((int(batch_windows), d, h, w, 1), dtype=torch.float32, device=task.device)
    return {int(batch_windows): _export(task, fn, example)}


def save_predictor(path: str, exported: Dict[int, object], meta: dict) -> None:
    """Write ``{batch: ExportedProgram}`` and its metadata as one container."""
    blobs = {}
    for b, program in exported.items():
        buf = io.BytesIO()
        torch.export.save(program, buf)
        blobs[int(b)] = buf.getvalue()
    buckets = {}
    offset = 0
    for b in sorted(blobs):
        buckets[str(b)] = [offset, len(blobs[b])]
        offset += len(blobs[b])
    header = json.dumps({"meta": meta, "buckets": buckets}).encode()
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(header)))
        f.write(header)
        for b in sorted(blobs):
            f.write(blobs[b])


def _read_container(path: str) -> Tuple[dict, Dict[int, bytes]]:
    with open(path, "rb") as f:
        data = f.read()
    if data[:len(_JAX_MAGIC)] == _JAX_MAGIC:
        raise ValueError(f"{path}: an artifact of the JAX package (mis-export); serve it with mis-predict / "
                         "mis-predict3d, or export the checkpoint again with mis-export-torch / mis-export3d-torch")
    if data[:len(_MAGIC)] != _MAGIC:
        raise ValueError(f"{path}: not a .misx artifact of mis-export-torch (bad magic)")
    hstart = len(_MAGIC) + 4
    if len(data) < hstart:
        raise ValueError(f"{path}: truncated artifact (header)")
    (hlen,) = struct.unpack_from("<I", data, len(_MAGIC))
    if len(data) < hstart + hlen:
        raise ValueError(f"{path}: truncated artifact (header)")
    header = json.loads(data[hstart:hstart + hlen])
    base = hstart + hlen
    blobs = {}
    for b, (off, size) in header["buckets"].items():
        blob = data[base + off:base + off + size]
        if len(blob) != size:
            raise ValueError(f"{path}: truncated artifact (bucket {b})")
        blobs[int(b)] = blob
    return header["meta"], blobs


def _serving_device(path: str, meta: dict, device) -> torch.device:
    device = torch.device(device)
    platforms = list(meta.get("platforms", ()))
    if device.type not in platforms:
        raise ValueError(f"{path}: artifact was exported for {platforms}, not for {device.type!r}; a captured "
                         f"program holds its device — export again with --device {device.type}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{path}: device {str(device)!r} asked for, but CUDA is not available "
                           "(pass device='cpu' for an artifact exported on the CPU)")
    return device


def _load_program(blob: bytes) -> Callable[[torch.Tensor], torch.Tensor]:
    return torch.export.load(io.BytesIO(blob)).module()


class ServingPredictor:
    """A loaded batched-2D artifact: call with a (N, S, S, 1) uint8 numpy
    batch of any N; returns (N, S, S, 1) uint8 0/1 masks. A bucket's
    program is deserialized at its first use and cached; ``load_seconds``
    sums what that took (``torch.export.load`` rebuilds the graph in
    Python, about a second a bucket whatever the weights' size, so an
    artifact pays back in a process that serves more than one short job)."""

    def __init__(self, meta: dict, blobs: Dict[int, bytes], device: torch.device):
        self.meta = meta
        self.device = device
        self._blobs = blobs
        self._fns: Dict[int, Callable] = {}
        self.load_seconds = 0.0

    @property
    def image_size(self) -> int:
        return int(self.meta["image_size"])

    @property
    def batch_sizes(self):
        return sorted(self._blobs)

    def _bucket_fn(self, b: int):
        if b not in self._fns:
            t0 = time.time()
            self._fns[b] = _load_program(self._blobs[b])
            self.load_seconds += time.time() - t0
        return self._fns[b]

    @torch.no_grad()
    def __call__(self, imgs_u8: np.ndarray) -> np.ndarray:
        imgs_u8 = np.ascontiguousarray(imgs_u8, np.uint8)
        if imgs_u8.ndim != 4 or imgs_u8.shape[-1] != 1:
            raise ValueError(f"expected (N, S, S, 1) uint8, got {imgs_u8.shape}")
        s = self.image_size
        if imgs_u8.shape[1:3] != (s, s):
            raise ValueError(f"artifact was exported for {s}x{s} inputs, got {imgs_u8.shape[1:3]}")
        n = imgs_u8.shape[0]
        sizes = self.batch_sizes
        out = np.empty((n, s, s, 1), np.uint8)
        i = 0
        while i < n:
            rem = n - i
            # greedy decomposition: the largest bucket that fits, so 9 images
            # with buckets (1, 8, 64) run 8 then 1 instead of padding 64; only
            # a remainder smaller than every bucket pads, up to the smallest
            # bucket that covers it
            fits = [x for x in sizes if x <= rem]
            b = fits[-1] if fits else next(x for x in sizes if x >= rem)
            take = min(rem, b)
            chunk = imgs_u8[i:i + take]
            if take < b:  # pad the tail by repeating the last sample
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], b - take, axis=0)], axis=0)
            masks = self._bucket_fn(b)(torch.from_numpy(chunk).to(self.device))
            out[i:i + take] = masks[:take].cpu().numpy()
            i += take
        return out


def load_predictor(path: str, device="cuda") -> ServingPredictor:
    """Read a batched-2D container → ``ServingPredictor`` on ``device``
    (blobs held in memory, deserialized per bucket at first use)."""
    meta, blobs = _read_container(path)
    if meta.get("kind", "batched2d") != "batched2d":
        raise ValueError(f"{path}: artifact kind {meta.get('kind')!r} is not a batched 2D predictor "
                         "(use load_window_predictor / mis-predict3d-torch --exported)")
    return ServingPredictor(meta, blobs, _serving_device(path, meta, device))


def load_window_predictor(path: str, device="cuda") -> Tuple[dict, Callable[[torch.Tensor], torch.Tensor]]:
    """Read a volumetric window artifact → ``(meta, window_fn)``.

    ``window_fn`` takes EXACTLY ``meta['batch_windows']`` raw 0..1 windows
    (B, d, h, w, 1) f32 on ``device`` and returns f32 logits: the
    ``apply_fn`` of ``eval/sliding_window.py``'s 3D predictors, which pad
    every batch to one size."""
    meta, blobs = _read_container(path)
    if meta.get("kind") != "window3d":
        raise ValueError(f"{path}: artifact kind {meta.get('kind')!r} is not a volumetric window predictor "
                         "(use load_predictor / mis-predict-torch --exported)")
    if len(blobs) != 1:
        raise ValueError(f"{path}: window3d artifacts must contain exactly one bucket (got {sorted(blobs)}); "
                         "the sliding-window predictors pad every batch to one static size")
    _serving_device(path, meta, device)
    (blob,) = blobs.values()
    fns = []

    @torch.no_grad()
    def window_fn(windows01: torch.Tensor) -> torch.Tensor:
        if not fns:
            fns.append(_load_program(blob))
        return fns[0](windows01)

    return meta, window_fn
