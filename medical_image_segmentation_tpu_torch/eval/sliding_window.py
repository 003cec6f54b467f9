"""Sliding-window full-resolution segmentation, 2D and 3D. Port of
``eval/sliding_window.py:24-334``.

An image larger than the network's window is tiled with overlapping
windows (stride window/2 by default, the last window right-aligned), the
windows go through the forward in fixed-size batches, and their logits are
blended back with a Hann profile (+1e-3, so every pixel has weight) and
divided by the summed weights. An image smaller than the window is padded
with zeros first and cropped back at the end. The window list is padded to
a whole number of batches by repeating its last window, so every forward
sees one shape; the repeats are not blended.

``count_windows`` and ``count_windows_3d`` are the one place each window
count is computed. ``devices`` (the JAX ``mesh=``, ``:84-91,294-301``
there) names the devices ``apply_fn`` splits each window batch over, a
``parallel/replicas.py::Replicas``'; the loop then rounds the window batch
up to a multiple of their count, and extraction and blending stay on the
input's device, the first of them. The 3D functions tile (D, H, W) volumes the same way,
with a window and a stride per axis.

Two variants. ``sliding_window_predict`` / ``sliding_window_predict_3d``
are the loop: per window batch one stack of slices, one forward, and two
in-place adds per window, all launched from Python. ``FusedPredictor``
(``make_fused_predictor_2d`` / ``_3d``, ``:129-229`` of the reference) is
the serving variant, specialized once per input shape: the window grid and
the Hann product are precomputed, logits and weights accumulate in ONE
(…, K+1) canvas so a window costs one slice-add, and on the card the whole
extract → forward → blend sequence over all window batches is captured
once as a CUDA graph and replayed per input, so an image costs one copy in,
one graph launch and one copy out instead of hundreds of kernel launches
from Python. The first input of a shape runs the function eagerly (that
pass is the warm-up: cuDNN's algorithm search and the first allocations
stay out of the graph), the second captures, so a shape seen once never
pays for a capture, which costs about one more eager pass of host time. On
the CPU the same function runs eagerly every time. A capture that fails
raises; nothing falls back to the loop. The graph serves traffic whose
shapes repeat (slices of one size, scans resampled to one grid); a shape
that never comes back costs one eager pass, which is the loop's work. ``FusedCache`` keeps the predictors
of the most recent shapes: each captured graph holds its own memory pool
(canvas and activations), so the cache is bounded.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _window_starts(full: int, window: int, stride: int) -> np.ndarray:
    """Start offsets covering [0, full) with the last window right-aligned."""
    if full <= window:
        return np.array([0], np.int32)
    starts = list(range(0, full - window + 1, stride))
    if starts[-1] != full - window:
        starts.append(full - window)
    return np.asarray(starts, np.int32)


def _blend_weights(window: int) -> np.ndarray:
    """1-D center-peaked (Hann) blend profile, strictly positive."""
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * (np.arange(window) + 0.5) / window)
    return (w + 1e-3).astype(np.float32)


def window_grid(h: int, w: int, window: int, stride: int = 0) -> np.ndarray:
    """(n, 2) window origins (y, x) for an h × w image, padded up to the
    window where it is smaller; ``stride`` ≤ 0 means window // 2."""
    if stride <= 0:
        stride = max(1, window // 2)
    ys = _window_starts(max(h, window), window, stride)
    xs = _window_starts(max(w, window), window, stride)
    return np.array([(y, x) for y in ys for x in xs], np.int32)


def count_windows(h: int, w: int, window: int, stride: int = 0) -> int:
    return len(window_grid(h, w, window, stride))


def _per_devices(batch_windows: int, devices: Sequence) -> int:
    """``batch_windows`` rounded up to a multiple of the device count."""
    n = max(1, len(devices))
    return -(-batch_windows // n) * n


def sliding_window_predict(
    apply_fn: Callable[[torch.Tensor], torch.Tensor],  # (N, S, S, C) → (N, S, S, K) logits
    image: torch.Tensor,                                # (H, W, C), already normalized
    window: int,
    stride: int = 0,
    batch_windows: int = 16,
    num_classes: int = 1,
    devices: Sequence = (),
) -> torch.Tensor:
    """Full-resolution (H, W, K) f32 logits on ``image``'s device."""
    batch_windows = _per_devices(batch_windows, devices)
    orig_h, orig_w, _ = image.shape
    pad_h, pad_w = max(window - orig_h, 0), max(window - orig_w, 0)
    if pad_h or pad_w:
        image = F.pad(image, (0, 0, 0, pad_w, 0, pad_h))
    h, w, _ = image.shape

    coords = window_grid(orig_h, orig_w, window, stride)
    n = len(coords)
    pad_n = (-n) % batch_windows
    if pad_n:
        coords = np.concatenate([coords, np.tile(coords[-1:], (pad_n, 1))])

    wy = torch.from_numpy(_blend_weights(window)).to(image.device)
    blend = (wy[:, None] * wy[None, :])[..., None]  # (S, S, 1)
    out_logits = torch.zeros((h, w, num_classes), dtype=torch.float32, device=image.device)
    weight_sum = torch.zeros((h, w, 1), dtype=torch.float32, device=image.device)
    for s in range(0, len(coords), batch_windows):
        cb = coords[s:s + batch_windows].tolist()
        windows = torch.stack([image[y:y + window, x:x + window] for y, x in cb])
        weighted = apply_fn(windows).float() * blend
        for j, (y, x) in enumerate(cb[:n - s]):  # the padded tail is not blended
            out_logits[y:y + window, x:x + window] += weighted[j]
            weight_sum[y:y + window, x:x + window] += blend
    return (out_logits / weight_sum)[:orig_h, :orig_w]


def window_grid_3d(dims: Sequence[int], window: Sequence[int], stride: Optional[Sequence[int]] = None) -> np.ndarray:
    """(n, 3) window origins (z, y, x), z slowest, for a volume of ``dims``
    padded up to the window where it is smaller; ``stride`` None means
    window // 2 on each axis."""
    if stride is None:
        stride = tuple(max(1, w // 2) for w in window)
    starts = [_window_starts(max(full, w), w, s) for full, w, s in zip(dims, window, stride)]
    return np.array([(z, y, x) for z in starts[0] for y in starts[1] for x in starts[2]], np.int32)


def count_windows_3d(dims: Sequence[int], window: Sequence[int], stride: Optional[Sequence[int]] = None) -> int:
    return len(window_grid_3d(dims, window, stride))


def sliding_window_predict_3d(
    apply_fn: Callable[[torch.Tensor], torch.Tensor],  # (N, d, h, w, C) → (N, d, h, w, K) logits
    volume: torch.Tensor,                               # (D, H, W, C), already normalized
    window: Sequence[int],                              # (d, h, w)
    stride: Optional[Sequence[int]] = None,             # (d, h, w); default window // 2
    batch_windows: int = 4,
    num_classes: int = 1,
    devices: Sequence = (),
) -> torch.Tensor:
    """Full-resolution (D, H, W, K) f32 logits on ``volume``'s device."""
    batch_windows = _per_devices(batch_windows, devices)
    wd, wh, ww = window = tuple(window)
    orig = tuple(volume.shape[:3])
    pads = [max(w - o, 0) for w, o in zip(window, orig)]
    if any(pads):
        volume = F.pad(volume, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
    dims = tuple(volume.shape[:3])

    coords = window_grid_3d(orig, window, stride)
    n = len(coords)
    pad_n = (-n) % batch_windows
    if pad_n:
        coords = np.concatenate([coords, np.tile(coords[-1:], (pad_n, 1))])

    wz, wy, wx = (torch.from_numpy(_blend_weights(w)).to(volume.device) for w in window)
    blend = (wz[:, None, None] * wy[None, :, None] * wx[None, None, :])[..., None]  # (d, h, w, 1)
    out_logits = torch.zeros((*dims, num_classes), dtype=torch.float32, device=volume.device)
    weight_sum = torch.zeros((*dims, 1), dtype=torch.float32, device=volume.device)
    for s in range(0, len(coords), batch_windows):
        cb = coords[s:s + batch_windows].tolist()
        windows = torch.stack([volume[z:z + wd, y:y + wh, x:x + ww] for z, y, x in cb])
        weighted = apply_fn(windows).float() * blend
        for j, (z, y, x) in enumerate(cb[:n - s]):  # the padded tail is not blended
            out_logits[z:z + wd, y:y + wh, x:x + ww] += weighted[j]
            weight_sum[z:z + wd, y:y + wh, x:x + ww] += blend
    return (out_logits / weight_sum)[:orig[0], :orig[1], :orig[2]]


class FusedPredictor:
    """Shape-specialized sliding-window predictor over ``len(window)``
    spatial axes: ``predictor(x)`` with ``x`` of ``shape`` (*spatial, C),
    already normalized, on ``device`` → (*spatial, K) f32 logits. Equal to
    the loop in f32: the same products are added in the same order.
    ``device`` has no default: it decides between the captured graph and
    the eager function, and ``"cuda"`` raises where there is no card.

    On a CUDA device the first call runs eagerly and is the warm-up, the
    second captures the graph, and from then on every call replays it on a
    static input buffer; ``capture_seconds`` is what the capture took.
    ``apply_fn`` must launch the same kernels on every call: no
    ``.item()``, no shape that depends on the data."""

    def __init__(self, apply_fn: Callable[[torch.Tensor], torch.Tensor], shape: Sequence[int],
                 window: Sequence[int], stride: Optional[Sequence[int]] = None, batch_windows: int = 8,
                 num_classes: int = 1, *, device):
        self.apply_fn = apply_fn
        self.window = window = tuple(int(w) for w in window)
        nd = len(window)
        if stride is None:
            stride = tuple(max(1, w // 2) for w in window)
        self.shape = tuple(int(v) for v in shape)
        self.orig = self.shape[:nd]
        self.pads = tuple(max(w - o, 0) for w, o in zip(window, self.orig))
        self.dims = tuple(o + p for o, p in zip(self.orig, self.pads))
        self.num_classes = num_classes
        self.batch_windows = batch_windows
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {str(self.device)!r} asked for, but CUDA is not available "
                               "(pass device='cpu' for a CPU run)")

        starts = [_window_starts(self.dims[i], window[i], int(stride[i])) for i in range(nd)]
        coords = np.stack([g.ravel() for g in np.meshgrid(*starts, indexing="ij")], axis=-1).tolist()
        self.n_windows = len(coords)
        coords += coords[-1:] * ((-len(coords)) % batch_windows)  # pad to whole batches; the repeats are not blended
        slices = [tuple(slice(c, c + w) for c, w in zip(at, window)) for at in coords]
        self._batches = [slices[s:s + batch_windows] for s in range(0, len(slices), batch_windows)]

        blend = torch.from_numpy(_blend_weights(window[0]))
        for w in window[1:]:
            blend = blend[..., None] * torch.from_numpy(_blend_weights(w))
        self._blend = blend[..., None].to(self.device)  # (*window, 1)
        self._graph = None
        self._warm = False
        self.capture_seconds = 0.0
        self.replays = 0

    @torch.no_grad()
    def _run(self, x: torch.Tensor) -> torch.Tensor:
        if any(self.pads):
            x = F.pad(x, (0, 0) + tuple(v for p in reversed(self.pads) for v in (0, p)))
        k = self.num_classes
        canvas = torch.zeros((*self.dims, k + 1), dtype=torch.float32, device=x.device)
        ones = self._blend.expand(self.batch_windows, *self._blend.shape)
        left = self.n_windows
        for batch in self._batches:
            logits = self.apply_fn(torch.stack([x[at] for at in batch])).float()
            weighted = torch.cat([logits * self._blend, ones], dim=-1)
            for j, at in enumerate(batch[:left]):
                canvas[at] += weighted[j]
            left -= len(batch)
        full = canvas[..., :k] / canvas[..., k:]
        return full[tuple(slice(0, o) for o in self.orig)]

    def _capture(self) -> None:
        t0 = time.time()
        self._static_in = torch.zeros(self.shape, dtype=torch.float32, device=self.device)
        torch.cuda.synchronize(self.device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._static_out = self._run(self._static_in)
        self._graph = graph
        self.capture_seconds = time.time() - t0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape) != self.shape:
            raise ValueError(f"predictor was built for inputs of shape {self.shape}, got {tuple(x.shape)}")
        if self.device.type != "cuda":
            return self._run(x)
        if not self._warm:
            self._warm = True
            return self._run(x)
        if self._graph is None:
            self._capture()
        self._static_in.copy_(x)
        self._graph.replay()
        self.replays += 1
        return self._static_out.clone()


def make_fused_predictor_3d(apply_fn, volume_shape, window, stride=None, batch_windows: int = 8,
                            num_classes: int = 1, *, device) -> FusedPredictor:
    """The serving variant of ``sliding_window_predict_3d`` for volumes of
    ``volume_shape`` (D, H, W, C)."""
    return FusedPredictor(apply_fn, volume_shape, window, stride, batch_windows, num_classes, device=device)


def make_fused_predictor_2d(apply_fn, image_shape, window: int, stride: int = 0, batch_windows: int = 16,
                            num_classes: int = 1, *, device) -> FusedPredictor:
    """The serving variant of ``sliding_window_predict`` for images of
    ``image_shape`` (H, W, C)."""
    return FusedPredictor(apply_fn, image_shape, (window, window), (stride, stride) if stride > 0 else None,
                          batch_windows, num_classes, device=device)


class FusedCache:
    """The predictors of the ``MAX_SHAPES`` most recently served input
    shapes, built by ``make(shape)`` at a shape's first use. A directory of
    scans of many sizes would otherwise keep one captured graph, with its
    private memory pool, for every size it has seen."""

    MAX_SHAPES = 4

    def __init__(self, make: Callable[[Tuple[int, ...]], FusedPredictor]):
        self._make = make
        self._predictors: "OrderedDict[Tuple[int, ...], FusedPredictor]" = OrderedDict()
        self.built = 0
        self.capture_seconds = 0.0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        shape = tuple(x.shape)
        predictor = self._predictors.pop(shape, None)
        if predictor is None:
            predictor = self._make(shape)
            self.built += 1
            while len(self._predictors) >= self.MAX_SHAPES:
                self._predictors.popitem(last=False)
        self._predictors[shape] = predictor
        before = predictor.capture_seconds
        out = predictor(x)
        self.capture_seconds += predictor.capture_seconds - before
        return out

    def __len__(self) -> int:
        return len(self._predictors)


def make_unet_window_fn(task) -> Callable[[torch.Tensor], torch.Tensor]:
    """The normalized-window forward for ``sliding_window_predict``: the
    task's eval-mode f32 logits."""
    return task.logits
