"""Fused two-view SSL augmentation: the wrapper of the hand-written Hopper
kernel ``csrc/two_view_augment.cu`` and its plain PyTorch version.

Counterpart of ``medical_image_segmentation_tpu/ops/pallas_augment.py``.
Per sample, both views: bilinear RandomResizedCrop (half-pixel centres,
source coordinate clamped to [0, in-1]) with the horizontal flip folded in
by mirroring the output column, then the BT.601 grayscale mix (C=3), the CT
window, solarize and the per-channel normalize, all in f32, one rounding to
the output dtype at the end.

Per-sample parameters travel as the same (B, 24) f32 block as the Pallas
kernel's: 2 views × ``[y0, x0, ch, cw, flip, sol, thr, gray, win, level,
width]``, padded to 24. The tests feed it the block the JAX
``sample_view_params`` makes, so the port and the reference see the same
draws.

``two_view_augment_reference`` is written as the kernel computes: two taps
per axis, rows first, every product and sum rounded on its own (the kernel
uses ``__fmul_rn``/``__fadd_rn`` so nvcc contracts nothing into an FMA).
The normalize multiplies by ``1/std`` rounded once to f32, in both, where
the Pallas kernel divides: a difference of at most one f32 ulp against the
JAX package, well inside the parity tests' 1e-3. The two therefore agree
to the bit on the card, and the Pallas kernel's dense (out, in) weight
matrices — a TPU device for gathers — are not carried over.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from medical_image_segmentation_tpu_torch.core.profiling import span
from medical_image_segmentation_tpu_torch.ops.augment import LUMA, ViewConfig, keep_rows, sample_rrc_window

PARAMS_PER_VIEW = 11
N_PARAMS = 24

# ViewConfig fields the kernel implements or that carry its parameters.
# Every OTHER field must be at its inert value, or the config takes the
# plain ops/augment.py path: an enabled augmentation silently dropped is a
# correctness bug (pallas_augment.py:131-164).
_IMPLEMENTED_FIELDS = {
    "out_size", "crop_scale", "crop_ratio", "hflip_prob",
    "solarize_prob", "solarize_threshold",
    "grayscale_prob",
    "window_prob", "window_level_range", "window_width_range",
    "value_max",
}
_PARAM_ONLY_FIELDS = {"blur_kernel"}
_MUST_BE_ZERO = {"blur_prob", "jitter_prob", "brightness", "contrast", "saturation"}


def fused_supported(cfg: ViewConfig, channels: int = 1) -> bool:
    """True iff the kernel implements EVERY enabled augmentation in ``cfg``.
    Fails safe: a ViewConfig field it does not know returns False."""
    if channels not in (1, 3):
        return False
    for f in dataclasses.fields(cfg):
        if f.name in _IMPLEMENTED_FIELDS or f.name in _PARAM_ONLY_FIELDS:
            continue
        if f.name not in _MUST_BE_ZERO or getattr(cfg, f.name) != 0.0:
            return False
    return True


def sample_view_params(generator: torch.Generator, batch: int, in_h: int, in_w: int,
                       cfg1: ViewConfig, cfg2: ViewConfig) -> torch.Tensor:
    """(B, 24) f32 parameter block on ``generator``'s device, the layout of
    ``pallas_augment.py:109-128``."""

    def coin(p):
        u = torch.rand(batch, generator=generator, device=generator.device)
        return (u < p).float()

    def uniform(lo, hi):
        u = torch.rand(batch, generator=generator, device=generator.device)
        return lo + (hi - lo) * u

    cols = []
    for cfg in (cfg1, cfg2):
        y0, x0, h, w = sample_rrc_window(generator, batch, in_h, in_w, cfg.crop_scale, cfg.crop_ratio)
        flip, sol = coin(cfg.hflip_prob), coin(cfg.solarize_prob)
        thr = torch.full((batch,), cfg.solarize_threshold, device=generator.device)
        gray, win = coin(cfg.grayscale_prob), coin(cfg.window_prob)
        level, width = uniform(*cfg.window_level_range), uniform(*cfg.window_width_range)
        cols += [y0, x0, h, w, flip, sol, thr, gray, win, level, width]
    params = torch.stack(cols, dim=1).float()
    return torch.nn.functional.pad(params, (0, N_PARAMS - params.shape[1]))


def _taps(start, size, in_dim: int, out_dim: int, flip=None):
    """Per output coordinate: low tap, high tap (clamped; its weight is
    exactly 0 when clamped) and the high tap's weight ``fr`` — the
    arithmetic of ``pallas_augment.py:_interp_rows``."""
    pos = torch.arange(out_dim, device=start.device, dtype=torch.float32).view(1, -1) + 0.5
    if flip is not None:
        pos = torch.where(flip.view(-1, 1) > 0.5, out_dim - pos, pos)
    scale = size / torch.full_like(size, out_dim)  # a true division, as in the kernel
    src = (start.view(-1, 1) + pos * scale.view(-1, 1) - 0.5).clamp(0.0, in_dim - 1)
    lo = torch.floor(src)
    fr = src - lo
    lo_i = lo.long()
    return lo_i, (lo_i + 1).clamp(max=in_dim - 1), fr


def two_view_augment_reference(
    params: torch.Tensor,          # (B, 24) f32
    images: torch.Tensor,          # (B, H, W, C) or (B, H, W), uint8 or uint16
    out_size: Tuple[int, int],
    mean: Tuple[float, ...],
    std: Tuple[float, ...],
    value_max: float = 255.0,
    dtype=torch.bfloat16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, on any device."""
    if images.ndim == 3:
        images = images.unsqueeze(-1)
    b, in_h, in_w, c = images.shape
    oh, ow = out_size
    img = images.float()
    bidx = torch.arange(b, device=images.device).view(-1, 1)
    mean_t = torch.tensor(mean, dtype=torch.float32, device=images.device)
    std_t = torch.tensor(std, dtype=torch.float32, device=images.device)
    inv_std = torch.ones_like(std_t) / std_t  # 1/std rounded once, as the kernel's launch makes it
    views = []
    for view in range(2):
        p = params[:, view * PARAMS_PER_VIEW:(view + 1) * PARAMS_PER_VIEW].float()
        y0, x0, ch, cw, flip, sol, thr, gray, win, level, width = p.unbind(1)
        ly, hy, fy = _taps(y0, ch, in_h, oh)
        lx, hx, fx = _taps(x0, cw, in_w, ow, flip)
        # rows first: (B, oh, W, C); then columns: (B, oh, ow, C)
        fy4 = fy.view(b, oh, 1, 1)
        rows = (1.0 - fy4) * img[bidx, ly] + fy4 * img[bidx, hy]
        fx4 = fx.view(b, 1, ow, 1)

        def cols(idx):
            return torch.gather(rows, 2, idx.view(b, 1, ow, 1).expand(b, oh, ow, c))

        x = (1.0 - fx4) * cols(lx) + fx4 * cols(hx)
        if c == 3:
            luma = LUMA[0] * x[..., 0] + LUMA[1] * x[..., 1] + LUMA[2] * x[..., 2]
            x = torch.where(gray.view(-1, 1, 1, 1) > 0.5, luma.unsqueeze(-1).expand_as(x), x)
        wlo = (level - width * 0.5).view(-1, 1, 1, 1)
        # tensor / tensor: a Python scalar divisor (or dividend) makes
        # PyTorch multiply by a reciprocal, which the kernel does not do
        wscale = (torch.full_like(width, value_max) / width).view(-1, 1, 1, 1)
        rewin = ((x - wlo) * wscale).clamp(0.0, value_max)
        x = torch.where(win.view(-1, 1, 1, 1) > 0.5, rewin, x)
        x = torch.where((sol.view(-1, 1, 1, 1) > 0.5) & (x >= thr.view(-1, 1, 1, 1)), value_max - x, x)
        views.append(((x - mean_t) * inv_std).to(dtype))
    return views[0], views[1]


def _check_configs(channels: int, cfg1: ViewConfig, cfg2: ViewConfig, mean, std):
    if channels not in (1, 3):
        raise ValueError(f"fused augment kernel supports 1 or 3 channels, got {channels}")
    for cfg in (cfg1, cfg2):
        if not fused_supported(cfg, channels):
            raise ValueError(
                f"view config enables augmentations the fused kernel does not implement "
                f"({cfg}); route through ops.augment.two_view_augment")
    if len(mean) != channels or len(std) != channels:
        raise ValueError(f"mean/std must have {channels} entries")
    if cfg1.out_size != cfg2.out_size:
        raise ValueError("both views must share out_size in the fused kernel")
    if cfg1.value_max != cfg2.value_max:
        raise ValueError("both views must share value_max in the fused kernel")


_IN_CODES = {torch.uint8: 0, torch.uint16: 1}
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _launch(params, images, out_size, mean, std, value_max, dtype, lib=None):
    """Launch ``mis_two_view_augment`` on the current CUDA stream. ``lib``
    is another build of the same C interface (an A/B timing); by default
    the library built from ``csrc/two_view_augment.cu``."""
    from medical_image_segmentation_tpu_torch.ops._kernels import load_kernel_library

    if images.dtype not in _IN_CODES:
        raise TypeError(f"kernel takes uint8 or uint16 images, got {images.dtype}")
    if dtype not in _OUT_CODES:
        raise TypeError(f"kernel writes float32 or bfloat16, got {dtype}")
    b, in_h, in_w, c = images.shape
    oh, ow = out_size
    if not (params.is_cuda and params.device == images.device):
        raise ValueError("params must lie on the images' CUDA device")
    if params.dtype != torch.float32 or tuple(params.shape) != (b, N_PARAMS):
        raise ValueError(f"params must be ({b}, {N_PARAMS}) float32, got {tuple(params.shape)} {params.dtype}")
    if not (1 <= b <= 65535 and oh >= 1 and ow >= 1):
        raise ValueError(f"batch must be in [1, 65535] and out_size positive, got {b}, {out_size}")
    # the kernel copies 16-byte chunks: a view into another tensor may start off that grid
    images, params = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (images.contiguous(), params.contiguous()))
    v1 = torch.empty((b, oh, ow, c), dtype=dtype, device=images.device)
    v2 = torch.empty_like(v1)
    ms = [float(m) for m in mean] + [0.0] * (3 - c)
    ss = [float(s) for s in std] + [1.0] * (3 - c)
    lib = lib or load_kernel_library("two_view_augment")
    err = lib.mis_two_view_augment(
        images.data_ptr(), params.data_ptr(), v1.data_ptr(), v2.data_ptr(),
        b, in_h, in_w, c, oh, ow, _IN_CODES[images.dtype], _OUT_CODES[dtype],
        float(value_max), *ms, *ss, torch.cuda.current_stream(images.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"two_view_augment kernel launch failed: CUDA error {err}")
    fused_two_view_augment.launches += 1
    return v1, v2


def kernel_plan(in_h: int, in_w: int, channels: int, out_size: Tuple[int, int], in_dtype=torch.uint8) -> dict:
    """How the kernel cuts this shape: output rows per work item (``band``),
    items per sample, source rows staged per view (``rows_cap``) and the
    dynamic shared memory of a block. Builds the kernel library."""
    import ctypes

    from medical_image_segmentation_tpu_torch.ops._kernels import load_kernel_library

    out = [ctypes.c_int() for _ in range(4)]
    err = load_kernel_library("two_view_augment").mis_two_view_augment_plan(
        in_h, in_w, channels, out_size[0], out_size[1], _IN_CODES[in_dtype], *(ctypes.byref(o) for o in out))
    if err != 0:
        raise ValueError(f"two_view_augment cannot plan {(in_h, in_w, channels)} -> {out_size}: CUDA error {err}")
    return dict(zip(("band", "n_bands", "rows_cap", "smem_bytes"), (o.value for o in out)))


def touched_input_bytes(params: torch.Tensor, in_shape, elem_size: int, out_size: Tuple[int, int],
                        sector: int = 32) -> int:
    """Bytes of the (B, H, W, C) image tensor that the two views' bilinear
    taps read under this parameter block, counted in whole ``sector``-byte
    sectors (the unit in which the card reads device memory): what these
    inputs need, against the whole tensor's ``B*H*W*C*elem_size``."""
    b, in_h, in_w, c = in_shape
    oh, ow = out_size
    dev = params.device
    touched = torch.zeros(b, in_h, in_w, dtype=torch.bool, device=dev)
    for view in range(2):
        p = params[:, view * PARAMS_PER_VIEW:(view + 1) * PARAMS_PER_VIEW].float()
        ly, hy, _ = _taps(p[:, 0], p[:, 2], in_h, oh)
        lx, hx, _ = _taps(p[:, 1], p[:, 3], in_w, ow, p[:, 4])
        rows = torch.zeros(b, in_h, dtype=torch.bool, device=dev)
        cols = torch.zeros(b, in_w, dtype=torch.bool, device=dev)
        for m, idx in ((rows, ly), (rows, hy), (cols, lx), (cols, hx)):
            m.scatter_(1, idx, True)
        touched |= rows[:, :, None] & cols[:, None, :]
    pix = c * elem_size
    start = touched.flatten().nonzero().squeeze(1) * pix
    sectors = torch.unique(torch.cat([start // sector, (start + pix - 1) // sector]))
    return int(sectors.numel()) * sector


def fused_two_view_augment(
    images: torch.Tensor,
    cfg1: ViewConfig,
    cfg2: ViewConfig,
    mean: Tuple[float, ...] = (57.9764,),
    std: Tuple[float, ...] = (60.4759,),
    dtype=torch.bfloat16,
    generator: Optional[torch.Generator] = None,
    params: Optional[torch.Tensor] = None,
    shard: Tuple[int, int] = (0, 1),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both views of ``images`` (B,H,W,C) or (B,H,W), uint8 or uint16, as
    two (B, oh, ow, C) tensors in ``dtype``.

    On a CUDA tensor this launches the hand-written kernel, and raises if
    it cannot; on a CPU tensor it runs ``two_view_augment_reference``.
    ``params`` injects a (B, 24) block (the tests pass JAX's); otherwise it
    is drawn from ``generator``: for the global batch under ``shard =
    (index, count)``, of which this data rank keeps its rows
    (``ops/augment.py::keep_rows``). ``fused_two_view_augment.launches``
    counts kernel launches. Under a profiler the call is an ``augment``
    span (``core/profiling.py``)."""
    with span("augment"):
        if images.ndim == 3:
            images = images.unsqueeze(-1)
        b, in_h, in_w, c = images.shape
        _check_configs(c, cfg1, cfg2, mean, std)
        if params is None:
            if generator is None:
                raise ValueError("pass a generator or a params block")
            params = keep_rows(sample_view_params(generator, b * shard[1], in_h, in_w, cfg1, cfg2), shard)
        args = (params, images, cfg1.out_size, tuple(mean), tuple(std), float(cfg1.value_max), dtype)
        if images.is_cuda:
            return _launch(*args)
        if images.device.type == "cpu":
            return two_view_augment_reference(*args)
        raise RuntimeError(f"no two_view_augment implementation for device {images.device}")


fused_two_view_augment.launches = 0
