"""Two-view SSL augmentation and the paired segmentation pipeline, in plain
PyTorch.

Port of ``medical_image_segmentation_tpu/ops/augment.py``: the BYOL half
(``ViewConfig``, the canonical view configs, RandomResizedCrop sampling, the
separable resample matrices, Gaussian blur, the elementwise tail and
``two_view_augment``) and the segmentation half (``_nearest_matrix``,
``segmentation_augment``, ``parse_hu_windows``, ``apply_hu_windows``). Same
math, same NHWC tensors at the public functions; ``jax.random`` keys become
one explicit ``torch.Generator``.

This is the path for configs the fused kernel refuses (the torchvision
recipe with blur and ColorJitter, see ``ops/fused_augment.py::fused_supported``)
and, for now, for uint16 stores in the trainer. It is not a fallback: the
routing is the JAX trainer's own (``train/train_ssl.py:263-294``).

Random draws are separated from the math: ``sample_view_draws`` makes every
random number one view needs, ``apply_view`` is deterministic given them;
``sample_segmentation_draws`` and ``apply_segmentation`` split the paired
pipeline the same way. The tests feed the ``apply_*`` functions the draws
that the JAX code makes from its keys, so the two packages are compared on
identical randomness.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

# ITU-R BT.601 luma weights (ops/augment.py:249,255 of the JAX package).
LUMA = (0.299, 0.587, 0.114)


@dataclasses.dataclass(frozen=True)
class ViewConfig:
    """Augmentation parameters for one SSL view — field for field the JAX
    ``ViewConfig`` (``ops/augment.py:131-164``); see there for the reference
    recipe each field comes from."""

    out_size: Tuple[int, int] = (112, 112)
    crop_scale: Tuple[float, float] = (0.08, 1.0)
    crop_ratio: Tuple[float, float] = (0.75, 4.0 / 3.0)
    hflip_prob: float = 0.5
    grayscale_prob: float = 0.2
    solarize_prob: float = 0.0
    solarize_threshold: float = 128.0
    blur_prob: float = 0.0
    blur_kernel: int = 23
    jitter_prob: float = 0.0
    brightness: float = 0.0
    contrast: float = 0.0
    saturation: float = 0.0
    window_prob: float = 0.0
    window_level_range: Tuple[float, float] = (96.0, 160.0)
    window_width_range: Tuple[float, float] = (128.0, 255.0)
    value_max: float = 255.0


# FFCV-pipeline parity: solarize only on view 2, no blur/jitter.
BYOL_VIEW1 = ViewConfig(solarize_prob=0.0)
BYOL_VIEW2 = ViewConfig(solarize_prob=0.2)

# torchvision-pipeline parity: ColorJitter(0.4,0.4,0.2)@0.8, GaussianBlur
# (k=23)@(1.0, 0.1), Solarize@(0.0, 0.2). The fused kernel refuses these.
BYOL_TV_VIEW1 = ViewConfig(blur_prob=1.0, jitter_prob=0.8, brightness=0.4, contrast=0.4,
                           saturation=0.2, solarize_prob=0.0)
BYOL_TV_VIEW2 = ViewConfig(blur_prob=0.1, jitter_prob=0.8, brightness=0.4, contrast=0.4,
                           saturation=0.2, solarize_prob=0.2)


def _uniform(generator: torch.Generator, n: int, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    u = torch.rand(n, generator=generator, device=generator.device, dtype=torch.float32)
    return lo + (hi - lo) * u


def sample_rrc_window(generator: torch.Generator, batch: int, in_h: int, in_w: int,
                      scale: Tuple[float, float] = (0.08, 1.0),
                      ratio: Tuple[float, float] = (0.75, 4.0 / 3.0)):
    """RandomResizedCrop windows, sampled once and clamped to the image
    (``ops/augment.py:101-128``): returns ``(y0, x0, h, w)``, each (B,) f32."""
    area = in_h * in_w * _uniform(generator, batch, scale[0], scale[1])
    aspect = torch.exp(_uniform(generator, batch, math.log(ratio[0]), math.log(ratio[1])))
    w = torch.sqrt(area * aspect).clamp(1.0, float(in_w))
    h = torch.sqrt(area / aspect).clamp(1.0, float(in_h))
    y0 = _uniform(generator, batch) * (in_h - h)
    x0 = _uniform(generator, batch) * (in_w - w)
    return y0, x0, h, w


def _resize_matrix(start: torch.Tensor, size: torch.Tensor, in_dim: int, out_dim: int,
                   dtype=torch.float32) -> torch.Tensor:
    """(B, out_dim, in_dim) two-tap bilinear weights for the crop
    [start, start+size) resized to out_dim, half-pixel centres, source
    coordinate clamped to [0, in_dim-1] (``ops/augment.py:49-71``)."""
    scale = size / out_dim
    i = torch.arange(out_dim, device=start.device, dtype=torch.float32).view(1, -1, 1)
    src = (start.view(-1, 1, 1) + (i + 0.5) * scale.view(-1, 1, 1) - 0.5).clamp(0.0, in_dim - 1)
    lo = torch.floor(src)
    frac = src - lo
    k = torch.arange(in_dim, device=start.device, dtype=torch.float32).view(1, 1, -1)
    w = (k == lo) * (1.0 - frac) + (k == lo + 1.0) * frac
    return w.to(dtype)


def _nearest_matrix(start: torch.Tensor, size: torch.Tensor, in_dim: int, out_dim: int,
                    dtype=torch.float32) -> torch.Tensor:
    """(B, out_dim, in_dim) one-hot nearest-neighbour rows, for masks: the
    source of output i is ``round((i+0.5)·scale − 0.5)``, half to even,
    clamped to the image (``ops/augment.py:74-82``). ``F.interpolate``'s
    ``nearest`` takes ``floor(i·scale)`` and would move masks by a pixel."""
    scale = size / out_dim
    i = torch.arange(out_dim, device=start.device, dtype=torch.float32).view(1, -1, 1)
    src = torch.round(start.view(-1, 1, 1) + (i + 0.5) * scale.view(-1, 1, 1) - 0.5).clamp(0.0, in_dim - 1)
    k = torch.arange(in_dim, device=start.device, dtype=torch.float32).view(1, 1, -1)
    return (k == src).to(dtype)


def _flip_cols(r_x: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Fold a per-sample horizontal flip into R_x by reversing its output
    rows where ``flip`` is set (``ops/augment.py:85-89``)."""
    return torch.where(flip.view(-1, 1, 1), r_x.flip(1), r_x)


def apply_resample(img: torch.Tensor, r_y: torch.Tensor, r_x: torch.Tensor) -> torch.Tensor:
    """Batched separable resample (B,H,W,C) → (B,h,w,C), computed in
    ``r_y.dtype`` (``ops/augment.py:92-98``)."""
    img = img.to(r_y.dtype)
    tmp = torch.einsum("boh,bhwc->bowc", r_y, img)
    return torch.einsum("bpw,bowc->bopc", r_x, tmp)


def _blur_matrix(sigma: torch.Tensor, coin: torch.Tensor, dim: int, kernel: int, dtype) -> torch.Tensor:
    """Per-sample Gaussian blur as a (B, dim, dim) Toeplitz matrix, the
    identity where the coin is off (``ops/augment.py:183-197``)."""
    half = kernel // 2
    idx = torch.arange(dim, device=sigma.device, dtype=torch.float32)
    d = (idx.view(1, 1, -1) - idx.view(1, -1, 1))
    g = torch.exp(-(d * d) / (2.0 * sigma.view(-1, 1, 1) ** 2))
    g = torch.where(d.abs() <= half, g, torch.zeros((), device=g.device))
    g = g / g.sum(dim=2, keepdim=True)
    eye = torch.eye(dim, device=sigma.device, dtype=torch.float32).unsqueeze(0)
    return torch.where(coin.view(-1, 1, 1), g, eye).to(dtype)


def sample_view_draws(generator: torch.Generator, batch: int, in_h: int, in_w: int,
                      channels: int, cfg: ViewConfig) -> Dict[str, torch.Tensor]:
    """Every random number one view of ``cfg`` needs, each (B,). Only the
    augmentations that ``cfg`` enables draw, as in the JAX ``augment_view``."""
    d: Dict[str, torch.Tensor] = {}
    d["y0"], d["x0"], d["h"], d["w"] = sample_rrc_window(
        generator, batch, in_h, in_w, cfg.crop_scale, cfg.crop_ratio)
    d["flip"] = _uniform(generator, batch) < cfg.hflip_prob
    if cfg.blur_prob > 0.0:
        for axis in ("y", "x"):
            d[f"blur_sigma_{axis}"] = _uniform(generator, batch, 0.1, 2.0)
            d[f"blur_coin_{axis}"] = _uniform(generator, batch) < cfg.blur_prob
    if cfg.jitter_prob > 0.0:
        d["jitter_on"] = (_uniform(generator, batch) < cfg.jitter_prob).float()
        for name in ("brightness", "contrast", "saturation"):
            amount = getattr(cfg, name)
            if amount > 0 and (name != "saturation" or channels == 3):
                d[name] = _uniform(generator, batch, 1 - amount, 1 + amount)
    if cfg.grayscale_prob > 0.0 and channels == 3:
        d["gray"] = _uniform(generator, batch) < cfg.grayscale_prob
    if cfg.window_prob > 0.0:
        d["window_on"] = _uniform(generator, batch) < cfg.window_prob
        d["level"] = _uniform(generator, batch, *cfg.window_level_range)
        d["width"] = _uniform(generator, batch, *cfg.window_width_range)
    if cfg.solarize_prob > 0.0:
        d["solarize"] = _uniform(generator, batch) < cfg.solarize_prob
    return d


def _elementwise_tail(draws: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ViewConfig,
                      mean: Sequence[float], std: Sequence[float], dtype) -> torch.Tensor:
    """Jitter → grayscale → CT window → solarize → normalize on the
    resampled f32 view (``ops/augment.py:228-275``)."""
    c = x.shape[-1]

    def col(name):
        return draws[name].view(-1, 1, 1, 1)

    if cfg.jitter_prob > 0.0:
        on = col("jitter_on")
        if cfg.brightness > 0:
            x = x * (1.0 + on * (col("brightness") - 1.0))
        if cfg.contrast > 0:
            m = x.mean(dim=(1, 2, 3), keepdim=True)
            x = torch.where(on > 0, m + col("contrast") * (x - m), x)
        if cfg.saturation > 0 and c == 3:
            gray = (x * x.new_tensor(LUMA)).sum(dim=-1, keepdim=True)
            x = torch.where(on > 0, gray + col("saturation") * (x - gray), x)
        x = x.clamp(0.0, cfg.value_max)

    if cfg.grayscale_prob > 0.0 and c == 3:
        gray = (x * x.new_tensor(LUMA)).sum(dim=-1, keepdim=True)
        x = torch.where(col("gray"), gray.expand_as(x), x)

    if cfg.window_prob > 0.0:
        level, width = col("level"), col("width")
        lo = level - width / 2.0
        rewin = ((x - lo) / width * cfg.value_max).clamp(0.0, cfg.value_max)
        x = torch.where(col("window_on"), rewin, x)

    if cfg.solarize_prob > 0.0:
        x = torch.where(col("solarize") & (x >= cfg.solarize_threshold), cfg.value_max - x, x)

    mean_t = torch.tensor(mean, dtype=torch.float32, device=x.device).view(1, 1, 1, -1)
    std_t = torch.tensor(std, dtype=torch.float32, device=x.device).view(1, 1, 1, -1)
    return ((x - mean_t) / std_t).to(dtype)


def apply_view(draws: Dict[str, torch.Tensor], images: torch.Tensor, cfg: ViewConfig,
               mean: Sequence[float], std: Sequence[float], dtype=torch.bfloat16) -> torch.Tensor:
    """One augmented, normalized view (B, out_h, out_w, C) of NHWC
    ``images`` from the given draws (``ops/augment.py:200-225``). The
    resample matrices are built in ``dtype``, as in the JAX path."""
    _, in_h, in_w, _ = images.shape
    out_h, out_w = cfg.out_size
    r_y = _resize_matrix(draws["y0"], draws["h"], in_h, out_h, dtype)
    r_x = _flip_cols(_resize_matrix(draws["x0"], draws["w"], in_w, out_w, dtype), draws["flip"])
    if cfg.blur_prob > 0.0:
        # blur after the resize, on the small view: two more tiny matmuls
        r_y = torch.bmm(_blur_matrix(draws["blur_sigma_y"], draws["blur_coin_y"], out_h,
                                     cfg.blur_kernel, dtype), r_y)
        r_x = torch.bmm(_blur_matrix(draws["blur_sigma_x"], draws["blur_coin_x"], out_w,
                                     cfg.blur_kernel, dtype), r_x)
    x = apply_resample(images, r_y, r_x).float()
    return _elementwise_tail(draws, x, cfg, mean, std, dtype)


def augment_view(generator: torch.Generator, images: torch.Tensor, cfg: ViewConfig,
                 mean: Sequence[float], std: Sequence[float], dtype=torch.bfloat16) -> torch.Tensor:
    """Sample one view's draws from ``generator`` and apply them."""
    b, in_h, in_w, c = images.shape
    return apply_view(sample_view_draws(generator, b, in_h, in_w, c, cfg), images, cfg, mean, std, dtype)


def two_view_augment(
    generator: torch.Generator,
    images: torch.Tensor,                    # (B, H, W, C) uint8/uint16 or float
    cfg1: ViewConfig = BYOL_VIEW1,
    cfg2: ViewConfig = BYOL_VIEW2,
    mean: Tuple[float, ...] = (57.9764,),    # RADIOLOGY_1M train stats
    std: Tuple[float, ...] = (60.4759,),
    dtype=torch.bfloat16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSL two-view pipeline (``ops/augment.py:278-297``): one batch in,
    two independently augmented views out. ``generator`` lives on the
    device of ``images``."""
    v1 = augment_view(generator, images, cfg1, mean, std, dtype)
    v2 = augment_view(generator, images, cfg2, mean, std, dtype)
    return v1, v2


def sample_segmentation_draws(generator: torch.Generator, batch: int) -> Dict[str, torch.Tensor]:
    """The train-time draws of ``segmentation_augment``, each (B,), in the
    JAX key order ``kh, kv, kb, kc`` (``ops/augment.py:393``): horizontal
    and vertical flips at 0.5, brightness and contrast factors in [0.8, 1.2)."""
    return {
        "hflip": _uniform(generator, batch) < 0.5,
        "vflip": _uniform(generator, batch) < 0.5,
        "brightness": _uniform(generator, batch, 0.8, 1.2),
        "contrast": _uniform(generator, batch, 0.8, 1.2),
    }


def apply_segmentation(
    draws: Optional[Dict[str, torch.Tensor]],
    images: torch.Tensor,                    # (B, H, W, 1) uint8 0..255 or float
    masks: torch.Tensor,                     # (B, H, W, 1) binary
    out_size: Tuple[int, int] = (224, 224),
    mean: Sequence[float] = (0.2089,),       # Decathlon liver stats, 0-1 scale
    std: Sequence[float] = (0.2109,),
    value_scale: float = 1.0 / 255.0,
    dtype=torch.bfloat16,
    hu_windows: Sequence[Tuple[float, float]] = (),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The paired image/mask pipeline (``ops/augment.py:353-416``) from the
    given draws; ``draws=None`` is the eval pipeline (no flips, no jitter).

    Resize to ``out_size`` (bilinear for the image, nearest for the mask,
    both as matrices in ``dtype``) with the flips folded into the matrices
    (the vertical one reverses the rows of ``r_y``/``n_y``) → scale to 0..1
    → brightness, clip, contrast around each sample's mean of the clipped
    image, clip → ``apply_hu_windows`` → normalize. Returns the image in
    ``dtype`` and the f32 0/1 mask."""
    b, in_h, in_w, _ = images.shape
    out_h, out_w = out_size
    zeros = torch.zeros(b, device=images.device)
    full_h = torch.full((b,), float(in_h), device=images.device)
    full_w = torch.full((b,), float(in_w), device=images.device)
    r_y = _resize_matrix(zeros, full_h, in_h, out_h, dtype)
    r_x = _resize_matrix(zeros, full_w, in_w, out_w, dtype)
    n_y = _nearest_matrix(zeros, full_h, in_h, out_h, dtype)
    n_x = _nearest_matrix(zeros, full_w, in_w, out_w, dtype)
    if draws is not None:
        r_x, n_x = _flip_cols(r_x, draws["hflip"]), _flip_cols(n_x, draws["hflip"])
        r_y, n_y = _flip_cols(r_y, draws["vflip"]), _flip_cols(n_y, draws["vflip"])

    img = apply_resample(images, r_y, r_x).float() * value_scale
    msk = (apply_resample(masks, n_y, n_x).float() > 0.5).float()
    if draws is not None:
        img = (img * draws["brightness"].view(-1, 1, 1, 1)).clamp(0.0, 1.0)
        m = img.mean(dim=(1, 2, 3), keepdim=True)
        img = (m + draws["contrast"].view(-1, 1, 1, 1) * (img - m)).clamp(0.0, 1.0)

    img = apply_hu_windows(img, hu_windows)
    mean_t = torch.tensor(mean, dtype=torch.float32, device=img.device).view(1, 1, 1, -1)
    std_t = torch.tensor(std, dtype=torch.float32, device=img.device).view(1, 1, 1, -1)
    return ((img - mean_t) / std_t).to(dtype), msk


def segmentation_augment(generator: Optional[torch.Generator], images: torch.Tensor, masks: torch.Tensor,
                         out_size: Tuple[int, int] = (224, 224), mean: Sequence[float] = (0.2089,),
                         std: Sequence[float] = (0.2109,), train: bool = True,
                         value_scale: float = 1.0 / 255.0, dtype=torch.bfloat16,
                         hu_windows: Sequence[Tuple[float, float]] = ()) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample the draws from ``generator`` when ``train`` (eval needs no
    generator) and apply them: the JAX ``segmentation_augment``."""
    draws = sample_segmentation_draws(generator, images.shape[0]) if train else None
    return apply_segmentation(draws, images, masks, out_size, mean, std, value_scale, dtype, hu_windows)


def parse_hu_windows(spec: str, value_max: float = 255.0) -> Tuple[Tuple[float, float], ...]:
    """A CLI windows spec ``"L:W,L:W,…"`` (level:width in stored value
    units) → (level, width) pairs on the 0..1 scale (``ops/augment.py:419-437``)."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            lv, wd = (float(t) for t in part.split(":"))
        except ValueError:
            raise ValueError(f"bad window {part!r}: expected LEVEL:WIDTH") from None
        if wd <= 0:
            raise ValueError(f"bad window {part!r}: width must be > 0")
        out.append((lv / value_max, wd / value_max))
    if not out:
        raise ValueError(f"no windows in spec {spec!r}")
    return tuple(out)


def apply_hu_windows(img: torch.Tensor, hu_windows: Sequence[Tuple[float, float]]) -> torch.Tensor:
    """Fixed (level, width) display windows of a (..., 1) 0..1 image as
    channels: channel c is ``clip((x − (level_c − width_c/2)) / width_c, 0, 1)``
    (``ops/augment.py:440-456``). The image itself when ``hu_windows`` is
    empty."""
    if not hu_windows:
        return img
    lo = torch.tensor([float(lv) - float(wd) / 2.0 for lv, wd in hu_windows], device=img.device)
    width = torch.tensor([float(wd) for _, wd in hu_windows], device=img.device)
    return ((img - lo) / width).clamp(0.0, 1.0)
