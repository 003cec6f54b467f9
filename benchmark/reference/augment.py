"""The two-view augmentation, worked out again for the benchmark's reference.

Frozen copies, so that a later change to the program cannot move the
yardstick:

- ``sample_view_params`` with ``sample_rrc_window``: the draws of
  ``medical_image_segmentation_tpu_torch/ops/fused_augment.py::sample_view_params``
  and ``ops/augment.py::sample_rrc_window`` as they stood when the benchmark
  was defined. The same calls on a ``torch.Generator`` of the same device
  and seed give the same numbers, so the reference redraws what the
  program drew without reading it.
- ``two_view_views``: ``ops/fused_augment.py::two_view_augment_reference``,
  the plain statement of the kernel's function (bilinear crop with the flip
  folded in, the CT window, solarize, normalize; every product and sum
  rounded on its own), in float32.

A view config is a plain dict (``view_configs`` builds both from a
configuration file's ``views`` block).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

PARAMS_PER_VIEW = 11
N_PARAMS = 24
LUMA = (0.299, 0.587, 0.114)


def view_configs(cfg: dict) -> Tuple[Dict, Dict]:
    """The two views of a configuration's ``views`` block: shared crop
    geometry, per-view solarize probability."""
    v = cfg["views"]
    common = {"out_size": (cfg["crop_size"], cfg["crop_size"]), "crop_scale": tuple(v["crop_scale"]),
              "crop_ratio": tuple(v["crop_ratio"]), "hflip_prob": v["hflip_prob"],
              "grayscale_prob": v["grayscale_prob"], "solarize_threshold": v["solarize_threshold"],
              "window_prob": v["window_prob"], "window_level_range": tuple(v["window_level_range"]),
              "window_width_range": tuple(v["window_width_range"]), "value_max": v["value_max"]}
    return tuple({**common, "solarize_prob": p} for p in v["solarize_prob"])


def _uniform(generator: torch.Generator, n: int, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    u = torch.rand(n, generator=generator, device=generator.device, dtype=torch.float32)
    return lo + (hi - lo) * u


def sample_rrc_window(generator, batch: int, in_h: int, in_w: int, scale, ratio):
    area = in_h * in_w * _uniform(generator, batch, scale[0], scale[1])
    aspect = torch.exp(_uniform(generator, batch, math.log(ratio[0]), math.log(ratio[1])))
    w = torch.sqrt(area * aspect).clamp(1.0, float(in_w))
    h = torch.sqrt(area / aspect).clamp(1.0, float(in_h))
    y0 = _uniform(generator, batch) * (in_h - h)
    x0 = _uniform(generator, batch) * (in_w - w)
    return y0, x0, h, w


def sample_view_params(generator: torch.Generator, batch: int, in_h: int, in_w: int,
                       cfg1: Dict, cfg2: Dict) -> torch.Tensor:
    """(B, 24) float32 draws of both views, in the kernel's layout."""

    def coin(p):
        return (torch.rand(batch, generator=generator, device=generator.device) < p).float()

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(batch, generator=generator, device=generator.device)

    cols = []
    for cfg in (cfg1, cfg2):
        y0, x0, h, w = sample_rrc_window(generator, batch, in_h, in_w, cfg["crop_scale"], cfg["crop_ratio"])
        flip, sol = coin(cfg["hflip_prob"]), coin(cfg["solarize_prob"])
        thr = torch.full((batch,), cfg["solarize_threshold"], device=generator.device)
        gray, win = coin(cfg["grayscale_prob"]), coin(cfg["window_prob"])
        level, width = uniform(*cfg["window_level_range"]), uniform(*cfg["window_width_range"])
        cols += [y0, x0, h, w, flip, sol, thr, gray, win, level, width]
    params = torch.stack(cols, dim=1).float()
    return torch.nn.functional.pad(params, (0, N_PARAMS - params.shape[1]))


def _taps(start, size, in_dim: int, out_dim: int, flip=None):
    pos = torch.arange(out_dim, device=start.device, dtype=torch.float32).view(1, -1) + 0.5
    if flip is not None:
        pos = torch.where(flip.view(-1, 1) > 0.5, out_dim - pos, pos)
    scale = size / torch.full_like(size, out_dim)
    src = (start.view(-1, 1) + pos * scale.view(-1, 1) - 0.5).clamp(0.0, in_dim - 1)
    lo = torch.floor(src)
    fr = src - lo
    lo_i = lo.long()
    return lo_i, (lo_i + 1).clamp(max=in_dim - 1), fr


def two_view_views(params: torch.Tensor, images: torch.Tensor, out_size, mean, std,
                   value_max: float = 255.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both (B, oh, ow, C) float32 views of (B, H, W, C) integer images
    under the (B, 24) draws ``params``."""
    if images.ndim == 3:
        images = images.unsqueeze(-1)
    b, in_h, in_w, c = images.shape
    oh, ow = out_size
    img = images.float()
    bidx = torch.arange(b, device=images.device).view(-1, 1)
    mean_t = torch.tensor(mean, dtype=torch.float32, device=images.device)
    std_t = torch.tensor(std, dtype=torch.float32, device=images.device)
    inv_std = torch.ones_like(std_t) / std_t
    views = []
    for view in range(2):
        p = params[:, view * PARAMS_PER_VIEW:(view + 1) * PARAMS_PER_VIEW].float()
        y0, x0, ch, cw, flip, sol, thr, gray, win, level, width = p.unbind(1)
        ly, hy, fy = _taps(y0, ch, in_h, oh)
        lx, hx, fx = _taps(x0, cw, in_w, ow, flip)
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
        wscale = (torch.full_like(width, value_max) / width).view(-1, 1, 1, 1)
        rewin = ((x - wlo) * wscale).clamp(0.0, value_max)
        x = torch.where(win.view(-1, 1, 1, 1) > 0.5, rewin, x)
        x = torch.where((sol.view(-1, 1, 1, 1) > 0.5) & (x >= thr.view(-1, 1, 1, 1)), value_max - x, x)
        views.append((x - mean_t) * inv_std)
    return views[0], views[1]
