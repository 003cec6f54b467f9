"""CT-like grayscale slices from a seed.

The smooth texture of ``tools/bench_loader_torch.py::write_synthetic_store``
(``0.3 + 0.25·sin(y/30)·cos(x/25)`` plus Gaussian noise of σ 0.01, clipped
to [0, 1], scaled to uint8), given what a CT slice has besides: a body
ellipse on air (0), and inside it two organ ellipses a little brighter or
darker, each image with a frequency, phase, placement and size of its own,
so that the rows of a batch all differ. The edges matter to the
networks: a slice that is all smooth texture gives some first-layer
channels a large mean and almost no variance, which no real slice does.
"""

from __future__ import annotations

import math

import torch


def _ellipse(y, x, r, k: int, size: int):
    """(n, size, size) masks of ellipses whose centre and radii are the
    columns ``k..k+3`` of the uniform draws ``r``."""
    n = r.shape[0]
    cy = (0.35 + 0.3 * r[:, k]).view(n, 1, 1) * size
    cx = (0.35 + 0.3 * r[:, k + 1]).view(n, 1, 1) * size
    ry = (0.12 + 0.3 * r[:, k + 2]).view(n, 1, 1) * size
    rx = (0.12 + 0.3 * r[:, k + 3]).view(n, 1, 1) * size
    return ((y - cy) / ry) ** 2 + ((x - cx) / rx) ** 2 <= 1.0


def ct_like(n: int, size: int, generator: torch.Generator) -> torch.Tensor:
    """(n, size, size, 1) uint8 on ``generator``'s device."""
    dev = generator.device
    r = torch.rand(n, 16, generator=generator, device=dev)
    fy = (24.0 + 12.0 * r[:, 0]).view(n, 1, 1)
    fx = (20.0 + 10.0 * r[:, 1]).view(n, 1, 1)
    py = (2 * math.pi * r[:, 2]).view(n, 1, 1)
    px = (2 * math.pi * r[:, 3]).view(n, 1, 1)
    axis = torch.arange(size, device=dev, dtype=torch.float32)
    y, x = axis.view(1, -1, 1), axis.view(1, 1, -1)
    tissue = 0.3 + 0.25 * torch.sin(y / fy + py) * torch.cos(x / fx + px)
    body = ((y - size / 2) / (size * (0.36 + 0.1 * r[:, 4].view(n, 1, 1)))) ** 2 + \
        ((x - size / 2) / (size * (0.4 + 0.08 * r[:, 5].view(n, 1, 1)))) ** 2 <= 1.0
    for k, level in ((6, 0.2 * r[:, 14]), (10, -0.15 * r[:, 15])):
        tissue = tissue + _ellipse(y, x, r, k, size) * level.view(n, 1, 1)
    noise = torch.randn(n, size, size, generator=generator, device=dev) * 0.01
    img = torch.where(body, tissue, torch.zeros_like(tissue)) + noise
    return (img.clamp(0.0, 1.0) * 255.0).to(torch.uint8).unsqueeze(-1)
