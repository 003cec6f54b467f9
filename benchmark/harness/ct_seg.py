"""CT-like slices with liver masks, and CT-like volumes with liver and
tumour label maps, from a seed, made on the device in bulk.

A slice: the texture of ``harness/ct_like.py`` (``0.3 + 0.25·sin·cos``
with a frequency and phase of its own, Gaussian noise of σ 0.01) inside a
body ellipse on air (0), and a liver ellipse a little brighter, which is
the mask; uint8 0..255 as a slice store holds it.

A volume (D, H, W) on the 0..1 scale, as ``data/volumes.py`` min-max
normalizes a Decathlon CT: the same texture in three dimensions inside a
body ellipsoid, a brighter liver ellipsoid (label 1) and inside it a darker
tumour ellipsoid at its centre (label 2); the labels uint8.
"""

from __future__ import annotations

import math

import torch


def _texture(r: torch.Tensor, coords, k: int) -> torch.Tensor:
    """``0.3 + 0.25·Π sin/cos`` over the coordinates, with the frequencies
    and phases of the uniform draws ``r[:, k:k + 2·len(coords)]``."""
    n = r.shape[0]
    out = torch.full((), 0.25, device=r.device)
    for a, c in enumerate(coords):
        f = (20.0 + 14.0 * r[:, k + 2 * a]).view(n, *([1] * len(coords)))
        p = (2 * math.pi * r[:, k + 2 * a + 1]).view(n, *([1] * len(coords)))
        out = out * (torch.sin if a % 2 == 0 else torch.cos)(c / f + p)
    return 0.3 + out


def _ellipsoid(r: torch.Tensor, coords, sizes, k: int, centre, radius, rk=None) -> torch.Tensor:
    """Masks of ellipsoids whose centre and radii (shares of each size) are
    ``centre[0] + centre[1]·u`` and ``radius[0] + radius[1]·u`` of the
    uniform draws from column ``k`` on (the radii's from ``rk``, by default
    the next columns)."""
    n, dims = r.shape[0], len(coords)
    rk = k + dims if rk is None else rk
    acc = 0.0
    for a, (c, s) in enumerate(zip(coords, sizes)):
        mid = (centre[0] + centre[1] * r[:, k + a]).view(n, *([1] * dims)) * s
        rad = (radius[0] + radius[1] * r[:, rk + a]).view(n, *([1] * dims)) * s
        acc = acc + ((c - mid) / rad) ** 2
    return acc <= 1.0


def _axes(shape, device):
    axes = [torch.arange(s, device=device, dtype=torch.float32) for s in shape]
    return [a.view(1, *[-1 if i == j else 1 for j in range(len(shape))]) for i, a in enumerate(axes)]


def slices_with_masks(n: int, size: int, generator: torch.Generator):
    """(n, size, size, 1) uint8 slices and their (n, size, size, 1) uint8
    0/1 liver masks, on ``generator``'s device."""
    dev = generator.device
    r = torch.rand(n, 16, generator=generator, device=dev)
    coords = _axes((size, size), dev)
    body = _ellipsoid(r, coords, (size, size), 4, (0.5, 0.0), (0.36, 0.1))
    liver = _ellipsoid(r, coords, (size, size), 8, (0.38, 0.24), (0.1, 0.16)) & body
    img = torch.where(body, _texture(r, coords, 0) + 0.15 * liver, torch.zeros((), device=dev))
    img = img + 0.01 * torch.randn(n, size, size, generator=generator, device=dev)
    img = (img.clamp(0.0, 1.0) * 255.0).to(torch.uint8).unsqueeze(-1)
    return img, liver.to(torch.uint8).unsqueeze(-1)


def volumes_with_labels(n: int, shape, generator: torch.Generator):
    """(n, D, H, W, 1) f32 volumes on 0..1 and their (n, D, H, W, 1) uint8
    label maps (0 background, 1 liver, 2 tumour), on ``generator``'s
    device; made one volume at a time, so the temporaries stay one
    volume's."""
    dev = generator.device
    r = torch.rand(n, 24, generator=generator, device=dev)
    coords = _axes(tuple(shape), dev)
    vols = torch.empty(n, *shape, 1, device=dev)
    labels = torch.empty(n, *shape, 1, dtype=torch.uint8, device=dev)
    for i in range(n):
        ri = r[i:i + 1]
        body = _ellipsoid(ri, coords, shape, 6, (0.5, 0.0), (0.4, 0.08))
        liver = _ellipsoid(ri, coords, shape, 12, (0.4, 0.2), (0.18, 0.12)) & body
        tumour = _ellipsoid(ri, coords, shape, 12, (0.4, 0.2), (0.05, 0.05), rk=18) & liver  # at the liver's centre
        img = torch.where(body, _texture(ri, coords, 0) + 0.15 * liver - 0.2 * tumour, torch.zeros((), device=dev))
        img = img + 0.01 * torch.randn(1, *shape, generator=generator, device=dev)
        vols[i, ..., 0] = img[0].clamp(0.0, 1.0)
        labels[i, ..., 0] = (liver.to(torch.uint8) + tumour.to(torch.uint8))[0]
    return vols, labels
