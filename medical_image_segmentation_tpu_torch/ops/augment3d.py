"""Paired volumetric augmentation on the device. Port of
``ops/augment3d.py:26-138``.

Train: a random crop to ``out_size``, a flip along each of D, H, W with one
coin per sample and axis shared by image and mask, then brightness and
contrast jitter of the image only (factors in [0.8, 1.2), the contrast
around each sample's mean of the clipped image), display windows,
normalize. Eval: the centre crop, no flips, no jitter.

The random numbers are sampled apart from their use, as in
``ops/augment.py``: ``sample_volume_draws`` makes the crop origins, the
flip coins and the two factors from an explicit ``torch.Generator``, in the
order of the JAX keys ``kcrop, kflip, kb, kc`` (``:62``, ``:101``), and
``apply_*`` takes the draws, so a test can feed another sampler's draws in.
Crop and flips are one gather: the index of output voxel k along an axis
is ``origin + k``, or ``origin + size − 1 − k`` where that axis is flipped,
so nothing is copied twice and no origin comes back to the host.
``shard=(index, count)`` draws for the global batch and keeps a data
rank's rows, as in ``ops/augment.py::keep_rows``. ``depth`` (a slice of
the crop's depth, ``parallel/mesh.py::depth_slab``) keeps a space rank's
depth slab: the mask's gather takes only those indices (under a depth flip
they map to the mirrored source range), and so does the image's at eval;
at train the image is gathered whole, since the contrast jitter turns
around each sample's mean of the whole crop, and cut to the slab right
after that mean. The slab is then the whole pipeline's output cut to the
slab, to the bit.

``labels=True`` takes the mask as an integer label map (nnU-Net's
classes): it is cropped and flipped value for value, not cut at 0.5; the
gather moves values, whatever they are.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from medical_image_segmentation_tpu_torch.ops.augment import (
    Shard, _uniform, apply_hu_windows, device_constant, keep_rows,
)

Draws = Dict[str, torch.Tensor]


def _check_crop(in_dims: Sequence[int], out_size: Sequence[int]) -> None:
    for ax, (i, o) in enumerate(zip(in_dims, out_size)):
        if i < o:
            raise ValueError(f"volume dim {ax} ({i}) smaller than crop ({o}); pad on host")


def sample_volume_draws(generator: torch.Generator, batch: int, in_dims: Sequence[int],
                        out_size: Sequence[int]) -> Draws:
    """The train-time draws of one augmented batch: ``offsets`` (B, 3)
    int64 crop origins, uniform over the valid range on every axis where
    the volume is larger than the crop and centred (nothing drawn) where it
    is equal; ``flips`` (B, 3) bool at 0.5; ``brightness`` and ``contrast``
    (B,) in [0.8, 1.2)."""
    _check_crop(in_dims, out_size)
    device = generator.device
    offsets = []
    for i, o in zip(in_dims, out_size):
        if i > o:
            offsets.append(torch.randint(0, i - o + 1, (batch,), generator=generator, device=device))
        else:
            offsets.append(torch.zeros(batch, dtype=torch.int64, device=device))
    return {
        "offsets": torch.stack(offsets, dim=-1),
        "flips": torch.rand(batch, 3, generator=generator, device=device) < 0.5,
        "brightness": _uniform(generator, batch, 0.8, 1.2),
        "contrast": _uniform(generator, batch, 0.8, 1.2),
    }


def _crop_flip(vols: torch.Tensor, out_size: Sequence[int], draws: Optional[Draws],
               depth: slice = slice(None)) -> torch.Tensor:
    """(B, d, h, w, C) crops of (B, D, H, W, C) ``vols`` at the draws'
    origins with their flips, or the centre crops when ``draws`` is None;
    only the crop depths in ``depth``."""
    b = vols.shape[0]
    index = [torch.arange(b, device=vols.device).view(b, 1, 1, 1)]
    for ax, (i, o) in enumerate(zip(vols.shape[1:4], out_size)):
        k = torch.arange(o, device=vols.device)
        if ax == 0:
            k = k[depth]
        if draws is None:
            idx = ((i - o) // 2 + k).expand(b, len(k))
        else:
            flip = draws["flips"][:, ax, None]
            idx = draws["offsets"][:, ax, None] + torch.where(flip, o - 1 - k, k)
        shape = [b, 1, 1, 1]
        shape[ax + 1] = len(k)
        index.append(idx.reshape(shape))
    return vols[tuple(index)]


def _jitter(img: torch.Tensor, draws: Draws, depth: slice = slice(None)) -> torch.Tensor:
    """Brightness, then contrast around each sample's mean of the whole
    ``img``; the result's depths in ``depth``."""
    img = (img * draws["brightness"].view(-1, 1, 1, 1, 1)).clamp(0.0, 1.0)
    m = img.mean(dim=(1, 2, 3, 4), keepdim=True)
    return (m + draws["contrast"].view(-1, 1, 1, 1, 1) * (img[:, depth] - m)).clamp(0.0, 1.0)


def _normalize(img: torch.Tensor, mean: Sequence[float], std: Sequence[float], dtype) -> torch.Tensor:
    mean_t = device_constant(mean, img.device).view(1, 1, 1, 1, -1)
    std_t = device_constant(std, img.device).view(1, 1, 1, 1, -1)
    return ((img - mean_t) / std_t).to(dtype)


def apply_segmentation_3d(
    draws: Optional[Draws],
    vols: torch.Tensor,                      # (B, D, H, W, 1) float 0..1 (or scaled by value_scale)
    masks: torch.Tensor,                     # (B, D, H, W, 1) binary
    out_size: Tuple[int, int, int] = (64, 64, 64),
    mean: Sequence[float] = (0.2089,),
    std: Sequence[float] = (0.2109,),
    value_scale: float = 1.0,
    dtype=torch.bfloat16,
    hu_windows: Sequence[Tuple[float, float]] = (),
    depth: slice = slice(None),
    labels: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The paired volume/mask pipeline (``ops/augment3d.py:42-94``) from
    the given draws; ``draws=None`` is the eval pipeline. The mask is
    cropped, cut at 0.5 (not with ``labels``) and flipped with the image's
    coins. ``hu_windows`` (level, width on the 0..1 scale) become input
    channels; a single mean/std broadcasts over them. Returns the image in
    ``dtype`` and the f32 0/1 mask (label map), both cut to the crop depths
    in ``depth``."""
    _check_crop(vols.shape[1:4], out_size)
    msk = _crop_flip(masks, out_size, draws, depth).float()
    if not labels:
        msk = (msk > 0.5).float()
    if draws is None:
        img = _crop_flip(vols, out_size, None, depth).float() * value_scale
    else:
        img = _jitter(_crop_flip(vols, out_size, draws).float() * value_scale, draws, depth)
    return _normalize(apply_hu_windows(img, hu_windows), mean, std, dtype), msk


def segmentation_augment_3d(generator: Optional[torch.Generator], vols: torch.Tensor, masks: torch.Tensor,
                            out_size: Tuple[int, int, int] = (64, 64, 64), mean: Sequence[float] = (0.2089,),
                            std: Sequence[float] = (0.2109,), train: bool = True, value_scale: float = 1.0,
                            dtype=torch.bfloat16, hu_windows: Sequence[Tuple[float, float]] = (),
                            shard: Shard = (0, 1), depth: slice = slice(None),
                            labels: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample the draws from ``generator`` when ``train`` (eval needs no
    generator) and apply them: the JAX ``segmentation_augment_3d``."""
    draws = (keep_rows(sample_volume_draws(generator, vols.shape[0] * shard[1], vols.shape[1:4], out_size), shard)
             if train else None)
    return apply_segmentation_3d(draws, vols, masks, out_size, mean, std, value_scale, dtype, hu_windows, depth,
                                 labels)


def apply_byol_view_3d(draws: Draws, vols: torch.Tensor, out_size: Tuple[int, int, int] = (32, 64, 64),
                       mean: Sequence[float] = (0.2089,), std: Sequence[float] = (0.2109,),
                       value_scale: float = 1.0, dtype=torch.bfloat16) -> torch.Tensor:
    """One augmented view (``ops/augment3d.py:97-119``): crop, flips,
    jitter, normalize."""
    _check_crop(vols.shape[1:4], out_size)
    img = _jitter(_crop_flip(vols, out_size, draws).float() * value_scale, draws)
    return _normalize(img, mean, std, dtype)


def byol_two_view_augment_3d(generator: torch.Generator, vols: torch.Tensor,
                             out_size: Tuple[int, int, int] = (32, 64, 64), mean: Sequence[float] = (0.2089,),
                             std: Sequence[float] = (0.2109,), value_scale: float = 1.0,
                             dtype=torch.bfloat16, shard: Shard = (0, 1)) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two independently drawn views of every volume, view 1's draws first
    (``ops/augment3d.py:122-138``)."""
    n = vols.shape[0] * shard[1]
    v1, v2 = (apply_byol_view_3d(keep_rows(sample_volume_draws(generator, n, vols.shape[1:4], out_size), shard),
                                 vols, out_size, mean, std, value_scale, dtype) for _ in range(2))
    return v1, v2
