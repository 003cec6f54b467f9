"""Operations and bytes from the configuration's shapes, the same whatever
implements them.

FLOPs come from ``torch.utils.flop_counter.FlopCounterMode`` over the
benchmark's own plain networks (``reference/nets.py``) on the ``meta``
device: convolutions and matrix products, forward and backward as a step
needs them, nothing recomputed, nothing run. The bytes of the
augmentation kernel are the image sectors its bilinear taps read under a
launch's draws, both views written once and the parameter block read
once (the count of PERF.md's kernel table).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import nets
from benchmark.reference.augment import N_PARAMS, PARAMS_PER_VIEW, _taps
from benchmark.reference.byol import byol_loss


def _meta(layout: Dict[str, torch.Size], grad: bool) -> Dict[str, torch.Tensor]:
    out = {}
    for k, s in layout.items():
        t = torch.empty(tuple(s), device="meta")
        out[k] = t.requires_grad_(grad and not k.endswith(("running_mean", "running_var")))
    return out


def byol_step_flops(cfg: dict, batch: int) -> float:
    """One BYOL step on ``batch`` images: the online network's forward and
    backward and the target's forward, each over both views (2·batch rows)."""
    from benchmark.reference.layouts import byol_layouts

    online_l, target_l = byol_layouts(cfg)
    online, target = _meta(online_l, True), _meta(target_l, False)
    x = torch.empty(2 * batch, cfg["crop_size"], cfg["crop_size"], cfg["in_channels"], device="meta")
    arch = cfg["arch"]
    with FlopCounterMode(display=False) as counter:
        with torch.no_grad():
            z_t = nets.mlp(nets.resnet(x, target, "backbone.", arch), target, "projector.")
        z = nets.mlp(nets.resnet(x, online, "encoder.backbone.", arch), online, "encoder.projector.")
        p = nets.mlp(z, online, "predictor.")
        byol_loss(p, z_t).backward()
    return float(counter.get_total_flops())


def unet_forward_flops(cfg: dict, batch: int) -> float:
    """One eval forward of the U-Net over ``batch`` slices."""
    from benchmark.reference.layouts import unet_layout

    P = _meta(unet_layout(cfg), False)
    s = cfg["image_size"]
    x = torch.empty(batch, s, s, cfg["in_channels"], device="meta")
    with FlopCounterMode(display=False) as counter:
        nets.unet(x, P, cfg["arch"])
    return float(counter.get_total_flops())


def two_view_augment_bytes(params: torch.Tensor, in_shape, out_size, out_bytes: int = 2, in_bytes: int = 1,
                           sector: int = 32) -> int:
    """Bytes one launch needs under the (B, 24) draws ``params``: the
    ``sector``-byte sectors (the unit in which the card reads its memory)
    of the (B, H, W, C) images that the two views' bilinear taps read,
    both (B, oh, ow, C) views written, the float32 parameters read."""
    b, in_h, in_w, c = in_shape
    oh, ow = out_size
    pix = c * in_bytes
    if sector % pix or (in_w * pix) % sector:
        raise ValueError(f"a sector of {sector} B must hold whole pixels of {pix} B and rows of {in_w * pix} B")
    per = sector // pix
    dev = params.device
    touched = torch.zeros(b, in_h, in_w // per, dtype=torch.bool, device=dev)
    for view in range(2):
        p = params[:, view * PARAMS_PER_VIEW:(view + 1) * PARAMS_PER_VIEW].float()
        ly, hy, _ = _taps(p[:, 0], p[:, 2], in_h, oh)
        lx, hx, _ = _taps(p[:, 1], p[:, 3], in_w, ow, p[:, 4])
        rows = torch.zeros(b, in_h, dtype=torch.bool, device=dev)
        secs = torch.zeros(b, in_w // per, dtype=torch.bool, device=dev)
        for m, idx in ((rows, ly), (rows, hy), (secs, lx // per), (secs, hx // per)):
            m.scatter_(1, idx, True)
        touched |= rows[:, :, None] & secs[:, None, :]
    views = 2 * b * oh * ow * c * out_bytes
    return int(touched.sum()) * sector + views + b * N_PARAMS * 4
