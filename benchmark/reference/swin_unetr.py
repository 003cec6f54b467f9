"""Swin UNETR's training step in plain PyTorch: the benchmark's reference for
the ``swin_unetr_liver`` cell.

Hatamizadeh et al., Swin UNETR, arXiv:2201.01266, as MONAI's ``SwinUNETR``
(``normalize=True``, ``downsample`` patch merging of ``PatchMergingV2``) and
Tang et al.'s CT recipe (arXiv:2111.14791):

- the Swin encoder on (B, D, H, W, C) tokens: a 2³ stride-2 patch
  embedding with bias; per stage, blocks of ``x + WA(LN₁ x)`` and
  ``x + W₂ GELU(W₁ LN₂ x)`` (LayerNorm eps 1e-5), where ``WA`` pads the
  normed tokens with zeros at the end of each axis to a multiple of the
  window, rolls them by −shift in the odd blocks, and in every window
  computes ``softmax(q·kᵀ/√d + B + M)·v`` explicitly, q, k and v from one
  Linear with bias, B gathered from the bias table by the full window's
  relative position index cut to ``[:n, :n]``, M −100 between tokens of
  different regions of the rolled grid; then the projection, the rolls and
  pads undone. An axis no longer than the window takes its resolution as
  window and no shift. Each stage ends in patch merging: the 8 sub-grids
  in ``itertools.product`` order, LayerNorm(8C), Linear(8C → 2C) without
  bias. Each hidden output is LayerNorm'd over channels without affine.
- the CNN side: residual blocks ``lrelu(IN(conv(lrelu(IN(conv x)))) + r)``
  (3³ convs without bias, ``F.instance_norm`` without affine, eps 1e-5,
  LeakyReLU 0.01; ``r = IN(conv1³ x)`` where the width changes), up blocks
  of a 2³ stride-2 transposed conv without bias, the skip after it and a
  residual block, a 1³ conv with bias to the logits.
- the loss: MONAI's ``DiceCELoss(to_onehot_y, softmax, squared_pred,
  smooth_nr=0, smooth_dr=1e-6)``: per sample and class, background
  included, ``1 − 2Σpg / (Σp² + Σg² + 1e-6)`` averaged, plus the voxels'
  mean cross-entropy.
- AdamW (torch's: decay ``p·(1 − lr·wd)`` first, then the bias-corrected
  moments) at the warmup-cosine learning rate of the step's epoch
  (MONAI's ``LinearWarmupCosineAnnealingLR``, ending at 0).

Departures from MONAI, as the port trains it: bf16 autocast in place of
fp16 with a gradient scaler; the port's crops, flips and intensity jitter
(``reference/nnunet3d.py::augment``) in place of MONAI's transforms.
``precision`` as in ``reference/nets.py``, applied to every convolution's
and matrix product's operands and result. A copy of
``tests/plain_swin_unetr.py``'s statement, which the benchmark may not
import, with the precisions and with the crops in passes of
``crops_per_pass`` (their losses and gradients weighed by their share), so
that the float32 step fits on one card at the cell's size. Tensors are by
the program's state-dict names; inputs and logits NDHWC.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from benchmark.reference.nets import _q

EPS = 1e-5
SLOPE = 0.01


def relative_position_index(window: int) -> torch.Tensor:
    """(n, n): the bias table's row of each pair of a window's n = window³
    tokens, (Δd, Δh, Δw) shifted to 0 … 2·window − 2, in base 2·window − 1."""
    pos = torch.tensor(list(itertools.product(range(window), repeat=3)))
    rel = pos[:, None, :] - pos[None, :, :] + (window - 1)
    side = 2 * window - 1
    return (rel[..., 0] * side + rel[..., 1]) * side + rel[..., 2]


def layout(cfg: dict) -> Dict[str, tuple]:
    """The network's tensors (parameters and the index buffers) by name and shape."""
    f, k, w = cfg["feature_size"], cfg["classes"], cfg["window"]
    out: Dict[str, tuple] = {"swinViT.patch_embed.proj.weight": (f, cfg["in_channels"], 2, 2, 2),
                             "swinViT.patch_embed.proj.bias": (f,)}
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["heads"])):
        c = f * 2 ** i
        pre = f"swinViT.layers{i + 1}.0"
        for j in range(depth):
            b = f"{pre}.blocks.{j}"
            for name, shape in (("norm1.weight", (c,)), ("norm1.bias", (c,)),
                                ("attn.relative_position_bias_table", ((2 * w - 1) ** 3, heads)),
                                ("attn.relative_position_index", (w ** 3, w ** 3)),
                                ("attn.qkv.weight", (3 * c, c)), ("attn.qkv.bias", (3 * c,)),
                                ("attn.proj.weight", (c, c)), ("attn.proj.bias", (c,)),
                                ("norm2.weight", (c,)), ("norm2.bias", (c,)),
                                ("mlp.linear1.weight", (4 * c, c)), ("mlp.linear1.bias", (4 * c,)),
                                ("mlp.linear2.weight", (c, 4 * c)), ("mlp.linear2.bias", (c,))):
                out[f"{b}.{name}"] = shape
        out[f"{pre}.downsample.norm.weight"] = (8 * c,)
        out[f"{pre}.downsample.norm.bias"] = (8 * c,)
        out[f"{pre}.downsample.reduction.weight"] = (2 * c, 8 * c)

    def res(name, cin, cout):
        out[f"{name}.conv1.conv.weight"] = (cout, cin, 3, 3, 3)
        out[f"{name}.conv2.conv.weight"] = (cout, cout, 3, 3, 3)
        if cin != cout:
            out[f"{name}.conv3.conv.weight"] = (cout, cin, 1, 1, 1)

    for name, cin, cout in (("encoder1", cfg["in_channels"], f), ("encoder2", f, f), ("encoder3", 2 * f, 2 * f),
                            ("encoder4", 4 * f, 4 * f), ("encoder10", 16 * f, 16 * f)):
        res(f"{name}.layer", cin, cout)
    for name, cin, cout in (("decoder5", 16 * f, 8 * f), ("decoder4", 8 * f, 4 * f), ("decoder3", 4 * f, 2 * f),
                            ("decoder2", 2 * f, f), ("decoder1", f, f)):
        out[f"{name}.transp_conv.conv.weight"] = (cin, cout, 2, 2, 2)
        res(f"{name}.conv_block", 2 * cout, cout)
    out["out.conv.conv.weight"], out["out.conv.conv.bias"] = (k, f, 1, 1, 1), (k,)
    return out


# --- the forward ----------------------------------------------------------------------


def _linear(x, w, b, precision):
    return _q(F.linear(_q(x, precision), _q(w, precision), b), precision)


def _mm(a, b, precision):
    return _q(torch.matmul(_q(a, precision), _q(b, precision)), precision)


def _windows(x, ws):
    b, d, h, w, c = x.shape
    x = x.reshape(b, d // ws[0], ws[0], h // ws[1], ws[1], w // ws[2], ws[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(b, -1, ws[0] * ws[1] * ws[2], c)


def _unwindows(x, ws, dims):
    b, (d, h, w) = x.shape[0], dims
    x = x.reshape(b, d // ws[0], h // ws[1], w // ws[2], ws[0], ws[1], ws[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, -1)


def shift_mask(dims, ws, ss, device) -> torch.Tensor:
    """(windows, n, n): −100 between tokens of different regions of the
    rolled grid, 0 within one; regions cut at −window and −shift."""
    region = torch.zeros(dims, device=device)
    cuts = [(slice(0, d - w), slice(d - w, d - s), slice(d - s, d)) for d, w, s in zip(dims, ws, ss)]
    for r, (a, b, c) in enumerate(itertools.product(*cuts)):
        region[a, b, c] = r
    ids = _windows(region[None, ..., None], ws)[0, ..., 0]
    return torch.where(ids[:, :, None] == ids[:, None, :], 0.0, -100.0)


def _attention(x, P, pre, heads, window, shift, precision):
    """Window attention of block ``pre`` on normed (B, D, H, W, C) tokens."""
    b, d, h, w, c = x.shape
    ws = [s if s <= window else window for s in (d, h, w)]
    ss = [0 if s <= window else shift for s in (d, h, w)]
    x = F.pad(x, (0, 0, 0, -w % ws[2], 0, -h % ws[1], 0, -d % ws[0]))
    dims = x.shape[1:4]
    if any(ss):
        x = torch.roll(x, shifts=[-s for s in ss], dims=(1, 2, 3))
    win = _windows(x, ws)  # (B, windows, n, C)
    n, hd = win.shape[2], c // heads
    qkv = _linear(win, P[f"{pre}.attn.qkv.weight"], P[f"{pre}.attn.qkv.bias"], precision)
    qkv = qkv.reshape(b, win.shape[1], n, 3, heads, hd).permute(3, 0, 1, 4, 2, 5)
    q, k, v = qkv[0] * hd ** -0.5, qkv[1], qkv[2]
    idx = P[f"{pre}.attn.relative_position_index"][:n, :n].reshape(-1)
    bias = P[f"{pre}.attn.relative_position_bias_table"][idx].reshape(n, n, heads).permute(2, 0, 1)
    scores = _mm(q, k.transpose(-2, -1), precision) + bias
    if any(ss):
        scores = scores + shift_mask(dims, ws, ss, x.device)[None, :, None]
    out = _mm(torch.softmax(scores, dim=-1), v, precision)
    out = out.permute(0, 1, 3, 2, 4).reshape(b, win.shape[1], n, c)
    out = _unwindows(_linear(out, P[f"{pre}.attn.proj.weight"], P[f"{pre}.attn.proj.bias"], precision), ws, dims)
    if any(ss):
        out = torch.roll(out, shifts=ss, dims=(1, 2, 3))
    return out[:, :d, :h, :w]


def _ln(x, P, name):
    return F.layer_norm(x, x.shape[-1:], P[f"{name}.weight"], P[f"{name}.bias"], eps=EPS)


def swin(x_ncdhw, P, cfg, precision="f32") -> List[torch.Tensor]:
    """The five hidden outputs, normed, as (B, C, D, H, W)."""
    t = _q(F.conv3d(_q(x_ncdhw, precision), _q(P["swinViT.patch_embed.proj.weight"], precision),
                    P["swinViT.patch_embed.proj.bias"], stride=2), precision).permute(0, 2, 3, 4, 1)

    def hidden(t):
        return F.layer_norm(t, t.shape[-1:], eps=EPS).permute(0, 4, 1, 2, 3)

    outs = [hidden(t)]
    w = cfg["window"]
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["heads"])):
        pre = f"swinViT.layers{i + 1}.0"
        for j in range(depth):
            b = f"{pre}.blocks.{j}"
            t = t + _attention(_ln(t, P, f"{b}.norm1"), P, b, heads, w, 0 if j % 2 == 0 else w // 2, precision)
            m = F.gelu(_linear(_ln(t, P, f"{b}.norm2"), P[f"{b}.mlp.linear1.weight"], P[f"{b}.mlp.linear1.bias"],
                               precision))
            t = t + _linear(m, P[f"{b}.mlp.linear2.weight"], P[f"{b}.mlp.linear2.bias"], precision)
        t = torch.cat([t[:, i0::2, j0::2, k0::2] for i0, j0, k0 in itertools.product(range(2), repeat=3)], -1)
        t = _linear(_ln(t, P, f"{pre}.downsample.norm"), P[f"{pre}.downsample.reduction.weight"], None, precision)
        outs.append(hidden(t))
    return outs


def _conv(x, w, precision, stride=1, padding=None):
    pad = w.shape[-1] // 2 if padding is None else padding
    return _q(F.conv3d(_q(x, precision), _q(w, precision), None, stride, pad), precision)


def _in(x):
    """InstanceNorm without affine; over one voxel (the bottleneck of a 32³
    crop, where ``F.instance_norm`` refuses to train) the normalized value is 0."""
    return F.instance_norm(x, eps=EPS) if x[0, 0].numel() > 1 else x - x.mean(dim=(2, 3, 4), keepdim=True)


def res_block(x, P, name, precision):
    y = F.leaky_relu(_in(_conv(x, P[f"{name}.conv1.conv.weight"], precision)), SLOPE)
    y = _in(_conv(y, P[f"{name}.conv2.conv.weight"], precision))
    r = _in(_conv(x, P[f"{name}.conv3.conv.weight"], precision)) if f"{name}.conv3.conv.weight" in P else x
    return F.leaky_relu(y + r, SLOPE)


def up_block(x, skip, P, name, precision):
    y = _q(F.conv_transpose3d(_q(x, precision), _q(P[f"{name}.transp_conv.conv.weight"], precision), stride=2),
           precision)
    return res_block(torch.cat([y, skip], dim=1), P, f"{name}.conv_block", precision)


def forward(x_ndhwc, P: Dict[str, torch.Tensor], cfg: dict, precision: str = "f32") -> torch.Tensor:
    x = x_ndhwc.permute(0, 4, 1, 2, 3)
    h0, h1, h2, h3, h4 = swin(x, P, cfg, precision)
    enc0 = res_block(x, P, "encoder1.layer", precision)
    enc1 = res_block(h0, P, "encoder2.layer", precision)
    enc2 = res_block(h1, P, "encoder3.layer", precision)
    enc3 = res_block(h2, P, "encoder4.layer", precision)
    dec4 = res_block(h4, P, "encoder10.layer", precision)
    dec3 = up_block(dec4, h3, P, "decoder5", precision)
    dec2 = up_block(dec3, enc3, P, "decoder4", precision)
    dec1 = up_block(dec2, enc2, P, "decoder3", precision)
    dec0 = up_block(dec1, enc1, P, "decoder2", precision)
    out = up_block(dec0, enc0, P, "decoder1", precision)
    logits = _q(F.conv3d(_q(out, precision), _q(P["out.conv.conv.weight"], precision), P["out.conv.conv.bias"]),
                precision)
    return logits.permute(0, 2, 3, 4, 1)


def dice_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logits`` (B, ..., K), ``labels`` (B, ..., 1) class values."""
    k = logits.shape[-1]
    y = labels[..., 0].long()
    z = logits.reshape(logits.shape[0], -1, k)
    p = torch.softmax(z, dim=-1)
    g = F.one_hot(y.reshape(y.shape[0], -1), k).float()
    dice = 1.0 - 2.0 * (p * g).sum(1) / ((p * p).sum(1) + (g * g).sum(1) + 1e-6)
    return dice.mean() + F.cross_entropy(z.reshape(-1, k), y.reshape(-1))


def lr_at(cfg: dict, step: int) -> float:
    """MONAI's ``LinearWarmupCosineAnnealingLR`` from 0, per epoch, to 0."""
    epoch = step // cfg["steps_per_epoch"]
    warm, total, base = cfg["warmup_epochs"], cfg["max_epochs"], cfg["learning_rate"]
    if epoch < warm:
        return epoch * base / max(warm - 1, 1)
    return 0.5 * base * (1.0 + math.cos(math.pi * (epoch - warm) / max(total - warm, 1)))


class ReferenceSwin:
    """The parameters (float32 copies by name), AdamW's moments and the step count."""

    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor], step: int, precision: str = "f32",
                 crops_per_pass: int = 2):
        self.cfg, self.precision, self.step_count, self.crops_per_pass = cfg, precision, step, crops_per_pass
        self.P = {k: v.detach().clone() if not v.is_floating_point() else v.detach().float().clone()
                  for k, v in weights.items()}
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.t = 0

    def leaves(self) -> List[str]:
        return [k for k, v in self.P.items() if v.is_floating_point()]

    def loss_and_grads(self, x: torch.Tensor, labels: torch.Tensor):
        names = self.leaves()
        total_loss, grads = 0.0, None
        for s in range(0, x.shape[0], self.crops_per_pass):
            part = slice(s, s + self.crops_per_pass)
            share = x[part].shape[0] / x.shape[0]
            leaves = {k: (self.P[k].requires_grad_(True) if k in names else self.P[k]) for k in self.P}
            loss = dice_ce(forward(x[part].float(), leaves, self.cfg, self.precision).float(), labels[part]) * share
            g = torch.autograd.grad(loss, [leaves[k] for k in names])
            for k in names:
                self.P[k].requires_grad_(False)
            total_loss = total_loss + loss.detach()
            grads = list(g) if grads is None else [a + b for a, b in zip(grads, g)]
        return total_loss, dict(zip(names, grads))

    @torch.no_grad()
    def apply(self, grads: Dict[str, torch.Tensor]) -> None:
        cfg = self.cfg
        lr, wd, (b1, b2), eps = lr_at(cfg, self.step_count), cfg["weight_decay"], cfg["betas"], cfg["adam_eps"]
        self.t += 1
        for k, g in grads.items():
            self.m[k] = (1 - b1) * g if k not in self.m else b1 * self.m[k] + (1 - b1) * g
            self.v[k] = (1 - b2) * g * g if k not in self.v else b2 * self.v[k] + (1 - b2) * g * g
            denom = (self.v[k] / (1 - b2 ** self.t)).sqrt() + eps
            self.P[k] = self.P[k] * (1 - lr * wd) - lr * (self.m[k] / (1 - b1 ** self.t)) / denom
        self.step_count += 1
