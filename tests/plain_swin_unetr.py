"""Swin UNETR's training step in plain float32 PyTorch, over a dict of
tensors by the port's state-dict names: the statement that
``tests/test_torch_swin_unetr.py`` holds ``models/swin_unetr.py`` and the
task's ``arch="swin_unetr"`` to. It imports torch alone.

Hatamizadeh et al., Swin UNETR, arXiv:2201.01266, as MONAI's ``SwinUNETR``
(``normalize=True``, the sub-grid order of ``PatchMergingV2``) and Tang et
al.'s CT recipe (arXiv:2111.14791):

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
fp16 with a gradient scaler, and the port's crops, flips and intensity
jitter in place of MONAI's transforms (neither is stated here: this is the
float32 step on given crops); MONAI's default ``downsample="merging"``
class takes the sub-grids in another order, this one is
``PatchMergingV2``'s.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, List

import torch
import torch.nn.functional as F

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


def _attention(x, P, pre, heads, window, shift):
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
    qkv = F.linear(win, P[f"{pre}.attn.qkv.weight"], P[f"{pre}.attn.qkv.bias"])
    qkv = qkv.reshape(b, win.shape[1], n, 3, heads, hd).permute(3, 0, 1, 4, 2, 5)
    q, k, v = qkv[0] * hd ** -0.5, qkv[1], qkv[2]
    idx = P[f"{pre}.attn.relative_position_index"][:n, :n].reshape(-1)
    bias = P[f"{pre}.attn.relative_position_bias_table"][idx].reshape(n, n, heads).permute(2, 0, 1)
    scores = torch.matmul(q, k.transpose(-2, -1)) + bias
    if any(ss):
        scores = scores + shift_mask(dims, ws, ss, x.device)[None, :, None]
    out = torch.matmul(torch.softmax(scores, dim=-1), v)
    out = out.permute(0, 1, 3, 2, 4).reshape(b, win.shape[1], n, c)
    out = _unwindows(F.linear(out, P[f"{pre}.attn.proj.weight"], P[f"{pre}.attn.proj.bias"]), ws, dims)
    if any(ss):
        out = torch.roll(out, shifts=ss, dims=(1, 2, 3))
    return out[:, :d, :h, :w]


def _ln(x, P, name):
    return F.layer_norm(x, x.shape[-1:], P[f"{name}.weight"], P[f"{name}.bias"], eps=EPS)


def swin(x_ncdhw, P, cfg) -> List[torch.Tensor]:
    """The five hidden outputs, normed, as (B, C, D, H, W)."""
    t = F.conv3d(x_ncdhw, P["swinViT.patch_embed.proj.weight"], P["swinViT.patch_embed.proj.bias"],
                 stride=2).permute(0, 2, 3, 4, 1)

    def hidden(t):
        return F.layer_norm(t, t.shape[-1:], eps=EPS).permute(0, 4, 1, 2, 3)

    outs = [hidden(t)]
    w = cfg["window"]
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["heads"])):
        pre = f"swinViT.layers{i + 1}.0"
        for j in range(depth):
            b = f"{pre}.blocks.{j}"
            t = t + _attention(_ln(t, P, f"{b}.norm1"), P, b, heads, w, 0 if j % 2 == 0 else w // 2)
            m = F.gelu(F.linear(_ln(t, P, f"{b}.norm2"), P[f"{b}.mlp.linear1.weight"], P[f"{b}.mlp.linear1.bias"]))
            t = t + F.linear(m, P[f"{b}.mlp.linear2.weight"], P[f"{b}.mlp.linear2.bias"])
        t = torch.cat([t[:, i0::2, j0::2, k0::2] for i0, j0, k0 in itertools.product(range(2), repeat=3)], -1)
        t = F.linear(_ln(t, P, f"{pre}.downsample.norm"), P[f"{pre}.downsample.reduction.weight"], None)
        outs.append(hidden(t))
    return outs


def _conv(x, w):
    return F.conv3d(x, w, None, 1, w.shape[-1] // 2)


def _in(x):
    """InstanceNorm without affine; over one voxel (the bottleneck of a 32³
    crop, where ``F.instance_norm`` refuses to train) the normalized value is 0."""
    return F.instance_norm(x, eps=EPS) if x[0, 0].numel() > 1 else x - x.mean(dim=(2, 3, 4), keepdim=True)


def res_block(x, P, name):
    y = F.leaky_relu(_in(_conv(x, P[f"{name}.conv1.conv.weight"])), SLOPE)
    y = _in(_conv(y, P[f"{name}.conv2.conv.weight"]))
    r = _in(_conv(x, P[f"{name}.conv3.conv.weight"])) if f"{name}.conv3.conv.weight" in P else x
    return F.leaky_relu(y + r, SLOPE)


def up_block(x, skip, P, name):
    y = F.conv_transpose3d(x, P[f"{name}.transp_conv.conv.weight"], stride=2)
    return res_block(torch.cat([y, skip], dim=1), P, f"{name}.conv_block")


def forward(x_ndhwc, P: Dict[str, torch.Tensor], cfg: dict) -> torch.Tensor:
    x = x_ndhwc.permute(0, 4, 1, 2, 3)
    h0, h1, h2, h3, h4 = swin(x, P, cfg)
    enc0 = res_block(x, P, "encoder1.layer")
    enc1 = res_block(h0, P, "encoder2.layer")
    enc2 = res_block(h1, P, "encoder3.layer")
    enc3 = res_block(h2, P, "encoder4.layer")
    dec4 = res_block(h4, P, "encoder10.layer")
    dec3 = up_block(dec4, h3, P, "decoder5")
    dec2 = up_block(dec3, enc3, P, "decoder4")
    dec1 = up_block(dec2, enc2, P, "decoder3")
    dec0 = up_block(dec1, enc1, P, "decoder2")
    out = up_block(dec0, enc0, P, "decoder1")
    logits = F.conv3d(out, P["out.conv.conv.weight"], P["out.conv.conv.bias"])
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


def loss_and_grads(P: Dict[str, torch.Tensor], x: torch.Tensor, labels: torch.Tensor, cfg: dict):
    """The loss of the crops and its gradient of every float tensor of ``P``."""
    names = [k for k, v in P.items() if v.is_floating_point()]
    leaves = {k: v.detach().clone().requires_grad_(k in names) for k, v in P.items()}
    loss = dice_ce(forward(x, leaves, cfg), labels)
    grads = torch.autograd.grad(loss, [leaves[k] for k in names])
    return loss.detach(), dict(zip(names, grads))


def adamw(P: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], state: dict, lr: float, cfg: dict) -> dict:
    """One AdamW step of the leaves ``grads`` names; ``state`` holds ``t``,
    ``m`` and ``v`` (empty at the start). Returns the new tensors."""
    wd, (b1, b2), eps = cfg["weight_decay"], cfg["betas"], cfg["adam_eps"]
    state["t"] = t = state.get("t", 0) + 1
    m, v = state.setdefault("m", {}), state.setdefault("v", {})
    out = dict(P)
    for k, g in grads.items():
        m[k] = (1 - b1) * g if k not in m else b1 * m[k] + (1 - b1) * g
        v[k] = (1 - b2) * g * g if k not in v else b2 * v[k] + (1 - b2) * g * g
        denom = (v[k] / (1 - b2 ** t)).sqrt() + eps
        out[k] = P[k] * (1 - lr * wd) - lr * (m[k] / (1 - b1 ** t)) / denom
    return out
