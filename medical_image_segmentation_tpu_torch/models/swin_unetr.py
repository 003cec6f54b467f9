"""Swin UNETR (Hatamizadeh et al., arXiv:2201.01266; MONAI's ``SwinUNETR``
with ``normalize=True``), as Tang et al. (arXiv:2111.14791) fine-tune it on
CT at a 96³ ROI and feature size 48.

- **Swin encoder** (``swinViT``), on channels-last (B, D, H, W, C) tokens:
  a 2³ stride-2 patch-embedding conv with bias to ``feature_size`` (F),
  then four stages (``layers1`` … ``layers4``) of ``DEPTHS`` Swin blocks at
  widths F, 2F, 4F, 8F with ``HEADS`` heads (the published 2, 2, 2, 2 and
  3, 6, 12, 24), each stage ending in patch merging to twice the width at
  half the resolution.
- **Swin block**: ``x + WA(LN₁(x))``, then ``x + MLP(LN₂(x))`` (Linear 4C,
  exact GELU, Linear C). Window attention ``WA``: on an axis whose
  resolution is at most ``WINDOW`` (7) the window is the resolution and the
  shift 0 (MONAI's ``get_window_size``), else the window is ``WINDOW`` and
  every second block shifts by ``WINDOW // 2``; the normed tokens are
  zero-padded at the end of each axis to a multiple of the window (the pad
  tokens are attended to, not masked), rolled by −shift, cut into windows
  of n tokens; ``softmax(q·kᵀ/√d + B + M)·v`` with B the relative position
  bias gathered from a (2·window − 1)³ × heads table by
  ``relative_position_index[:n, :n]`` of the full window's index (MONAI's
  reading, also where the window has shrunk), M the shift mask (−100
  between tokens of different regions of the rolled grid); then the
  output projection, the windows merged, rolled back and cropped.
- **Patch merging** (MONAI's ``PatchMergingV2``): the 8 sub-grids
  ``x[:, i::2, j::2, k::2]`` in ``itertools.product`` order concatenated,
  LayerNorm(8C), Linear(8C → 2C) without bias.
- **Hidden outputs** x₀ … x₄ (the patch embedding and each stage's
  output) pass through a LayerNorm over channels without affine.
- **CNN side** (MONAI's dynunet blocks; convs without bias, InstanceNorm
  without affine, LeakyReLU 0.01): a residual block ``lrelu(IN(conv3(
  lrelu(IN(conv3(x))))) + r)`` with ``r = IN(conv1(x))`` where the width
  changes; encoders on the input and x₀ … x₂ and x₄, five up blocks
  (a 2³ stride-2 transposed conv without bias, the skip concatenated
  after it, a residual block), a 1³ conv with bias to the logits.

InstanceNorm is ``models/plain_unet3d.py::InstanceNorm3D`` with
``affine=False``, its activation fused where a LeakyReLU follows the norm
and ``slope=1`` where the residual sum comes first: the hand-written
kernels of ``csrc/instance_norm.cu`` on a card. Window attention is one
``F.scaled_dot_product_attention`` call a block over every window, head and
crop, the relative position bias and the shift mask going in as one
additive bias: an unshifted block lays the windows along the batch and
shares a (heads, n, n) bias; a shifted block lays them along the heads, so
that a (windows × heads, n, n) bias broadcasts over the crops.

Departures from MONAI, as the port trains it: bf16 autocast in place of
fp16 with a gradient scaler (LayerNorm's float32 output is rounded to the
compute dtype where the next matrix product would round it); the
logits' 1³ conv in float32 outside autocast, as ``PlainConvUNet3D``'s
heads; the shift mask cached a padded grid.

Under a profiler each block's window attention (qkv, the bias gather,
the attention, the projection) is a ``mis.swin.attention`` span and the
whole Swin encoder a ``mis.swin.encoder`` span; the counters
``swin.attention_tokens`` and ``swin.attention_pad_tokens`` add each
block's padded query tokens and the part of them that padding added
(not again in a ``remat`` recompute). The state-dict names are MONAI's
(``swinViT.layers1.0.blocks.0.attn.relative_position_bias_table``,
``encoder1.layer.conv1.conv.weight``, …).

NDHWC in, f32 NDHWC logits out; the CNN side is ``channels_last_3d``, so
put the module in that format as well. D, H and W must be multiples of
32. ``remat`` checkpoints each Swin block and each residual block.
"""

from __future__ import annotations

import itertools
from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from medical_image_segmentation_tpu_torch.core.profiling import count, span
from medical_image_segmentation_tpu_torch.models.plain_unet3d import NEGATIVE_SLOPE, InstanceNorm3D
from medical_image_segmentation_tpu_torch.models.resnet import _checkpointed

LN_EPS = 1e-5
MASK_VALUE = -100.0
DEPTHS, HEADS, WINDOW = (2, 2, 2, 2), (3, 6, 12, 24), 7  # Swin blocks and heads a stage, the window's side
STRIDE = 32  # the patch embedding and four mergings halve each axis five times


def relative_position_index(window: int) -> torch.Tensor:
    """(window³, window³) int64 rows of the (2·window − 1)³ bias table
    for each pair of a window's tokens (MONAI's 3D index)."""
    ax = torch.arange(window)
    coords = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (window - 1)
    return rel[..., 0] * (2 * window - 1) ** 2 + rel[..., 1] * (2 * window - 1) + rel[..., 2]


def window_and_shift(dims: Sequence[int], window: int, shift: int) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """MONAI's ``get_window_size``: an axis no longer than the window takes
    its resolution as window and no shift."""
    return (tuple(d if d <= window else window for d in dims),
            tuple(0 if d <= window else shift for d in dims))


def partition(x: torch.Tensor, ws: Sequence[int]) -> torch.Tensor:
    """(B, D, H, W, C) → (B · windows, n, C), windows in (D, H, W) order."""
    b, d, h, w, c = x.shape
    x = x.view(b, d // ws[0], ws[0], h // ws[1], ws[1], w // ws[2], ws[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, ws[0] * ws[1] * ws[2], c)


def merge(windows: torch.Tensor, ws: Sequence[int], b: int, dims: Sequence[int]) -> torch.Tensor:
    """The inverse of ``partition``: (B · windows, n, C) → (B, D, H, W, C)."""
    d, h, w = dims
    x = windows.view(b, d // ws[0], h // ws[1], w // ws[2], ws[0], ws[1], ws[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, -1)


def shift_mask(dims: Sequence[int], ws: Sequence[int], ss: Sequence[int], device) -> torch.Tensor:
    """(windows, n, n) float32: ``MASK_VALUE`` between tokens of different
    regions of the rolled padded grid ``dims``, 0 within one (MONAI's
    ``compute_mask``)."""
    grid = torch.zeros(1, *dims, 1, device=device)
    region = 0
    cuts = [(slice(-w), slice(-w, -s), slice(-s, None)) for w, s in zip(ws, ss)]
    for d, h, w in itertools.product(*cuts):
        grid[:, d, h, w, :] = region
        region += 1
    ids = partition(grid, ws).squeeze(-1)
    diff = ids.unsqueeze(1) - ids.unsqueeze(2)
    return torch.where(diff != 0, MASK_VALUE, 0.0)


class WindowAttention(nn.Module):
    """Multi-head self-attention within windows, with the relative position
    bias (MONAI's ``WindowAttention`` names)."""

    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads = heads
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * window - 1) ** 3, heads))
        self.register_buffer("relative_position_index", relative_position_index(window))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.recomputing = False

    def forward(self, x: torch.Tensor, windows: int, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """``x`` (B · windows, n, C); ``mask`` (windows, n, n) or None."""
        with span("swin.attention"):
            return self._attend(x, windows, mask)

    def _attend(self, x: torch.Tensor, windows: int, mask: Optional[torch.Tensor]) -> torch.Tensor:
        bw, n, c = x.shape
        h = self.heads
        qkv = self.qkv(x).view(bw // windows, windows, n, 3, h, c // h).permute(3, 0, 1, 4, 2, 5).contiguous()
        rel = self.relative_position_bias_table[self.relative_position_index[:n, :n].reshape(-1)]
        rel = rel.view(n, n, h).permute(2, 0, 1).contiguous()
        if mask is None:  # windows along the batch, one (heads, n, n) bias for all
            q, k, v = (t.view(bw, h, n, c // h) for t in qkv.unbind(0))
            bias = rel.unsqueeze(0)
        else:  # windows along the heads: a (windows · heads, n, n) bias, broadcast over the crops
            q, k, v = (t.view(bw // windows, windows * h, n, c // h) for t in qkv.unbind(0))
            bias = (rel.unsqueeze(0) + mask.unsqueeze(1)).reshape(1, windows * h, n, n)
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=bias.to(q.dtype))
        out = out.view(bw // windows, windows, h, n, c // h).transpose(2, 3).reshape(bw, n, c)
        return self.proj(out)


class MLP(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.linear1 = nn.Linear(dim, hidden)
        self.linear2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(F.gelu(self.linear1(x)))


class SwinBlock(nn.Module):
    """One Swin block on (B, D, H, W, C) tokens; ``shift`` 0 or
    ``window // 2``."""

    def __init__(self, dim: int, heads: int, window: int, shift: int):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, heads, window)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = MLP(dim, 4 * dim)
        self._masks: Dict[tuple, torch.Tensor] = {}

    def _mask(self, dims, ws, ss, device) -> torch.Tensor:
        key = (tuple(dims), tuple(ws), tuple(ss), device)
        if key not in self._masks:
            self._masks[key] = shift_mask(dims, ws, ss, device)
        return self._masks[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, d, h, w, c = x.shape
        ws, ss = window_and_shift((d, h, w), self.window, self.shift)
        u = self.norm1(x).to(x.dtype)  # the rounding qkv's autocast would apply
        pads = [(-s) % k for s, k in zip((d, h, w), ws)]
        u = F.pad(u, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        dims = tuple(u.shape[1:4])
        if not self.attn.recomputing:
            count("swin.attention_tokens", b * dims[0] * dims[1] * dims[2])
            count("swin.attention_pad_tokens", b * (dims[0] * dims[1] * dims[2] - d * h * w))
        shifted = any(ss)
        if shifted:
            u = torch.roll(u, shifts=tuple(-s for s in ss), dims=(1, 2, 3))
        windows = (dims[0] // ws[0]) * (dims[1] // ws[1]) * (dims[2] // ws[2])
        mask = self._mask(dims, ws, ss, x.device) if shifted else None
        a = merge(self.attn(partition(u, ws), windows, mask), ws, b, dims)
        if shifted:
            a = torch.roll(a, shifts=ss, dims=(1, 2, 3))
        x = x + a[:, :d, :h, :w]
        return x + self.mlp(self.norm2(x).to(x.dtype))


class PatchMerging(nn.Module):
    """MONAI's ``PatchMergingV2``: (B, D, H, W, C) → (B, D/2, H/2, W/2, 2C)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(8 * dim, eps=LN_EPS)
        self.reduction = nn.Linear(8 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.cat([x[:, i::2, j::2, k::2] for i, j, k in itertools.product(range(2), repeat=3)], dim=-1)
        return self.reduction(self.norm(x).to(x.dtype))


class BasicLayer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, window: int):
        super().__init__()
        self.blocks = nn.ModuleList(SwinBlock(dim, heads, window, 0 if i % 2 == 0 else window // 2)
                                    for i in range(depth))
        self.downsample = PatchMerging(dim)


class PatchEmbed(nn.Module):
    def __init__(self, in_channels: int, dim: int):
        super().__init__()
        self.proj = nn.Conv3d(in_channels, dim, 2, stride=2)


class SwinTransformer(nn.Module):
    def __init__(self, in_channels: int, dim: int):
        super().__init__()
        self.patch_embed = PatchEmbed(in_channels, dim)
        for i, (depth, h) in enumerate(zip(DEPTHS, HEADS)):
            setattr(self, f"layers{i + 1}", nn.ModuleList([BasicLayer(dim * 2 ** i, depth, h, WINDOW)]))
        self.n_stages = len(DEPTHS)


def _conv(cin: int, cout: int, k: int, stride: int = 1, bias: bool = False, transposed: bool = False):
    """A conv held as ``.conv`` (MONAI's ``Convolution`` names)."""
    if transposed:
        layer = nn.ConvTranspose3d(cin, cout, k, stride=stride, bias=bias)
    else:
        layer = nn.Conv3d(cin, cout, k, stride=stride, padding=k // 2, bias=bias)
    return nn.Sequential(OrderedDict(conv=layer))


class ResBlock(nn.Module):
    """MONAI's ``UnetResBlock`` (kernel 3, stride 1, instance norm)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = _conv(cin, cout, 3)
        self.norm1 = InstanceNorm3D(cout, affine=False)
        self.conv2 = _conv(cout, cout, 3)
        self.norm2 = InstanceNorm3D(cout, affine=False, slope=1.0)
        self.downsample = cin != cout
        if self.downsample:
            self.conv3 = _conv(cin, cout, 1)
            self.norm3 = InstanceNorm3D(cout, affine=False, slope=1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm2(self.conv2(self.norm1(self.conv1(x))))
        r = self.norm3(self.conv3(x)) if self.downsample else x
        return F.leaky_relu(y + r, NEGATIVE_SLOPE)


class EncoderBlock(nn.Module):
    """MONAI's ``UnetrBasicBlock`` with ``res_block=True``."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.layer = ResBlock(cin, cout)


class UpBlock(nn.Module):
    """MONAI's ``UnetrUpBlock``: transposed conv, the skip after it, a
    residual block."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.transp_conv = _conv(cin, cout, 2, stride=2, transposed=True)
        self.conv_block = ResBlock(2 * cout, cout)


class SwinUNETR3D(nn.Module):
    def __init__(self, in_channels: int = 1, n_classes: int = 3, feature_size: int = 48, remat: bool = False):
        super().__init__()
        f = feature_size
        self.in_channels, self.feature_size, self.remat = in_channels, f, remat
        self.swinViT = SwinTransformer(in_channels, f)
        self.encoder1 = EncoderBlock(in_channels, f)
        self.encoder2 = EncoderBlock(f, f)
        self.encoder3 = EncoderBlock(2 * f, 2 * f)
        self.encoder4 = EncoderBlock(4 * f, 4 * f)
        self.encoder10 = EncoderBlock(16 * f, 16 * f)
        self.decoder5 = UpBlock(16 * f, 8 * f)
        self.decoder4 = UpBlock(8 * f, 4 * f)
        self.decoder3 = UpBlock(4 * f, 2 * f)
        self.decoder2 = UpBlock(2 * f, f)
        self.decoder1 = UpBlock(f, f)
        self.out = nn.Sequential(OrderedDict(conv=_conv(f, n_classes, 1, bias=True)))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Linear weights and the bias tables truncated normal (std 0.02),
        Linear biases 0, LayerNorms 1 and 0, convs and transposed convs He
        normal (torch's fan-in), their biases 0."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.trunc_normal_(m.weight, std=0.02, generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, (nn.Conv3d, nn.ConvTranspose3d)):
                nn.init.kaiming_normal_(m.weight, generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, WindowAttention):
                nn.init.trunc_normal_(m.relative_position_bias_table, std=0.02, generator=generator)

    def _run(self, block: nn.Module, x: torch.Tensor) -> torch.Tensor:
        return _checkpointed(block, x) if self.remat and torch.is_grad_enabled() else block(x)

    @staticmethod
    def _hidden(x: torch.Tensor) -> torch.Tensor:
        """A hidden output: LayerNorm without affine over the channels of
        (B, D, H, W, C), as the CNN side's (B, C, D, H, W) channels-last view."""
        return F.layer_norm(x, x.shape[-1:], eps=LN_EPS).to(x.dtype).permute(0, 4, 1, 2, 3)

    def _swin(self, x: torch.Tensor):
        """The five hidden outputs x₀ … x₄."""
        vit = self.swinViT
        with span("swin.encoder"):
            t = vit.patch_embed.proj(x).permute(0, 2, 3, 4, 1)
            hidden = [self._hidden(t)]
            for i in range(vit.n_stages):
                layer = getattr(vit, f"layers{i + 1}")[0]
                for blk in layer.blocks:
                    t = self._run(blk, t)
                t = layer.downsample(t)
                hidden.append(self._hidden(t))
        return hidden

    def _up(self, name: str, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        up = getattr(self, name)
        y = up.transp_conv(x)
        return self._run(up.conv_block, torch.cat([y, skip.to(y.dtype)], dim=1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.in_channels:
            raise ValueError(f"expected {self.in_channels} input channels, got shape {tuple(x.shape)}")
        if any(s % STRIDE for s in x.shape[1:4]):
            raise ValueError(f"SwinUNETR3D input D/H/W must be multiples of {STRIDE}; got {tuple(x.shape[1:4])}")
        x = x.permute(0, 4, 1, 2, 3)
        h0, h1, h2, h3, h4 = self._swin(x)
        enc0 = self._run(self.encoder1.layer, x)
        enc1 = self._run(self.encoder2.layer, h0)
        enc2 = self._run(self.encoder3.layer, h1)
        enc3 = self._run(self.encoder4.layer, h2)
        dec4 = self._run(self.encoder10.layer, h4)
        dec3 = self._up("decoder5", dec4, h3)
        dec2 = self._up("decoder4", dec3, enc3)
        dec1 = self._up("decoder3", dec2, enc2)
        dec0 = self._up("decoder2", dec1, enc1)
        out = self._up("decoder1", dec0, enc0)
        with torch.autocast(out.device.type, enabled=False):
            return self.out.conv(out.float()).permute(0, 2, 3, 4, 1)
