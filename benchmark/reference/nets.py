"""Plain PyTorch statements of the benchmark's networks, over a dict of
named tensors.

- ``resnet``: the ResNet encoder with the grayscale ImageNet stem (7×7
  stride-2 convolution, BatchNorm, ReLU, 3×3 stride-2 max-pool), basic
  blocks of two 3×3 convolutions and a 1×1 projection where the shape
  changes, global average pooling (He et al., arXiv:1512.03385).
- ``mlp``: the BYOL projector and predictor, Linear → BatchNorm1d → ReLU →
  Linear (Grill et al., arXiv:2006.07733).
- ``unet``: the U-Net of ``segmentation_models_pytorch.Unet`` with a ResNet
  encoder: five decoder blocks, each a 2× nearest upsample, the skip
  concatenated after it, and two 3×3 convolution + BatchNorm + ReLU; a 3×3
  head with a bias (Ronneberger et al., arXiv:1505.04597).

The names of the tensors are the program's state-dict names, so one dict
of weights drives both sides. Inputs are NHWC, as the program takes them.
BatchNorm in training takes the batch's statistics with the biased
variance; with ``group`` (a ``torch.distributed`` group) the statistics
are those of every rank's rows, through a differentiable all-reduce of the
sums. In eval it takes the running statistics.

``precision`` is ``"f32"`` (the reference: float32 with TF32 off, which
the caller sets), ``"bf16"`` (for a look at what the configuration's own
precision does to the step: every convolution's and matrix product's
operands and result rounded to bfloat16, and the gradient at each of
those roundings too, as bf16 autocast computes forward and backward) or
``"fp8"`` (the control: the same operands and results rounded to float8
e4m3 with a per-tensor scale, the products taken in float32; the backward
passes the gradient straight through the rounding, in float32, as scaled
float8 training keeps it).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
STAGES = {"resnet18": (2, 2, 2, 2)}
WIDTHS = (64, 128, 256, 512)


@contextlib.contextmanager
def exact_f32():
    """Float32 as the reference computes it: TF32 off for matrix products
    and convolutions, and cuDNN's heuristic choice of algorithm (a search
    over float32 algorithms at these sizes takes minutes). The flags are
    put back after."""
    b = torch.backends
    saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.benchmark)
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = b.cudnn.benchmark = False
    try:
        yield
    finally:
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.benchmark = saved


@torch.no_grad()
def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale (amax to 448)."""
    scale = x.abs().amax().clamp_min(1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class _RoundBF16(torch.autograd.Function):
    """Rounded to bfloat16 both ways: the value forward, its gradient back."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def _q(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "f32":
        return x
    if precision == "bf16":
        return _RoundBF16.apply(x)
    if precision != "fp8":
        raise ValueError(f"unknown precision {precision!r}")
    return x + (round_fp8(x) - x).detach()


def conv(x, w, stride=1, padding=0, bias=None, precision="f32"):
    return _q(F.conv2d(_q(x, precision), _q(w, precision), bias, stride, padding), precision)


def linear(x, w, b=None, precision="f32"):
    return _q(F.linear(_q(x, precision), _q(w, precision), b), precision)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed.nn.functional as dist_fn

    return dist_fn.all_reduce(t, group=group)


def batch_norm(x, P: Dict[str, torch.Tensor], name: str, training: bool, group=None, stats=None):
    """``x`` (N, C, ...) normalized per channel, then scaled and shifted.
    ``stats`` (a dict) takes the statistics each layer normalized with, in
    training, by name: the batch's mean and biased variance (every rank's
    rows with ``group``)."""
    w, b = P[f"{name}.weight"], P[f"{name}.bias"]
    shape = (1, -1) + (1,) * (x.ndim - 2)
    dims = [0, *range(2, x.ndim)]
    if not training:
        mean, var = P[f"{name}.running_mean"], P[f"{name}.running_var"]
        return (x - mean.view(shape)) * torch.rsqrt(var.view(shape) + BN_EPS) * w.view(shape) + b.view(shape)
    if group is None:
        if stats is not None:
            stats[name] = (x.detach().mean(dims), x.detach().var(dims, unbiased=False))
        return F.batch_norm(x, None, None, w, b, True, 0.0, BN_EPS)
    n = torch.tensor(float(x.numel() // x.shape[1]), device=x.device)
    s1, s2, n = _all_reduce(x.sum(dims), group), _all_reduce((x * x).sum(dims), group), _all_reduce(n, group)
    mean = s1 / n
    var = s2 / n - mean * mean
    if stats is not None:
        stats[name] = (mean.detach(), var.detach())
    return (x - mean.view(shape)) * torch.rsqrt(var.view(shape) + BN_EPS) * w.view(shape) + b.view(shape)


def _block(x, P, name, stride, training, group, precision, stats):
    y = conv(x, P[f"{name}.conv1.weight"], stride, 1, precision=precision)
    y = torch.relu(batch_norm(y, P, f"{name}.bn1", training, group, stats))
    y = conv(y, P[f"{name}.conv2.weight"], 1, 1, precision=precision)
    y = batch_norm(y, P, f"{name}.bn2", training, group, stats)
    if f"{name}.downsample_conv.weight" in P:
        x = batch_norm(conv(x, P[f"{name}.downsample_conv.weight"], stride, precision=precision),
                       P, f"{name}.downsample_bn", training, group, stats)
    return torch.relu(y + x)


def resnet(x_nhwc, P, prefix: str, arch: str = "resnet18", training: bool = True, group=None,
           precision: str = "f32", pyramid: bool = False, stats=None):
    """Pooled (B, 512) features, or with ``pyramid`` the NCHW maps at
    strides 2 (the stem, before its max-pool), 4, 8, 16 and 32."""
    x = x_nhwc.permute(0, 3, 1, 2)
    x = conv(x, P[f"{prefix}conv1.weight"], 2, 3, precision=precision)
    x = torch.relu(batch_norm(x, P, f"{prefix}bn1", training, group, stats))
    maps = [x]
    x = F.max_pool2d(x, 3, 2, 1)
    for i, n_blocks in enumerate(STAGES[arch]):
        for j in range(n_blocks):
            stride = 2 if (i > 0 and j == 0) else 1
            x = _block(x, P, f"{prefix}layer{i + 1}.{j}", stride, training, group, precision, stats)
        maps.append(x)
    return maps if pyramid else x.mean(dim=(2, 3))


def mlp(x, P, prefix: str, training: bool = True, group=None, precision: str = "f32", stats=None):
    h = linear(x, P[f"{prefix}fc1.weight"], P[f"{prefix}fc1.bias"], precision)
    h = torch.relu(batch_norm(h, P, f"{prefix}bn", training, group, stats))
    return linear(h, P[f"{prefix}fc2.weight"], P[f"{prefix}fc2.bias"], precision)


def unet(x_nhwc, P, arch: str = "resnet18", precision: str = "f32", stats=None):
    """Eval-mode (B, H, W, classes) logits; with ``stats``, a train-mode
    forward that records each BatchNorm's batch statistics there."""
    training = stats is not None
    maps = resnet(x_nhwc, P, "encoder.", arch, training, precision=precision, pyramid=True, stats=stats)
    skips: List[Optional[torch.Tensor]] = maps[-2::-1] + [None]
    y = maps[-1]
    for i, skip in enumerate(skips):
        y = F.interpolate(y, scale_factor=2, mode="nearest")
        if skip is not None:
            y = torch.cat([y, skip], dim=1)
        for k in (1, 2):
            y = conv(y, P[f"decoder.{i}.conv{k}.weight"], 1, 1, precision=precision)
            y = torch.relu(batch_norm(y, P, f"decoder.{i}.bn{k}", training, stats=stats))
    y = conv(y, P["head.weight"], 1, 1, P["head.bias"], precision=precision)
    return y.permute(0, 2, 3, 1)
