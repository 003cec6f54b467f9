"""InstanceNorm + LeakyReLU, nnU-Net's norm: the wrapper of the hand-written
Hopper kernels ``csrc/instance_norm.cu`` and their plain PyTorch versions.

For each (sample, channel) of a (B, C, ...) activation, over the sample's
N voxels:

1. ``statistics``: float32 mean and invstd = 1/sqrt(var + eps), the
   variance biased;
2. ``normalize``: y = LeakyReLU((x − mean)·invstd·w + b) in float32,
   rounded once to x's dtype, channels-last;
3. ``backward_reduce``: with x̂ and the activation's slope recomputed from x
   and the (B, C) statistics, g = dy·slope; the float32 sums [Σg | Σg·x̂]
   of each sample (B, 2C), and their sums over samples, the bias's and the
   weight's gradients;
4. ``backward_elemt``: dx = (w·invstd)·((g − Σg/n) − x̂·(Σg·x̂/n)).

``instance_norm_leaky_relu`` is the autograd function over them, which
saves only x and the (B, C) mean and invstd for the backward.

The kernels see the input as the (B, N, C) channels-last view of x (a
``channels_last_3d`` 5-D tensor), in bfloat16 or float32; they read and
write x's dtype and sum in float32. An activation in another layout is
copied into channels-last first, and so is a gradient that autograd hands
over in another layout; ``x_copies`` and ``dy_copies`` count those copies.
On a CUDA tensor each function launches the kernels or raises; on a CPU
tensor it runs the plain version, the same arithmetic in float32 with one
rounding at the end. ``launches`` counts kernel launches; under a profiler
each call also adds them to the ``norm.instance_kernels`` counter
(``core/profiling.py::count``). The kernels follow the instance's size:
up to ``FUSED_VOXELS`` voxels a sample the forward and the backward are
one kernel each (``fused_forward``, ``fused_backward``); above, three
each (``statistics``: partial moments over row slabs, then their merge;
``normalize``; ``backward_reduce``: partial sums, then their merge;
``backward_elemt``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from medical_image_segmentation_tpu_torch.core.profiling import count

FUSED_VOXELS = 1024  # above it a block of the one-kernel path reads too many rows alone
launches = 0
x_copies = 0
dy_copies = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _rows(x: torch.Tensor) -> torch.Tensor:
    """The (B, N, C) channels-last view of (B, C, ...) ``x`` (a copy where
    x is not channels-last)."""
    return x.movedim(1, -1).reshape(x.shape[0], -1, x.shape[1])


def _channels(t: torch.Tensor) -> torch.Tensor:
    """(B, C) values as (B, 1, C), against the (B, N, C) view."""
    return t.unsqueeze(1)


def statistics_reference(x: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, invstd) of each (sample, channel) of (B, C, ...) ``x``, float32 (B, C)."""
    var, mean = torch.var_mean(_rows(x).float(), dim=1, correction=0)
    return mean, 1.0 / torch.sqrt(var + eps)


def _xhat(x, mean, invstd) -> torch.Tensor:
    return (_rows(x).float() - _channels(mean)) * _channels(invstd)


def _affine(xhat, weight, bias) -> torch.Tensor:
    return xhat * weight.float() + bias.float()


def _back(rows: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B, N, C) rows as (B, C, ...) in x's shape, channels-last."""
    return rows.reshape(x.shape[0], *x.shape[2:], x.shape[1]).movedim(-1, 1)


def normalize_reference(x, weight, bias, mean, invstd, slope: float) -> torch.Tensor:
    z = _affine(_xhat(x, mean, invstd), weight, bias)
    return _back(F.leaky_relu(z, slope).to(x.dtype), x)


def _through(x, dy, weight, bias, mean, invstd, slope: float):
    """(x̂, g): the gradient through the activation, float32 (B, N, C)."""
    xhat = _xhat(x, mean, invstd)
    dyf = _rows(dy).float()
    return xhat, torch.where(_affine(xhat, weight, bias) > 0, dyf, dyf * slope)


def backward_reduce_reference(x, dy, weight, bias, mean, invstd, slope: float) -> torch.Tensor:
    """[Σg | Σg·x̂] of each sample, float32 (B, 2C)."""
    xhat, g = _through(x, dy, weight, bias, mean, invstd, slope)
    return torch.cat([g.sum(1), (g * xhat).sum(1)], dim=1)


def backward_elemt_reference(x, dy, weight, bias, mean, invstd, sums, slope: float) -> torch.Tensor:
    c = x.shape[1]
    xhat, g = _through(x, dy, weight, bias, mean, invstd, slope)
    n = torch.full((1,), float(xhat.shape[1]), dtype=torch.float32, device=x.device)
    k = weight.float() * invstd
    dx = _channels(k) * ((g - _channels(sums[:, :c] / n)) - xhat * _channels(sums[:, c:] / n))
    return _back(dx.to(x.dtype), x)


def _on_card(x: torch.Tensor) -> bool:
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
    raise RuntimeError(f"no InstanceNorm implementation for device {x.device}")


def _lib():
    from medical_image_segmentation_tpu_torch.ops._kernels import load_kernel_library

    return load_kernel_library("instance_norm")


@functools.lru_cache(maxsize=256)
def _work_floats(b: int, n: int, c: int, dtype: torch.dtype, device: torch.device) -> int:
    """The float32 scratch of the two-pass sums over a (b, n, c) activation
    on ``device``: a row of 2c partial sums for each row slab of each
    sample, whose number the kernels choose from b, n, c and the card's SM
    count."""
    floats = ctypes.c_longlong()
    with torch.cuda.device(device):
        err = _lib().mis_in_work_floats(b, n, c, _DTYPES[dtype], ctypes.byref(floats))
    if err != 0:
        raise ValueError(f"instance_norm cannot cut ({b}, {n}, {c}) {dtype}: CUDA error {err}")
    return floats.value


def _launched(err: int, what: str, kernels: int) -> None:
    global launches
    if err != 0:
        raise RuntimeError(f"instance_norm {what} launch failed: CUDA error {err}")
    launches += kernels
    count("norm.instance_kernels", kernels)


def _aligned_rows(t: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """The (B, N, C) rows of ``t`` contiguous on a 16-byte boundary (the
    kernels load 16 bytes at a time), and whether that took a copy."""
    rows = t.movedim(1, -1)
    copied = not rows.is_contiguous() or rows.data_ptr() % 16 != 0
    if copied:
        rows = rows.clone(memory_format=torch.contiguous_format)
    return rows.view(t.shape[0], -1, t.shape[1]), copied


def _geometry(x: torch.Tensor):
    """(rows of x, B, N, C) for the kernels; raises on what they do not take."""
    global x_copies
    if x.dtype not in _DTYPES:
        raise TypeError(f"InstanceNorm kernels take bfloat16 or float32, got {x.dtype}")
    if x.ndim < 3 or x.numel() == 0:
        raise ValueError(f"InstanceNorm kernels take a non-empty (B, C, ...) tensor, got shape {tuple(x.shape)}")
    rows, copied = _aligned_rows(x)
    x_copies += copied
    return rows, rows.shape[0], rows.shape[1], rows.shape[2]


def _gradient(dy: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``dy``'s (B, N, C) rows (autograd may hand it in another layout)."""
    global dy_copies
    if (dy.shape, dy.dtype, dy.device) != (x.shape, x.dtype, x.device):
        raise ValueError(f"expected {tuple(x.shape)} {x.dtype} on {x.device}, "
                         f"got {tuple(dy.shape)} {dy.dtype} on {dy.device}")
    rows, copied = _aligned_rows(dy)
    dy_copies += copied
    return rows


def _vectors(c: int, device, **tensors) -> None:
    for name, t in tensors.items():
        if t.dtype != torch.float32 or t.device != device or not t.is_contiguous() or t.numel() != c:
            raise ValueError(f"{name} must be {c} contiguous float32 values on {device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


def statistics(x: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, invstd), float32 (B, C): two kernels."""
    if not _on_card(x):
        return statistics_reference(x, eps)
    rows, b, n, c = _geometry(x)
    floats = _work_floats(b, n, c, x.dtype, x.device)
    work = torch.empty(floats, dtype=torch.float32, device=x.device)
    mean = torch.empty(b, c, dtype=torch.float32, device=x.device)
    invstd = torch.empty_like(mean)
    with torch.cuda.device(x.device):
        err = _lib().mis_in_stats(rows.data_ptr(), b, n, c, _DTYPES[x.dtype], float(eps), work.data_ptr(),
                                  work.numel(), mean.data_ptr(), invstd.data_ptr(), _stream(x))
    _launched(err, "statistics", 2)
    return mean, invstd


def normalize(x, weight, bias, mean, invstd, slope: float) -> torch.Tensor:
    """y, in x's shape and dtype, channels-last: one kernel."""
    if not _on_card(x):
        return normalize_reference(x, weight, bias, mean, invstd, slope)
    rows, b, n, c = _geometry(x)
    _vectors(c, x.device, weight=weight, bias=bias)
    _vectors(b * c, x.device, mean=mean, invstd=invstd)
    y = torch.empty_like(rows)
    with torch.cuda.device(x.device):
        err = _lib().mis_in_normalize(rows.data_ptr(), mean.data_ptr(), invstd.data_ptr(), weight.data_ptr(),
                                      bias.data_ptr(), y.data_ptr(), b, n, c, _DTYPES[x.dtype], float(slope),
                                      _stream(x))
    _launched(err, "normalize", 1)
    return _back(y, x)


def backward_reduce(x, dy, weight, bias, mean, invstd, slope: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sums, grad_weight, grad_bias): [Σg | Σg·x̂] float32 (B, 2C), and
    their sums over samples: two kernels."""
    if not _on_card(x):
        sums = backward_reduce_reference(x, dy, weight, bias, mean, invstd, slope)
        c = x.shape[1]
        return sums, sums[:, c:].sum(0), sums[:, :c].sum(0)
    rows, b, n, c = _geometry(x)
    dys = _gradient(dy, x)
    _vectors(c, x.device, weight=weight, bias=bias)
    _vectors(b * c, x.device, mean=mean, invstd=invstd)
    floats = _work_floats(b, n, c, x.dtype, x.device)
    work = torch.empty(floats, dtype=torch.float32, device=x.device)
    sums = torch.empty(b, 2 * c, dtype=torch.float32, device=x.device)
    grad_weight = torch.empty(c, dtype=torch.float32, device=x.device)
    grad_bias = torch.empty_like(grad_weight)
    with torch.cuda.device(x.device):
        err = _lib().mis_in_backward_reduce(
            rows.data_ptr(), dys.data_ptr(), mean.data_ptr(), invstd.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            b, n, c, _DTYPES[x.dtype], float(slope), work.data_ptr(), work.numel(), sums.data_ptr(),
            grad_weight.data_ptr(), grad_bias.data_ptr(), _stream(x))
    _launched(err, "backward reduce", 2)
    return sums, grad_weight, grad_bias


def backward_elemt(x, dy, weight, bias, mean, invstd, sums, slope: float) -> torch.Tensor:
    """dx, in x's shape and dtype, channels-last: one kernel."""
    if not _on_card(x):
        return backward_elemt_reference(x, dy, weight, bias, mean, invstd, sums, slope)
    rows, b, n, c = _geometry(x)
    dys = _gradient(dy, x)
    _vectors(c, x.device, weight=weight, bias=bias)
    _vectors(b * c, x.device, mean=mean, invstd=invstd)
    _vectors(b * 2 * c, x.device, sums=sums)
    dx = torch.empty_like(rows)
    with torch.cuda.device(x.device):
        err = _lib().mis_in_backward_elemt(
            rows.data_ptr(), dys.data_ptr(), mean.data_ptr(), invstd.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            sums.data_ptr(), dx.data_ptr(), b, n, c, _DTYPES[x.dtype], float(slope), _stream(x))
    _launched(err, "backward elemt", 1)
    return _back(dx, x)


def fused_forward(x, weight, bias, eps: float, slope: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, mean, invstd) in one kernel: a block reads all of an instance's
    rows (``forward`` takes it up to ``FUSED_VOXELS`` voxels a sample)."""
    rows, b, n, c = _geometry(x)
    _vectors(c, x.device, weight=weight, bias=bias)
    y = torch.empty_like(rows)
    mean = torch.empty(b, c, dtype=torch.float32, device=x.device)
    invstd = torch.empty_like(mean)
    with torch.cuda.device(x.device):
        err = _lib().mis_in_fused_forward(rows.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
                                          mean.data_ptr(), invstd.data_ptr(), b, n, c, _DTYPES[x.dtype], float(eps),
                                          float(slope), _stream(x))
    _launched(err, "fused forward", 1)
    return _back(y, x), mean, invstd


def fused_backward(x, dy, weight, bias, mean, invstd, slope: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, sums, grad_weight, grad_bias) in one kernel (``backward`` takes
    it up to ``FUSED_VOXELS`` voxels a sample)."""
    rows, b, n, c = _geometry(x)
    dys = _gradient(dy, x)
    _vectors(c, x.device, weight=weight, bias=bias)
    _vectors(b * c, x.device, mean=mean, invstd=invstd)
    dx = torch.empty_like(rows)
    sums = torch.empty(b, 2 * c, dtype=torch.float32, device=x.device)
    grad_weight = torch.empty(c, dtype=torch.float32, device=x.device)
    grad_bias = torch.empty_like(grad_weight)
    with torch.cuda.device(x.device):
        err = _lib().mis_in_fused_backward(
            rows.data_ptr(), dys.data_ptr(), mean.data_ptr(), invstd.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            sums.data_ptr(), grad_weight.data_ptr(), grad_bias.data_ptr(), dx.data_ptr(), b, n, c, _DTYPES[x.dtype],
            float(slope), _stream(x))
    _launched(err, "fused backward", 1)
    return _back(dx, x), sums, grad_weight, grad_bias


def _fused(x: torch.Tensor) -> bool:
    return x.numel() // (x.shape[0] * x.shape[1]) <= FUSED_VOXELS


def forward(x, weight, bias, eps: float, slope: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, mean, invstd): one kernel for a small instance, three above."""
    if _on_card(x) and _fused(x):
        return fused_forward(x, weight, bias, eps, slope)
    mean, invstd = statistics(x, eps)
    return normalize(x, weight, bias, mean, invstd, slope), mean, invstd


def backward(x, dy, weight, bias, mean, invstd, slope: float
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, grad_weight, grad_bias): one kernel for a small instance, three
    above; dy copied into channels-last at most once."""
    if _on_card(x):
        dy = _back(_gradient(dy, x), x)
        if _fused(x):
            dx, _, grad_weight, grad_bias = fused_backward(x, dy, weight, bias, mean, invstd, slope)
            return dx, grad_weight, grad_bias
    sums, grad_weight, grad_bias = backward_reduce(x, dy, weight, bias, mean, invstd, slope)
    return backward_elemt(x, dy, weight, bias, mean, invstd, sums, slope), grad_weight, grad_bias


def launches_per_call(x: torch.Tensor) -> int:
    """Kernels a forward (and as many a backward) of ``x``'s shape launches on the card."""
    return 1 if _fused(x) else 3


class _InstanceNormLeakyReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps, slope):
        with torch.autocast(x.device.type, enabled=False):
            y, mean, invstd = forward(x, weight, bias, eps, slope)
        ctx.save_for_backward(x, weight, bias, mean, invstd)
        ctx.slope = slope
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight, bias, mean, invstd = ctx.saved_tensors
        with torch.autocast(x.device.type, enabled=False):
            dx, grad_weight, grad_bias = backward(x, dy, weight, bias, mean, invstd, ctx.slope)
        return dx, grad_weight.to(weight.dtype), grad_bias.to(bias.dtype), None, None


def instance_norm_leaky_relu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                             slope: float) -> torch.Tensor:
    """LeakyReLU(InstanceNorm(x)·w + b) over dim 1 of (B, C, ...) ``x``, in
    x's dtype, channels-last."""
    return _InstanceNormLeakyReLU.apply(x, weight, bias, eps, slope)
