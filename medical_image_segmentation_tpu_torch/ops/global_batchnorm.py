"""Training BatchNorm's four passes: the wrapper of the hand-written Hopper
kernels ``csrc/global_batchnorm.cu`` and their plain PyTorch versions.

Data-parallel training (``models/batchnorm.py`` with a ``group``) takes
BatchNorm's statistics over every rank's rows, as XLA does over a sharded
batch; one card's training (no group) runs the same passes with no
all-reduce between them. For each layer:

1. ``batch_stats``: this rank's float32 (Σx, Σx², n) in one (2C + 1,)
   buffer, which the caller all-reduces in place;
2. ``normalize``: from the all-reduced buffer, mean = Σx/n, flax's variance
   max(Σx²/n − mean², 0) and invstd = rsqrt(var + eps); the running
   statistics' momentum update (none when ``running`` is None); then
   y = ((x − mean)·invstd)·w + b in float32, rounded once to x's dtype;
3. ``backward_reduce``: this rank's (Σdy, Σdy·x̂) in one (2C,) buffer for
   the all-reduce, x̂ recomputed, and copies of them, which are the bias's
   and the scale's gradients;
4. ``backward_elemt``: dx = (w·invstd)·(dy − Σdy/n − x̂·Σdy·x̂/n) from the
   all-reduced sums.

The kernels see the input as an (M, C) row-major matrix: a 2-D (N, C)
tensor, a 4-D ``channels_last`` or a 5-D ``channels_last_3d`` one, in
bfloat16 or float32 (``kernel_layout``); anything else on the card raises.
They read and write the activation's dtype and sum in float32. On a CUDA
tensor each function launches the kernels or raises; on a CPU tensor it
runs the plain version, the float32 arithmetic that the global path had
before the kernels (``takes`` says whether a tensor goes to the kernels).
``launches`` counts the global path's kernel launches and
``local_launches`` those of calls made with ``local=True`` (one card);
under a profiler each call also adds them to the ``bn.global_kernels`` or
``bn.local_kernels`` counter (``core/profiling.py::count``): two for
``batch_stats`` and ``backward_reduce`` (a pass of partial sums over row
slabs, then a deterministic pass over the slabs), one for ``normalize``
and ``backward_elemt``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from medical_image_segmentation_tpu_torch.core.profiling import count

launches = 0
local_launches = 0

_LAYOUTS = {2: torch.contiguous_format, 4: torch.channels_last, 5: torch.channels_last_3d}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _dims(x: torch.Tensor):
    return [0, *range(2, x.ndim)]


def _channel_view(x: torch.Tensor):
    return (1, -1) + (1,) * (x.ndim - 2)


def stats_reference(x: torch.Tensor) -> torch.Tensor:
    """This rank's [Σx, Σx², n] per channel of (N, C, ...) ``x``, float32."""
    c = x.shape[1]
    xf = x.float()
    return torch.cat([xf.sum(_dims(x)), xf.square().sum(_dims(x)),
                      torch.full((1,), x.numel() // c, dtype=torch.float32, device=x.device)])


def moments_reference(stats: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean, biased variance, invstd) from an all-reduced [Σx, Σx², n]."""
    c = (stats.numel() - 1) // 2
    n = stats[-1]
    mean = stats[:c] / n
    var = (stats[c:2 * c] / n - mean.square()).clamp_min(0.0)
    return mean, var, torch.rsqrt(var + eps)


def normalize_reference(x, weight, bias, mean, invstd) -> torch.Tensor:
    shape = _channel_view(x)
    xhat = (x.float() - mean.view(shape)) * invstd.view(shape)
    return (xhat * weight.view(shape) + bias.view(shape)).to(x.dtype)


def backward_reduce_reference(x, dy, mean, invstd) -> torch.Tensor:
    """This rank's [Σdy, Σdy·x̂] per channel, float32."""
    shape = _channel_view(x)
    dyf = dy.float()
    xhat = (x.float() - mean.view(shape)) * invstd.view(shape)
    return torch.cat([dyf.sum(_dims(x)), (dyf * xhat).sum(_dims(x))])


def backward_elemt_reference(x, dy, weight, mean, invstd, sums, n) -> torch.Tensor:
    shape = _channel_view(x)
    c = x.shape[1]
    dyf = dy.float()
    xhat = (x.float() - mean.view(shape)) * invstd.view(shape)
    dx = (weight * invstd).view(shape) * (dyf - (sums[:c] / n).view(shape) - xhat * (sums[c:] / n).view(shape))
    return dx.to(x.dtype)


def kernel_layout(x: torch.Tensor) -> torch.memory_format:
    """The memory format in which the kernels read ``x`` as an (M, C)
    row-major matrix; raises on a dtype or layout they do not take."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"global BatchNorm kernels take bfloat16 or float32, got {x.dtype}")
    fmt = _LAYOUTS.get(x.ndim)
    if fmt is None or not x.is_contiguous(memory_format=fmt):
        raise ValueError("global BatchNorm kernels take a contiguous 2-D, a channels_last 4-D or a "
                         f"channels_last_3d 5-D tensor, got shape {tuple(x.shape)} strides {x.stride()}")
    if x.numel() == 0:
        raise ValueError(f"global BatchNorm kernels take no empty tensor, got shape {tuple(x.shape)}")
    return fmt


def takes(x: torch.Tensor) -> bool:
    """Whether ``x`` goes to the kernels as it is: a CUDA tensor whose dtype
    and layout ``kernel_layout`` takes."""
    if not x.is_cuda:
        return False
    try:
        kernel_layout(x)
    except (TypeError, ValueError):
        return False
    return True


def _on_card(x: torch.Tensor) -> bool:
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
    raise RuntimeError(f"no global BatchNorm implementation for device {x.device}")


def _lib():
    from medical_image_segmentation_tpu_torch.ops._kernels import load_kernel_library

    return load_kernel_library("global_batchnorm")


@functools.lru_cache(maxsize=256)
def _work_floats(m: int, c: int, dtype: torch.dtype, device: torch.device) -> int:
    """The float32 scratch of the two-pass sums over an (m, c) matrix on
    ``device``: a row of 2c partial sums for each row slab, whose number
    the kernels choose from m, c and the card's SM count."""
    floats = ctypes.c_longlong()
    with torch.cuda.device(device):
        err = _lib().mis_gbn_work_floats(m, c, _DTYPES[dtype], ctypes.byref(floats))
    if err != 0:
        raise ValueError(f"global_batchnorm cannot cut ({m}, {c}) {dtype}: CUDA error {err}")
    return floats.value


def _aligned(t: torch.Tensor, fmt) -> torch.Tensor:
    """``t`` in ``fmt`` on a 16-byte boundary: the kernels load 16 bytes at
    a time."""
    t = t.contiguous(memory_format=fmt)
    return t if t.data_ptr() % 16 == 0 else t.clone(memory_format=fmt)


def _gradient(dy: torch.Tensor, x: torch.Tensor, fmt) -> torch.Tensor:
    """``dy`` in the activation's layout (autograd may hand it another)."""
    if (dy.shape, dy.dtype, dy.device) != (x.shape, x.dtype, x.device):
        raise ValueError(f"expected {tuple(x.shape)} {x.dtype} on {x.device}, "
                         f"got {tuple(dy.shape)} {dy.dtype} on {dy.device}")
    return _aligned(dy, fmt)


def _channels(c: int, device, **tensors) -> None:
    for name, t in tensors.items():
        if t.dtype != torch.float32 or t.device != device or not t.is_contiguous() or t.numel() != c:
            raise ValueError(f"{name} must be {c} contiguous float32 values on {device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")


def _launched(err: int, what: str, kernels: int, local: bool = False) -> None:
    global launches, local_launches
    if err != 0:
        raise RuntimeError(f"global_batchnorm {what} launch failed: CUDA error {err}")
    if local:
        local_launches += kernels
        count("bn.local_kernels", kernels)
    else:
        launches += kernels
        count("bn.global_kernels", kernels)


def _geometry(x: torch.Tensor):
    fmt = kernel_layout(x)
    return _aligned(x, fmt), fmt, x.numel() // x.shape[1], x.shape[1]


def batch_stats(x: torch.Tensor, *, local: bool = False) -> torch.Tensor:
    """This rank's float32 [Σx (C), Σx² (C), n] of (N, C, ...) ``x``;
    ``local`` counts the launches as the one-card path's."""
    if not _on_card(x):
        return stats_reference(x)
    x, _, m, c = _geometry(x)
    work = torch.empty(_work_floats(m, c, x.dtype, x.device), dtype=torch.float32, device=x.device)
    out = torch.empty(2 * c + 1, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib().mis_gbn_stats(x.data_ptr(), m, c, _DTYPES[x.dtype], work.data_ptr(), work.numel(),
                                   out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    _launched(err, "stats", 2, local)
    return out


def normalize(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, stats: torch.Tensor, eps: float,
              momentum: float, running: Optional[Tuple[torch.Tensor, torch.Tensor]] = None, *,
              local: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, mean, invstd) from the all-reduced ``stats``; with ``running`` =
    (running_mean, running_var), those take flax's momentum update in place
    (``momentum`` is the share of the old value)."""
    if not _on_card(x):
        mean, var, invstd = moments_reference(stats, eps)
        if running is not None:
            running[0].mul_(momentum).add_(mean, alpha=1.0 - momentum)
            running[1].mul_(momentum).add_(var, alpha=1.0 - momentum)
        return normalize_reference(x, weight, bias, mean, invstd), mean, invstd
    x, fmt, m, c = _geometry(x)
    rm, rv = running if running is not None else (None, None)
    _channels(c, x.device, weight=weight, bias=bias, **({} if running is None else dict(running_mean=rm,
                                                                                       running_var=rv)))
    _channels(2 * c + 1, x.device, stats=stats)
    y = torch.empty_like(x, memory_format=fmt)
    mean = torch.empty(c, dtype=torch.float32, device=x.device)
    invstd = torch.empty_like(mean)
    with torch.cuda.device(x.device):
        err = _lib().mis_gbn_normalize(
            x.data_ptr(), stats.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(), mean.data_ptr(),
            invstd.data_ptr(), None if rm is None else rm.data_ptr(), None if rv is None else rv.data_ptr(),
            float(momentum), float(1.0 - momentum), float(eps), m, c, _DTYPES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    _launched(err, "normalize", 1, local)
    return y, mean, invstd


def backward_reduce(x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor, invstd: torch.Tensor, *,
                    local: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sums, grad_weight, grad_bias): this rank's float32 [Σdy (C), Σdy·x̂
    (C)] for the all-reduce, and copies of its two halves."""
    if not _on_card(x):
        sums = backward_reduce_reference(x, dy, mean, invstd)
        c = x.shape[1]
        return sums, sums[c:].clone(), sums[:c].clone()
    x, fmt, m, c = _geometry(x)
    dy = _gradient(dy, x, fmt)
    _channels(c, x.device, mean=mean, invstd=invstd)
    work = torch.empty(_work_floats(m, c, x.dtype, x.device), dtype=torch.float32, device=x.device)
    sums = torch.empty(2 * c, dtype=torch.float32, device=x.device)
    grad_weight, grad_bias = torch.empty_like(mean), torch.empty_like(mean)
    with torch.cuda.device(x.device):
        err = _lib().mis_gbn_backward_reduce(
            x.data_ptr(), dy.data_ptr(), mean.data_ptr(), invstd.data_ptr(), m, c, _DTYPES[x.dtype],
            work.data_ptr(), work.numel(), sums.data_ptr(), grad_weight.data_ptr(), grad_bias.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    _launched(err, "backward reduce", 2, local)
    return sums, grad_weight, grad_bias


def backward_elemt(x: torch.Tensor, dy: torch.Tensor, weight: torch.Tensor, mean: torch.Tensor,
                   invstd: torch.Tensor, sums: torch.Tensor, n: torch.Tensor, *, local: bool = False
                   ) -> torch.Tensor:
    """dx from the all-reduced [Σdy, Σdy·x̂] and the global count ``n``
    (one float32 value)."""
    if not _on_card(x):
        return backward_elemt_reference(x, dy, weight, mean, invstd, sums, n)
    x, fmt, m, c = _geometry(x)
    dy = _gradient(dy, x, fmt)
    _channels(c, x.device, weight=weight, mean=mean, invstd=invstd)
    _channels(2 * c, x.device, sums=sums)
    _channels(1, x.device, n=n)
    dx = torch.empty_like(x, memory_format=fmt)
    with torch.cuda.device(x.device):
        err = _lib().mis_gbn_backward_elemt(
            x.data_ptr(), dy.data_ptr(), weight.data_ptr(), mean.data_ptr(), invstd.data_ptr(), sums.data_ptr(),
            n.data_ptr(), dx.data_ptr(), m, c, _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    _launched(err, "backward elemt", 1, local)
    return dx
