"""Depth sharding of volumes: the halo exchange of 3D convolutions over a
``space`` group. Counterpart of ``parallel/mesh.py::spatial_sharding``.

The JAX package shards volumes over batch and depth on a ``("data",
"space")`` mesh and lets GSPMD insert the exchanges that a convolution
needs at the edges of each depth slab. Here every rank holds one
contiguous slab of depth (``parallel/mesh.py::depth_slab``) and
``halo_exchange`` fetches the neighbours' facing slices before a
convolution that runs with no depth padding of its own. At the two global
ends the halo is zeros, the convolution's own zero padding.

The transfer is one all-reduce of a zero-filled slot buffer: each rank
writes the slices its neighbours need into its own slot, the sum over the
group then holds every rank's slices, and each rank reads its neighbours'
slots. Every slot has one writer, so the sum adds only zeros and is exact
in any dtype. All-reduce is what gloo carries on card tensors (ranks that
share a card) and what the CPU tests run, so one route serves both
backends; it moves S slots where point-to-point transfers would move two
(the price of that route, recorded in PERF.md).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from medical_image_segmentation_tpu_torch.parallel.mesh import all_reduce_


def _slots(x: torch.Tensor, group, left: int, right: int):
    """(S, B, right + left, H, W, C) zeros in ``x``'s dtype and device,
    this rank's index and the group's size."""
    b, c, _, h, w = x.shape
    n, me = dist.get_world_size(group), dist.get_rank(group)
    return torch.zeros((n, b, right + left, h, w, c), dtype=x.dtype, device=x.device), me, n


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, left, right):
        ctx.group, ctx.left, ctx.right = group, left, right
        d = x.shape[2]
        if d < max(left, right):
            raise ValueError(f"a depth slab of {d} cannot give a halo of ({left}, {right})")
        xl = x.permute(0, 2, 3, 4, 1)  # (B, d, H, W, C): contiguous when x is channels_last_3d
        buf, me, n = _slots(x, group, left, right)
        buf[me, :, :right] = xl[:, :right]          # my first slices: the left neighbour's right halo
        buf[me, :, right:] = xl[:, d - left:]       # my last slices: the right neighbour's left halo
        all_reduce_(buf, group)
        ends = buf.new_zeros((buf.shape[1], max(left, right), *buf.shape[3:]))  # the global ends' zero padding
        lo = buf[me - 1, :, right:] if me > 0 else ends[:, :left]
        hi = buf[me + 1, :, :right] if me < n - 1 else ends[:, :right]
        return torch.cat([lo, xl, hi], dim=1).permute(0, 4, 1, 2, 3)

    @staticmethod
    def backward(ctx, grad):
        left, right = ctx.left, ctx.right
        gl = grad.permute(0, 2, 3, 4, 1)
        d = gl.shape[1] - left - right
        buf, me, n = _slots(grad, ctx.group, left, right)
        if me > 0:       # my left halo came from the left neighbour's last slices
            buf[me - 1, :, right:] = gl[:, :left]
        if me < n - 1:   # my right halo from the right neighbour's first slices
            buf[me + 1, :, :right] = gl[:, left + d:]
        all_reduce_(buf, ctx.group)
        dx = gl[:, left:left + d].clone()
        dx[:, :right] += buf[me, :, :right]
        dx[:, d - left:] += buf[me, :, right:]
        return dx.permute(0, 4, 1, 2, 3), None, None, None


def halo_exchange(x: torch.Tensor, group, left: int, right: int) -> torch.Tensor:
    """NCDHW depth slab ``x`` with ``left`` slices of the previous rank of
    ``group`` before it and ``right`` of the next after it (zeros at the
    global ends): (B, C, left + d + right, H, W), channels_last_3d. Every
    rank of ``group`` must call it with the same ``left`` and ``right``;
    the backward sends each halo's gradient back to the rank it came from."""
    return _HaloExchange.apply(x, group, left, right)
