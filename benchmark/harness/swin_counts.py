"""Operations, bytes and counts of the Swin UNETR training cell, from the
configuration's shapes alone.

- A training step's FLOPs are three forwards (``harness/seg_counts.py``'s
  convention), each counted by ``torch.utils.flop_counter.FlopCounterMode``
  over the benchmark's plain network on the ``meta`` device: convolutions,
  transposed convolutions and every matrix product, window attention's
  included, over the padded tokens.
- Each Swin block attends over its tokens padded to a multiple of the
  window: ``attention_tokens`` and ``attention_pad_tokens`` are what the
  program's counters of those names count a forward.
- Window attention's least work a forward, for its roofline: 4·n·d FLOPs a
  padded query token and head (q·kᵀ and ·v over a window of n tokens at
  head width d), and in bytes q, k, v and the output each read or written
  once in the configuration's dtype, and the bias table (float32) once a
  block. The shift mask is left out: it depends only on the tokens'
  positions, so a kernel can compute it where it is used and never read
  it.
- The InstanceNorms' values a forward (batch × width × voxels of each
  norm's input) are counted in the same ``meta`` pass as the FLOPs, at
  each call of the plain network's InstanceNorm; the forward's least bytes
  read each value and write its output once in the configuration's dtype.
"""

from __future__ import annotations

import functools
import json
from typing import List, NamedTuple, Tuple
from unittest import mock

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import swin_unetr


class Block(NamedTuple):
    tokens: int  # padded tokens a crop
    real: int  # tokens a crop before padding
    n: int  # tokens a window
    windows: int
    heads: int
    head_dim: int
    shifted: bool
    name: str  # the block's prefix in the state dict


def blocks(cfg: dict) -> List[Block]:
    """Every Swin block's attention geometry, stage by stage."""
    w, f = cfg["window"], cfg["feature_size"]
    out = []
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["heads"])):
        dims = [s // 2 ** (i + 1) for s in cfg["patch"]]
        ws = [d if d <= w else w for d in dims]
        padded = [-(-d // k) * k for d, k in zip(dims, ws)]
        n = ws[0] * ws[1] * ws[2]
        tokens = padded[0] * padded[1] * padded[2]
        for j in range(depth):
            shifted = j % 2 == 1 and any(d > w for d in dims)
            out.append(Block(tokens, dims[0] * dims[1] * dims[2], n, tokens // n, heads, f * 2 ** i // heads,
                             shifted, f"swinViT.layers{i + 1}.0.blocks.{j}"))
    return out


def attention_tokens(cfg: dict, batch: int) -> int:
    return batch * sum(b.tokens for b in blocks(cfg))


def attention_pad_tokens(cfg: dict, batch: int) -> int:
    return batch * sum(b.tokens - b.real for b in blocks(cfg))


def attention_flops(cfg: dict, batch: int) -> float:
    """q·kᵀ and ·v of every block a forward."""
    return float(sum(batch * b.tokens * b.heads * 4 * b.n * b.head_dim for b in blocks(cfg)))


def attention_bytes(cfg: dict, batch: int) -> float:
    """q, k, v and o once each, and each block's bias table once."""
    item = getattr(torch, cfg["dtype"]).itemsize
    table = (2 * cfg["window"] - 1) ** 3 * 4
    return float(sum(4 * batch * b.tokens * b.heads * b.head_dim * item + table * b.heads for b in blocks(cfg)))


@functools.lru_cache(maxsize=8)
def _meta_pass(key: str, batch: int) -> Tuple[float, int]:
    """(FLOPs, InstanceNorm values) of one forward of the plain network on
    the ``meta`` device, for the configuration ``json.loads(key)``."""
    cfg = json.loads(key)
    P = {k: torch.empty(s, device="meta", dtype=torch.int64 if k.endswith("relative_position_index")
                        else torch.float32) for k, s in swin_unetr.layout(cfg).items()}
    x = torch.empty(batch, *cfg["patch"], cfg["in_channels"], device="meta")
    values = 0
    plain_norm = swin_unetr._in

    def counted_norm(t):
        nonlocal values
        values += t.numel()
        return plain_norm(t)

    with mock.patch.object(swin_unetr, "_in", counted_norm), FlopCounterMode(display=False) as counter:
        swin_unetr.forward(x, P, cfg)
    return float(counter.get_total_flops()), values


def _counts(cfg: dict, batch: int) -> Tuple[float, int]:
    return _meta_pass(json.dumps(cfg, sort_keys=True), batch)


def forward_flops(cfg: dict, batch: int) -> float:
    """One forward over ``batch`` crops of ``cfg["patch"]``."""
    return _counts(cfg, batch)[0]


def train_flops(cfg: dict, batch: int) -> float:
    return 3.0 * forward_flops(cfg, batch)


def instance_norm_values(cfg: dict, batch: int) -> int:
    """Values the InstanceNorms normalize in one forward."""
    return _counts(cfg, batch)[1]


def instance_norm_fwd_bytes(cfg: dict, batch: int) -> int:
    return 2 * getattr(torch, cfg["dtype"]).itemsize * instance_norm_values(cfg, batch)
