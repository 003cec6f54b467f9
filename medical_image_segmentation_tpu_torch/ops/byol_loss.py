"""BYOL regression loss: ``2 - 2·cos(pred, target)``, averaged over the
batch, targets stop-gradiented. Port of ``ops/byol_loss.py:18-39``."""

from __future__ import annotations

import torch


def _safe_normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    """``x · rsqrt(Σx² + eps²)``: finite gradient at x = 0, where
    ``F.normalize``'s ``x / max(||x||, eps)`` is not."""
    return x * torch.rsqrt((x * x).sum(dim=-1, keepdim=True) + eps * eps)


def cosine_similarity_loss(preds: torch.Tensor, targets: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """2 - 2·cosine_similarity in f32, averaged over leading dims."""
    pn = _safe_normalize(preds.float(), eps)
    tn = _safe_normalize(targets.detach().float(), eps)
    return (2.0 - 2.0 * (pn * tn).sum(dim=-1)).mean()
