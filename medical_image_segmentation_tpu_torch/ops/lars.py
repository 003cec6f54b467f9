"""LARS as a ``torch.optim.Optimizer``. Port of ``ops/lars.py:40-118``.

Per parameter ``p`` with gradient ``g``:

1. Rank ≥ 2 (weights and conv kernels; ``make_lars_mask``) and
   ``weight_decay != 0``: trust ratio
   ``tr = trust_coefficient·||p|| / (||g|| + wd·||p|| + eps)``, 1.0 where
   either norm is 0, then ``g ← (g + wd·p)·tr``. Biases and norm parameters
   skip both decay and adaptation.
2. ``buf ← momentum·buf + g``; the update is ``g + momentum·buf`` with
   Nesterov, else ``buf``.
3. ``p ← p − lr·update``, with ``lr`` read from the param group (the BYOL
   task sets it from its schedule before each step).

A parameter whose ``.grad`` is ``None`` is updated as if its gradient were
zero, as optax sees it: a rank-≥2 one still decays through ``wd·p`` (its
gradient norm is 0, so tr = 1) and its momentum keeps moving. Skipping it,
as torch optimizers habitually do, would diverge from the reference
(RADIOLOGY_1M has no train labels, so its probe never gets a gradient).

Norms and the momentum buffer are f32. The per-tensor math runs as
``torch._foreach_*`` ops, a few launches per step for the whole model.
"""

from __future__ import annotations

from typing import Iterable

import torch


class LARS(torch.optim.Optimizer):
    def __init__(self, params: Iterable, lr: float = 1.0, weight_decay: float = 1e-6,
                 momentum: float = 0.9, trust_coefficient: float = 0.001, eps: float = 1e-8,
                 nesterov: bool = False):
        defaults = dict(lr=lr, weight_decay=weight_decay, momentum=momentum,
                        trust_coefficient=trust_coefficient, eps=eps, nesterov=nesterov)
        super().__init__(params, defaults)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("LARS.step takes no closure")
        for group in self.param_groups:
            params = list(group["params"])
            if not params:
                continue
            wd, m = group["weight_decay"], group["momentum"]
            grads = [p.grad.float() if p.grad is not None else torch.zeros_like(p, dtype=torch.float32)
                     for p in params]
            adapted = [i for i, p in enumerate(params) if p.ndim >= 2] if wd != 0.0 else []
            if adapted:
                pa = [params[i].float() for i in adapted]
                ga = [grads[i] for i in adapted]
                p_norm = torch.stack(torch._foreach_norm(pa))
                g_norm = torch.stack(torch._foreach_norm(ga))
                tr = group["trust_coefficient"] * p_norm / (g_norm + wd * p_norm + group["eps"])
                tr = torch.where((p_norm > 0) & (g_norm > 0), tr, torch.ones_like(tr))
                ga = torch._foreach_add(ga, pa, alpha=wd)
                torch._foreach_mul_(ga, list(tr.unbind(0)))
                for i, g in zip(adapted, ga):
                    grads[i] = g
            bufs = []
            for p in params:
                state = self.state[p]
                if "momentum_buffer" not in state:
                    state["momentum_buffer"] = torch.zeros_like(p, dtype=torch.float32)
                bufs.append(state["momentum_buffer"])
            torch._foreach_mul_(bufs, m)
            torch._foreach_add_(bufs, grads)
            updates = torch._foreach_add(grads, bufs, alpha=m) if group["nesterov"] else bufs
            torch._foreach_add_(params, updates, alpha=-group["lr"])
        return None
