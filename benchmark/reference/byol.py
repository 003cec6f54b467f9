"""A plain BYOL training step: the benchmark's reference for the BYOL cells.

Per step (Grill et al., arXiv:2006.07733, as the reference trainer runs it):
the online network sees ``[v1; v2]`` and the target network ``[v2; v1]``;
the loss is ``2 − 2·cos(p, z_target)`` averaged over the rows, the target
stop-gradiented; LARS updates every online parameter (a parameter with no
gradient, the unlabelled probe's, as if its gradient were 0); then the
target's parameters move to ``τ·target + (1−τ)·online``.

LARS (You et al., arXiv:1708.03888, as the reference's
``train/optimizer/lars.py`` applies it): for a parameter of rank 2 or more,
``g ← (g + wd·p)·η·‖p‖/(‖g‖ + wd·‖p‖ + ε)`` (1 where either norm is 0);
then ``buf ← m·buf + g`` and ``p ← p − lr·buf``.

The schedules are closed forms of the step count: linear warmup then
cosine annealing of the learning rate over fractional epochs, and the
cosine EMA momentum from ``base`` to ``final`` over the run.

With ``group`` the rows are this rank's share of the global batch: the
BatchNorm statistics are the global batch's and the gradients are
averaged over the group, as one step on the whole batch makes them.

The online network's BatchNorm running statistics follow those each step
normalized with: ``r ← m·r + (1−m)·s`` for the mean and the biased
variance (``bn_momentum`` m, the share kept).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from benchmark.reference import nets


def lr_at(cfg: dict, step: int) -> float:
    spe = cfg["steps_per_epoch"]
    epoch = step / spe
    base, warm, top = cfg["learning_rate"], cfg["warmup_epochs"], cfg["max_epochs"]
    if epoch < warm:
        return epoch * base / max(warm - 1, 1)
    return 0.5 * base * (1.0 + math.cos(math.pi * (epoch - warm) / max(top - warm, 1)))


def tau_at(cfg: dict, step: int) -> float:
    total = cfg["steps_per_epoch"] * cfg["max_epochs"]
    frac = math.cos(math.pi * step / max(total, 1))
    return cfg["final_ema"] - (cfg["final_ema"] - cfg["base_ema"]) * (frac + 1.0) / 2.0


def _normalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(dim=-1, keepdim=True) + eps * eps)


def byol_loss(p: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    return (2.0 - 2.0 * (_normalize(p) * _normalize(z.detach())).sum(dim=-1)).mean()


class ReferenceBYOL:
    """The online and target weights (f32 copies of ``online`` and
    ``target``, state dicts by the program's names), the LARS buffers and
    the step count."""

    def __init__(self, cfg: dict, online: Dict[str, torch.Tensor], target: Dict[str, torch.Tensor],
                 step: int, group=None, precision: str = "f32"):
        self.cfg, self.group, self.precision = cfg, group, precision
        self.arch = cfg["arch"]
        self.online = {k: v.detach().float().clone().requires_grad_(not _is_buffer(k)) for k, v in online.items()}
        self.target = {k: v.detach().float().clone() for k, v in target.items()}
        self.params: List[str] = [k for k in online if not _is_buffer(k)]
        self.buf = {k: torch.zeros_like(self.online[k]) for k in self.params}
        self.step_count = step
        self.bn_stats: Dict[str, tuple] = {}  # the last step's, by layer

    def _encode(self, P, prefix, x, grad: bool, stats=None):
        with torch.set_grad_enabled(grad):
            feats = nets.resnet(x, P, f"{prefix}backbone.", self.arch, True, self.group, self.precision,
                                stats=stats)
            return nets.mlp(feats, P, f"{prefix}projector.", True, self.group, self.precision, stats)

    def loss_and_grads(self, v1: torch.Tensor, v2: torch.Tensor):
        """The step's loss (the global batch's) and the averaged gradient
        of every parameter (None for one the loss does not reach)."""
        z_t = self._encode(self.target, "", torch.cat([v2, v1]), grad=False)
        self.bn_stats = {}
        z = self._encode(self.online, "encoder.", torch.cat([v1, v2]), grad=True, stats=self.bn_stats)
        p = nets.mlp(z, self.online, "predictor.", True, self.group, self.precision, self.bn_stats)
        loss = byol_loss(p, z_t)
        leaves = [self.online[k] for k in self.params]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = dict(zip(self.params, grads))
        loss = loss.detach()
        if self.group is not None:
            import torch.distributed as dist

            n = dist.get_world_size(self.group)
            for g in grads.values():
                if g is not None:
                    dist.all_reduce(g, group=self.group)
                    g.div_(n)
            dist.all_reduce(loss, group=self.group)
            loss = loss / n
        return loss, grads

    @torch.no_grad()
    def apply(self, grads: Dict[str, torch.Tensor]) -> None:
        """LARS on every online parameter, then the target's EMA."""
        cfg = self.cfg
        lr, tau = lr_at(cfg, self.step_count), tau_at(cfg, self.step_count)
        wd, m, eta, eps = cfg["weight_decay"], cfg["momentum"], cfg["trust_coefficient"], 1e-8
        for k in self.params:
            p = self.online[k]
            g = grads[k] if grads[k] is not None else torch.zeros_like(p)
            if p.ndim >= 2 and wd != 0.0:
                pn, gn = p.norm(), g.norm()
                tr = torch.where((pn > 0) & (gn > 0), eta * pn / (gn + wd * pn + eps), torch.ones_like(pn))
                g = (g + wd * p) * tr
            self.buf[k].mul_(m).add_(g)
            p.sub_(lr * self.buf[k])
        for k in self.target:
            if not _is_buffer(k):
                self.target[k].lerp_(self.online[f"encoder.{k}"], 1.0 - tau)
        m = cfg["bn_momentum"]
        for name, (mean, var) in self.bn_stats.items():
            self.online[f"{name}.running_mean"].mul_(m).add_(mean, alpha=1.0 - m)
            self.online[f"{name}.running_var"].mul_(m).add_(var, alpha=1.0 - m)
        self.step_count += 1

    def train_step(self, v1: torch.Tensor, v2: torch.Tensor):
        loss, grads = self.loss_and_grads(v1, v2)
        self.apply(grads)
        return loss, grads


def _is_buffer(name: str) -> bool:
    return name.endswith(("running_mean", "running_var", "num_batches_tracked"))
