"""A plain float32 statement of nnU-Net's 3d_fullres training step, the
yardstick of ``models/plain_unet3d.py`` and its recipe. It imports torch
alone.

Isensee et al., nnU-Net, Nature Methods 18:203-211 (2021); the network is
``dynamic_network_architectures``' ``PlainConvUNet``:

- encoder stages of [3³ conv with bias → InstanceNorm (affine, eps 1e-5)
  → LeakyReLU(0.01)] × 2, the first conv of every stage but the first
  with stride 2;
- decoder levels of a 2³ stride-2 transposed conv with bias, the skip
  concatenated after it, the same double conv, and a 1³ conv with bias
  to the logits (deep supervision: one a level);
- the loss: softmax cross-entropy plus the batch's soft Dice over the
  foreground classes (smooth 1e-5), ``ce − mean Dice``, over the outputs
  weighted 1, 1/2, 1/4, … normalised with the coarsest at 0, each against
  the label map downsampled by nearest neighbour (``F.interpolate``'s
  ``nearest-exact``, as nnU-Net v2 does);
- SGD with Nesterov momentum (torch's: ``buf ← m·buf + g``, the update
  ``g + m·buf``, weight decay added to the gradient first), the
  gradients' global norm clipped first (``clip / (norm + 1e-6)``, at most
  1); a parameter the loss does not reach is left alone.

Departures from nnU-Net, as the port trains it: bf16 autocast in place of
fp16 with a gradient scaler (this statement is float32 throughout, TF32
off); the poly learning rate is given per step by the caller; no data
augmentation beyond what the caller feeds.

Tensors are by the program's state-dict names (``enc{i}``, ``up{j}``,
``dec{j}``, ``head{j}``; ``conv{k}`` and ``norm{k}`` inside a block), inputs
and logits NDHWC.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import torch
import torch.nn.functional as F

SLOPE = 0.01
EPS = 1e-5


@contextlib.contextmanager
def exact_f32():
    """TF32 off for convolutions and matrix products, put back after."""
    b = torch.backends
    saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = saved


def stages(P: Dict[str, torch.Tensor]) -> int:
    return sum(1 for k in P if k.startswith("enc") and k.endswith(".conv1.weight"))


def _block(x, P, name: str, stride: int):
    for k, s in ((1, stride), (2, 1)):
        x = F.conv3d(x, P[f"{name}.conv{k}.weight"], P[f"{name}.conv{k}.bias"], s, 1)
        x = F.instance_norm(x, weight=P[f"{name}.norm{k}.weight"], bias=P[f"{name}.norm{k}.bias"], eps=EPS)
        x = F.leaky_relu(x, SLOPE)
    return x


def forward(x_ndhwc: torch.Tensor, P: Dict[str, torch.Tensor], deep_supervision: bool = True):
    """The deep-supervision logits, full resolution first, or the
    full-resolution logits alone."""
    n = stages(P)
    x = x_ndhwc.permute(0, 4, 1, 2, 3)
    skips = []
    for i in range(n):
        x = _block(x, P, f"enc{i}", 1 if i == 0 else 2)
        skips.append(x)
    outs = []
    for j in range(n - 1):
        x = F.conv_transpose3d(x, P[f"up{j}.weight"], P[f"up{j}.bias"], stride=2)
        x = _block(torch.cat([x, skips[-(j + 2)]], dim=1), P, f"dec{j}", 1)
        outs.append(F.conv3d(x, P[f"head{j}.weight"], P[f"head{j}.bias"]).permute(0, 2, 3, 4, 1))
    return outs[::-1] if deep_supervision else outs[-1]


def dice_ce(logits: torch.Tensor, labels: torch.Tensor, smooth: float = 1e-5) -> torch.Tensor:
    """(B, D, H, W, K) logits against (B, D, H, W, 1) integer labels."""
    z = logits.permute(0, 4, 1, 2, 3)
    y = labels[..., 0].long()
    ce = F.cross_entropy(z, y)
    p = torch.softmax(z, dim=1)[:, 1:]
    onehot = F.one_hot(y, z.shape[1]).permute(0, 4, 1, 2, 3)[:, 1:].float()
    axes = (0, 2, 3, 4)
    dc = (2.0 * (p * onehot).sum(axes) + smooth) / torch.clip(p.sum(axes) + onehot.sum(axes) + smooth, 1e-8)
    return ce - dc.mean()


def ds_weights(n: int) -> List[float]:
    w = [1.0 / 2 ** i for i in range(n)]
    w[-1] = 0.0
    return [x / sum(w) for x in w]


def ds_loss(outs, labels: torch.Tensor) -> torch.Tensor:
    total = 0.0
    for w, out in zip(ds_weights(len(outs)), outs):
        if w == 0.0:
            continue
        t = F.interpolate(labels.permute(0, 4, 1, 2, 3).float(), size=tuple(out.shape[1:4]), mode="nearest-exact")
        total = total + w * dice_ce(out, t.permute(0, 2, 3, 4, 1))
    return total


def loss_and_grads(P: Dict[str, torch.Tensor], x: torch.Tensor, labels: torch.Tensor):
    """The loss and every parameter's gradient (None where the loss does
    not reach it: the coarsest head)."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in P.items()}
    loss = ds_loss(forward(x, leaves), labels)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), dict(zip(leaves, grads))


@torch.no_grad()
def sgd_step(P: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], bufs: Dict[str, torch.Tensor], lr: float,
             momentum: float = 0.99, weight_decay: float = 3e-5, clip: float = 12.0) -> Dict[str, torch.Tensor]:
    """The parameters after one step (``bufs`` is updated in place)."""
    live = {k: g for k, g in grads.items() if g is not None}
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in live.values()]))
    coef = torch.clamp(clip / (norm + 1e-6), max=1.0)
    out = dict(P)
    for k, g in live.items():
        g = g * coef + weight_decay * P[k]
        bufs[k] = g.clone() if k not in bufs else momentum * bufs[k] + g
        out[k] = P[k] - lr * (g + momentum * bufs[k])
    return out
