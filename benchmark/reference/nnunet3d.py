"""nnU-Net's 3d_fullres training step in plain PyTorch: the benchmark's
reference for the ``nnunet3d_liver`` cells.

Isensee et al., nnU-Net, Nature Methods 18:203-211 (2021), arXiv:1809.10486;
the network is ``dynamic_network_architectures``' ``PlainConvUNet``:

- encoder stages of [3³ conv with bias → InstanceNorm (affine, eps 1e-5)
  → LeakyReLU(0.01)] × 2, the first conv of every stage but the first of
  stride 2;
- decoder levels of a 2³ stride-2 transposed conv with bias, the skip
  concatenated after it, the same double conv, and a 1³ conv with bias to
  the logits (deep supervision: one a level);
- the loss: softmax cross-entropy plus the batch's soft Dice over the
  foreground classes (smooth 1e-5), ``ce − mean Dice``, over the outputs
  weighted 1, 1/2, 1/4, … normalised with the coarsest at 0, each against
  the label map downsampled by nearest neighbour (``F.interpolate``'s
  ``nearest-exact``, as nnU-Net v2 does);
- SGD with Nesterov momentum (torch's: the update ``g + m·buf`` with
  ``buf ← m·buf + g``, weight decay added to the gradient first), the
  gradients' global norm clipped to ``clip_norm`` before; the learning
  rate ``lr·(1 − step/total)^0.9`` per step; a parameter the loss does not
  reach (the coarsest head) is left alone.

The augmentation the program's ``ops/augment3d.py`` applies, redrawn from
the same generator in the same order (crop origins on each axis, flips,
brightness, contrast): a random crop with a flip a sample and axis, the
label map moved value for value, the image's brightness and contrast
around its mean, normalized, in the configuration's dtype.

Departures from nnU-Net, as the port trains it: bf16 autocast in place of
fp16 with a gradient scaler; no spatial or intensity augmentation beyond
the port's. ``precision`` as in ``reference/nets.py``: ``"f32"`` (the
reference), ``"bf16"`` (a look), ``"fp8"`` (the control), applied to every
convolution's operands and result. A copy of ``tests/plain_nnunet3d.py``'s
statement, which the benchmark may not import. Tensors are by the
program's state-dict names; inputs and logits NDHWC.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from benchmark.reference.nets import _q

SLOPE = 0.01
EPS = 1e-5


def layout(cfg: dict) -> Dict[str, tuple]:
    """The network's tensors by name and shape."""
    f, k = list(cfg["features"]), cfg["classes"]
    out: Dict[str, tuple] = {}

    def block(name, cin, c):
        for j, i in ((1, cin), (2, c)):
            out[f"{name}.conv{j}.weight"], out[f"{name}.conv{j}.bias"] = (c, i, 3, 3, 3), (c,)
            out[f"{name}.norm{j}.weight"], out[f"{name}.norm{j}.bias"] = (c,), (c,)

    cin = cfg["in_channels"]
    for i, c in enumerate(f):
        block(f"enc{i}", cin, c)
        cin = c
    for j, c in enumerate(reversed(f[:-1])):
        out[f"up{j}.weight"], out[f"up{j}.bias"] = (cin, c, 2, 2, 2), (c,)
        block(f"dec{j}", 2 * c, c)
        out[f"head{j}.weight"], out[f"head{j}.bias"] = (k, c, 1, 1, 1), (k,)
        cin = c
    return out


def he_std(shape) -> float:
    """nnU-Net's ``InitWeights_He(1e-2)``: Kaiming normal, a = 0.01, over
    torch's fan-in of the weight (``shape[1]`` times the kernel)."""
    gain = math.sqrt(2.0 / (1.0 + SLOPE ** 2))
    return gain / math.sqrt(shape[1] * math.prod(shape[2:]))


def _conv(x, w, b, stride, padding, precision):
    return _q(F.conv3d(_q(x, precision), _q(w, precision), b, stride, padding), precision)


def _block(x, P, name: str, stride: int, precision: str):
    for k, s in ((1, stride), (2, 1)):
        x = _conv(x, P[f"{name}.conv{k}.weight"], P[f"{name}.conv{k}.bias"], s, 1, precision)
        x = F.instance_norm(x, weight=P[f"{name}.norm{k}.weight"], bias=P[f"{name}.norm{k}.bias"], eps=EPS)
        x = F.leaky_relu(x, SLOPE)
    return x


def forward(x_ndhwc: torch.Tensor, P: Dict[str, torch.Tensor], precision: str = "f32") -> List[torch.Tensor]:
    """The deep-supervision logits, full resolution first."""
    n = sum(1 for k in P if k.startswith("enc") and k.endswith(".conv1.weight"))
    x = x_ndhwc.permute(0, 4, 1, 2, 3)
    skips = []
    for i in range(n):
        x = _block(x, P, f"enc{i}", 1 if i == 0 else 2, precision)
        skips.append(x)
    outs = []
    for j in range(n - 1):
        up = _q(F.conv_transpose3d(_q(x, precision), _q(P[f"up{j}.weight"], precision), P[f"up{j}.bias"],
                                   stride=2), precision)
        x = _block(torch.cat([up, skips[-(j + 2)]], dim=1), P, f"dec{j}", 1, precision)
        outs.append(_conv(x, P[f"head{j}.weight"], P[f"head{j}.bias"], 1, 0, precision).permute(0, 2, 3, 4, 1))
    return outs[::-1]


def dice_ce(logits: torch.Tensor, labels: torch.Tensor, smooth: float = 1e-5) -> torch.Tensor:
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


def poly_lr(cfg: dict, step: int) -> float:
    total = cfg["max_epochs"] * cfg["steps_per_epoch"]
    return cfg["learning_rate"] * max(1.0 - step / total, 0.0) ** cfg["poly_exponent"]


# --- the augmentation -----------------------------------------------------------------


def sample_draws(generator: torch.Generator, batch: int, in_dims, out_size) -> dict:
    """Crop origins (where the volume is larger than the crop), flips,
    brightness and contrast, in the program's order of draws."""
    dev = generator.device
    offsets = [torch.randint(0, i - o + 1, (batch,), generator=generator, device=dev) if i > o
               else torch.zeros(batch, dtype=torch.int64, device=dev) for i, o in zip(in_dims, out_size)]
    flips = torch.rand(batch, 3, generator=generator, device=dev) < 0.5
    bright = torch.rand(batch, generator=generator, device=dev, dtype=torch.float32)
    contrast = torch.rand(batch, generator=generator, device=dev, dtype=torch.float32)
    return {"offsets": torch.stack(offsets, -1), "flips": flips, "brightness": 0.8 + (1.2 - 0.8) * bright,
            "contrast": 0.8 + (1.2 - 0.8) * contrast}


def augment(draws: dict, vols: torch.Tensor, labels: torch.Tensor, out_size, mean: float, std: float, dtype):
    """Each sample cropped and flipped by slicing, then jittered and
    normalized: the image in ``dtype`` and the f32 label map."""
    imgs, labs = [], []
    for b in range(vols.shape[0]):
        sl = tuple(slice(int(o), int(o) + s) for o, s in zip(draws["offsets"][b], out_size))
        img, lab = vols[b][sl], labels[b][sl]
        flip = [a for a in range(3) if bool(draws["flips"][b, a])]
        if flip:
            img, lab = img.flip(flip), lab.flip(flip)
        img = (img.float() * draws["brightness"][b]).clamp(0.0, 1.0)
        m = img.mean()
        img = (m + draws["contrast"][b] * (img - m)).clamp(0.0, 1.0)
        mean_t = torch.tensor(mean, dtype=torch.float32, device=img.device)
        std_t = torch.tensor(std, dtype=torch.float32, device=img.device)
        imgs.append(((img - mean_t) / std_t).to(dtype))
        labs.append(lab.float())
    return torch.stack(imgs), torch.stack(labs)


class ReferenceNNUNet:
    """The parameters (f32 copies by name), the momentum buffers, the step
    count and the last step's clipping coefficient."""

    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor], step: int, precision: str = "f32"):
        self.cfg, self.precision, self.step_count = cfg, precision, step
        self.P = {k: v.detach().float().clone() for k, v in weights.items()}
        self.bufs: Dict[str, torch.Tensor] = {}

    def loss_and_grads(self, x: torch.Tensor, labels: torch.Tensor):
        leaves = {k: v.requires_grad_(True) for k, v in self.P.items()}
        loss = ds_loss(forward(x.float(), leaves, self.precision), labels)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        for v in leaves.values():
            v.requires_grad_(False)
        return loss.detach(), dict(zip(leaves, grads))

    @torch.no_grad()
    def apply(self, grads: Dict[str, torch.Tensor]) -> None:
        cfg = self.cfg
        lr, m, wd = poly_lr(cfg, self.step_count), cfg["momentum"], cfg["weight_decay"]
        live = {k: g for k, g in grads.items() if g is not None}
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in live.values()]))
        coef = torch.clamp(cfg["clip_norm"] / (norm + 1e-6), max=1.0)
        self.clip_coef = coef
        for k, g in live.items():
            g = g * coef + wd * self.P[k]
            self.bufs[k] = g.clone() if k not in self.bufs else m * self.bufs[k] + g
            self.P[k] = self.P[k] - lr * (g + m * self.bufs[k])
        self.step_count += 1

    def train_step(self, x: torch.Tensor, labels: torch.Tensor):
        loss, grads = self.loss_and_grads(x, labels)
        self.apply(grads)
        return loss, grads
