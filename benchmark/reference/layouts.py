"""Names and shapes of the benchmark networks' tensors, from a
configuration alone (the program's state-dict names, so one dict of
weights loads into both sides)."""

from __future__ import annotations

from typing import Dict, Tuple

from benchmark.reference.nets import STAGES, WIDTHS

Layout = Dict[str, Tuple[int, ...]]


def _bn(out: Layout, name: str, c: int) -> None:
    for k in ("weight", "bias", "running_mean", "running_var"):
        out[f"{name}.{k}"] = (c,)


def resnet_layout(prefix: str, arch: str, in_channels: int) -> Layout:
    out: Layout = {f"{prefix}conv1.weight": (64, in_channels, 7, 7)}
    _bn(out, f"{prefix}bn1", 64)
    cin = 64
    for i, (n_blocks, f) in enumerate(zip(STAGES[arch], WIDTHS)):
        for j in range(n_blocks):
            stride = 2 if (i > 0 and j == 0) else 1
            name = f"{prefix}layer{i + 1}.{j}"
            out[f"{name}.conv1.weight"] = (f, cin, 3, 3)
            _bn(out, f"{name}.bn1", f)
            out[f"{name}.conv2.weight"] = (f, f, 3, 3)
            _bn(out, f"{name}.bn2", f)
            if stride != 1 or cin != f:
                out[f"{name}.downsample_conv.weight"] = (f, cin, 1, 1)
                _bn(out, f"{name}.downsample_bn", f)
            cin = f
    return out


def mlp_layout(prefix: str, d_in: int, hidden: int, d_out: int) -> Layout:
    out: Layout = {f"{prefix}fc1.weight": (hidden, d_in), f"{prefix}fc1.bias": (hidden,)}
    _bn(out, f"{prefix}bn", hidden)
    out[f"{prefix}fc2.weight"] = (d_out, hidden)
    out[f"{prefix}fc2.bias"] = (d_out,)
    return out


def byol_layouts(cfg: dict) -> Tuple[Layout, Layout]:
    """The online network's (encoder, predictor, probe) and the target's
    (encoder) layouts."""
    feat, hidden, proj = WIDTHS[-1], cfg["hidden_dim"], cfg["proj_dim"]

    def encoder(prefix):
        return {**resnet_layout(f"{prefix}backbone.", cfg["arch"], cfg["in_channels"]),
                **mlp_layout(f"{prefix}projector.", feat, hidden, proj)}

    online = {**encoder("encoder."), **mlp_layout("predictor.", proj, hidden, proj),
              "probe.weight": (cfg["num_classes"], feat), "probe.bias": (cfg["num_classes"],)}
    return online, encoder("")


def unet_layout(cfg: dict) -> Layout:
    out = resnet_layout("encoder.", cfg["arch"], cfg["in_channels"])
    cin = WIDTHS[-1]
    for i, (f, skip) in enumerate(zip(cfg["decoder_channels"], (256, 128, 64, 64, 0))):
        out[f"decoder.{i}.conv1.weight"] = (f, cin + skip, 3, 3)
        _bn(out, f"decoder.{i}.bn1", f)
        out[f"decoder.{i}.conv2.weight"] = (f, f, 3, 3)
        _bn(out, f"decoder.{i}.bn2", f)
        cin = f
    out["head.weight"] = (cfg["classes"], cin, 3, 3)
    out["head.bias"] = (cfg["classes"],)
    return out
