"""Linear probe of a BYOL checkpoint (``mis-linear-probe-torch``).

Port of ``eval/run_linear_probe.py:21-83``: load a port BYOL ``.pt`` (a
file, or a directory whose latest step is read), freeze the encoder, train
a Flatten → Dropout → Linear head with Adam on its eval-mode backbone
features of center-cropped train images, and report the head's accuracy on
the val store. The same flags as the JAX CLI, plus ``--device`` (default
``cuda``, which raises without a card).
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from medical_image_segmentation_tpu_torch.core.checkpoint import load_checkpoint
from medical_image_segmentation_tpu_torch.data.datamodules import get_datamodule
from medical_image_segmentation_tpu_torch.data.device_feed import device_batches
from medical_image_segmentation_tpu_torch.eval.linear_probe import LinearProbe
from medical_image_segmentation_tpu_torch.train.byol_task import BYOLTask
from medical_image_segmentation_tpu_torch.train.train_ssl import _val_preprocess, resolve_device


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Linear probe on frozen SSL features (PyTorch/CUDA port)")
    ap.add_argument("--checkpoint", required=True, help="port BYOL .pt, or its directory (latest step)")
    ap.add_argument("--dataset", default="RADIOLOGY_1M")
    ap.add_argument("--arch", default="resnet18")
    ap.add_argument("--hidden_dim", type=int, default=4096)
    ap.add_argument("--projection_dim", type=int, default=256)
    ap.add_argument("--batch_size", type=int, default=256)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--dropout", type=float, default=0.0)
    ap.add_argument("--limit_batches", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device; cuda raises if absent")
    return ap.parse_args(argv)


def run(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Train the probe and score it; returns the last train epoch's
    ``online_train_acc`` and the val ``online_val_acc``/``online_val_loss``
    (means over val batches)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    dm = get_datamodule(args.dataset)()
    if not dm.has_train_labels:
        raise SystemExit(
            f"dataset {args.dataset} has an unlabeled train store — a linear probe "
            f"fit on constant labels would report a meaningless accuracy. Use a "
            f"labeled dataset (CIFAR10/CIFAR100/IMAGENET) or the KNN probe on a labeled val set."
        )
    task = BYOLTask(arch=args.arch, in_channels=dm.channels, low_res=dm.low_res, hidden_dim=args.hidden_dim,
                    proj_dim=args.projection_dim, num_classes=dm.NUM_CLASSES, device=device)
    task.load_state_dict(load_checkpoint(args.checkpoint))

    feat_dim = task.online.encoder.backbone.feature_dim  # 512 × the block's expansion
    probe = LinearProbe(feat_dim, dm.NUM_CLASSES, dropout=args.dropout, lr=args.lr, device=device,
                        generator=torch.Generator(device=device).manual_seed(1))
    probe.init(1)

    def embed(imgs):
        return task.embed_step(_val_preprocess(imgs, dm))

    out: Dict[str, float] = {}
    for epoch in range(args.epochs):
        m = {}
        with contextlib.closing(dm.train_loader(args.batch_size, seed=epoch)) as loader, \
                contextlib.closing(device_batches(loader, device)) as batches:
            for i, (imgs, labels) in enumerate(batches):
                if args.limit_batches and i >= args.limit_batches:
                    break
                m = probe.train_step(embed(imgs), labels)
        if m:
            out["online_train_acc"] = float(m["online_train_acc"])
            print(f"epoch {epoch}: online_train_acc={out['online_train_acc']:.4f}", file=sys.stderr)

    accs, losses = [], []
    with contextlib.closing(dm.val_loader(args.batch_size)) as loader, \
            contextlib.closing(device_batches(loader, device)) as batches:
        for i, (imgs, labels) in enumerate(batches):
            if args.limit_batches and i >= args.limit_batches:
                break
            m = probe.eval_step(embed(imgs), labels)
            accs.append(float(m["online_val_acc"]))
            losses.append(float(m["online_val_loss"]))
    if accs:
        out.update(online_val_acc=float(np.mean(accs)), online_val_loss=float(np.mean(losses)))
        print(f"online_val_acc={out['online_val_acc']:.4f} online_val_loss={out['online_val_loss']:.4f}")
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
