"""Faults planted under the timed path, to show that ``correct`` catches them.

Each is a context manager that patches the program while it is active.
The benchmark's runs never use them: ``tools/calibrate.py`` reads each
fault's numbers on the chip, and ``tests/test_harness_faults.py`` checks
on the CPU that a run with one comes out not correct.

- ``unchanged``: the train step computes its loss and leaves the weights
  as they were (the optimizer's step does nothing);
- ``half_batch``: the train step sees half of its rows, the loss the mean
  over those; for serving, half of each request is masked and the rest
  returned empty;
- ``no_exchange``: the gradient all-reduce between ranks is left out;
- ``local_stats``: the other exchange between ranks left out: BatchNorm
  takes each rank's own statistics where it takes every rank's;
- ``leaf_unmoved``: a fault confined to one leaf: the train step leaves
  the largest matrix or kernel (by norm) as it was and moves every other
  parameter;
- ``altered``: one answer changed where it is made: an element of the
  first view, the mask of a request's first slice.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch


def _train_step_patch(transform):
    from medical_image_segmentation_tpu_torch.train.byol_task import BYOLTask

    original = BYOLTask.train_step

    def patched(self, view1, view2, labels=None):
        return transform(original, self, view1, view2, labels)

    return mock.patch.object(BYOLTask, "train_step", patched)


@contextlib.contextmanager
def _unchanged():
    from medical_image_segmentation_tpu_torch.ops.lars import LARS

    with mock.patch.object(LARS, "step", lambda self, closure=None: None):
        yield


def _leaf_unmoved(original, self, v1, v2, labels):
    leaf = max((p for p in self.online.parameters() if p.ndim >= 2), key=lambda p: float(p.detach().norm()))
    before = leaf.detach().clone()
    out = original(self, v1, v2, labels)
    with torch.no_grad():
        leaf.copy_(before)
    return out


def _half(original, self, v1, v2, labels):
    h = v1.shape[0] // 2
    return original(self, v1[:h], v2[:h], labels)


@contextlib.contextmanager
def _no_exchange():
    import medical_image_segmentation_tpu_torch.train.byol_task as bt

    with mock.patch.object(bt, "all_reduce_mean_grads", lambda params, group: None):
        yield


@contextlib.contextmanager
def _local_stats():
    from medical_image_segmentation_tpu_torch.models.batchnorm import BatchNorm

    forward = BatchNorm.forward

    def local(self, x):
        group, self.group = self.group, None
        try:
            return forward(self, x)
        finally:
            self.group = group

    with mock.patch.object(BatchNorm, "forward", local):
        yield


@contextlib.contextmanager
def _altered_train():
    import medical_image_segmentation_tpu_torch.ops.fused_augment as fa

    def altered(make):
        def views(*a, **k):
            v1, v2 = make(*a, **k)
            v1[0, 0, 0, 0] += 1.0
            return v1, v2

        return views

    # the kernel's launch on the card, its plain version on the CPU
    with mock.patch.object(fa, "_launch", altered(fa._launch)), \
            mock.patch.object(fa, "two_view_augment_reference", altered(fa.two_view_augment_reference)):
        yield


def _serve_patch(transform):
    import medical_image_segmentation_tpu_torch.serve as serve

    make = serve.make_predict_fn

    def patched(*a, **k):
        fn = make(*a, **k)
        return lambda x: transform(fn, x)

    return mock.patch.object(serve, "make_predict_fn", patched)


def _serve_half(fn, x):
    masks = fn(x[: x.shape[0] // 2])
    return torch.cat([masks, torch.zeros_like(masks)])


def _serve_altered(fn, x):
    masks = fn(x)
    masks[0] ^= 1
    return masks


def fault(name: str, kind: str):
    """The context manager of fault ``name`` for a ``train`` or ``serve``
    driver."""
    if kind == "serve":
        return {"half_batch": lambda: _serve_patch(_serve_half),
                "altered": lambda: _serve_patch(_serve_altered)}[name]()
    return {"unchanged": _unchanged, "half_batch": lambda: _train_step_patch(_half),
            "leaf_unmoved": lambda: _train_step_patch(_leaf_unmoved), "no_exchange": _no_exchange,
            "local_stats": _local_stats, "altered": _altered_train}[name]()
