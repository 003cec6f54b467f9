"""Faults planted under the segmentation training cells' timed path, to show
that ``correct`` catches them (``harness/faults.py`` plants the others).

- ``unchanged``: the train step computes its loss and leaves the weights
  as they were (LARS's and SGD's steps do nothing);
- ``half_batch``: the train step sees half of its rows;
- ``leaf_unmoved``: the train step leaves the largest matrix or kernel (by
  norm) as it was and moves every other parameter;
- ``ds_dropped``: the deep-supervised loss over the full-resolution output
  alone (nnU-Net's cell);
- ``altered``: one element of the augmented image changed where it is made.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch


def _train_step_patch(transform):
    from medical_image_segmentation_tpu_torch.train.segmentation_task import SegmentationTask

    original = SegmentationTask.train_step

    def patched(self, images, masks):
        return transform(original, self, images, masks)

    return mock.patch.object(SegmentationTask, "train_step", patched)


@contextlib.contextmanager
def _unchanged():
    from medical_image_segmentation_tpu_torch.ops.lars import LARS

    with mock.patch.object(LARS, "step", lambda self, closure=None: None), \
            mock.patch.object(torch.optim.SGD, "step", lambda self, closure=None: None):
        yield


def _half(original, self, images, masks):
    h = images.shape[0] // 2
    return original(self, images[:h], masks[:h])


def _leaf_unmoved(original, self, images, masks):
    leaf = max((p for p in self.model.parameters() if p.ndim >= 2), key=lambda p: float(p.detach().norm()))
    before = leaf.detach().clone()
    out = original(self, images, masks)
    with torch.no_grad():
        leaf.copy_(before)
    return out


@contextlib.contextmanager
def _ds_dropped():
    import medical_image_segmentation_tpu_torch.train.segmentation_task as st
    from medical_image_segmentation_tpu_torch.ops.dice import softmax_dice_ce

    with mock.patch.object(st, "deep_supervised_dice_ce",
                           lambda outs, labels, weights, group=None: softmax_dice_ce(outs[0], labels, group=group)):
        yield


@contextlib.contextmanager
def _altered():
    import medical_image_segmentation_tpu_torch.ops.augment as a2
    import medical_image_segmentation_tpu_torch.ops.augment3d as a3

    def altered(make):
        def pair(*a, **k):
            img, msk = make(*a, **k)
            img[(0,) * img.dim()] += 1.0
            return img, msk

        return pair

    with mock.patch.object(a2, "segmentation_augment", altered(a2.segmentation_augment)), \
            mock.patch.object(a3, "segmentation_augment_3d", altered(a3.segmentation_augment_3d)):
        yield


FAULTS = {"unchanged": _unchanged, "half_batch": lambda: _train_step_patch(_half),
          "leaf_unmoved": lambda: _train_step_patch(_leaf_unmoved), "ds_dropped": _ds_dropped, "altered": _altered}


def fault(name: str):
    """The context manager of fault ``name``."""
    return FAULTS[name]()
