"""Faults planted under the Swin UNETR cell's timed path, to show that
``correct`` catches them: ``harness/seg_faults.py``'s, with ``unchanged``
extended to AdamW, and two of the Swin encoder's own.

- ``unchanged``: the train step computes its loss and leaves the weights
  as they were (AdamW's step, as LARS's and SGD's, does nothing);
- ``half_batch``, ``leaf_unmoved``, ``altered``: as in ``seg_faults``;
- ``no_shift``: every Swin block attends within unshifted windows (the
  cyclic shift and its mask left out);
- ``no_rel_bias``: the relative position bias left out of the scores (the
  tables then get no gradient and AdamW leaves them).
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch

from benchmark.harness import seg_faults


@contextlib.contextmanager
def _unchanged():
    with seg_faults.FAULTS["unchanged"](), \
            mock.patch.object(torch.optim.AdamW, "step", lambda self, closure=None: None):
        yield


def _no_shift():
    from medical_image_segmentation_tpu_torch.models import swin_unetr as sw

    window_and_shift = sw.window_and_shift
    return mock.patch.object(sw, "window_and_shift", lambda dims, window, shift: window_and_shift(dims, window, 0))


def _no_rel_bias():
    from medical_image_segmentation_tpu_torch.models import swin_unetr as sw

    attend = sw.WindowAttention._attend

    def without_bias(self, x, windows, mask):
        table = self._parameters["relative_position_bias_table"]
        self._parameters["relative_position_bias_table"] = torch.zeros_like(table, requires_grad=False)
        try:
            return attend(self, x, windows, mask)
        finally:
            self._parameters["relative_position_bias_table"] = table

    return mock.patch.object(sw.WindowAttention, "_attend", without_bias)


FAULTS = {**seg_faults.FAULTS, "unchanged": _unchanged, "no_shift": _no_shift, "no_rel_bias": _no_rel_bias}
del FAULTS["ds_dropped"]


def fault(name: str):
    """The context manager of fault ``name``."""
    return FAULTS[name]()
