"""Host batches → device tensors for one device.

Replaces ``device_put_sharded_batches`` (``data/loader.py:326-357`` of the
JAX package, which calls ``jax.device_put``). On a CUDA device each batch
is copied into pinned host memory and sent with a ``non_blocking`` copy on
a side stream, one batch ahead: batch t+1 crosses PCIe while batch t
trains. The compute stream waits on an event recorded after each copy, not
on the whole side stream, so it never waits for the batch after its own.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Tuple

import numpy as np
import torch


def device_batches(loader: Iterable, device) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Iterate ``(images, labels)`` of ``loader`` (numpy, labels int32) as
    tensors on ``device``: images in the store's dtype, labels int64."""
    return device_arrays(((imgs, labels.astype(np.int64)) for imgs, labels in loader), device)


def device_arrays(batches: Iterable, device) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Iterate tuples of numpy arrays (e.g. the ``(images, masks)`` of a
    paired loader) as tuples of tensors on ``device``, dtypes kept."""
    device = torch.device(device)
    if device.type != "cuda":
        for arrays in batches:
            yield tuple(torch.from_numpy(a).to(device) for a in arrays)
        return

    copy_stream = torch.cuda.Stream(device)

    def put(arrays):
        with torch.cuda.stream(copy_stream):
            out = tuple(torch.from_numpy(a).pin_memory().to(device, non_blocking=True) for a in arrays)
            done = torch.cuda.Event()
            done.record(copy_stream)
        return out, done

    def ready(item):
        tensors, done = item
        compute = torch.cuda.current_stream(device)
        compute.wait_event(done)
        for t in tensors:
            # allocated on the side stream, used on the compute stream
            t.record_stream(compute)
        return tensors

    it = iter(batches)
    try:
        pending = put(next(it))
    except StopIteration:
        return
    for arrays in it:
        nxt = put(arrays)
        yield ready(pending)
        pending = nxt
    yield ready(pending)
