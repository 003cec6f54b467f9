"""Host batches → device tensors for one device.

Replaces ``device_put_sharded_batches`` (``data/loader.py:326-357`` of the
JAX package, which calls ``jax.device_put``). On a CUDA device each batch
is copied into pinned host memory and sent with a ``non_blocking`` copy on
a side stream, one batch ahead: batch t+1 crosses PCIe while batch t
trains. The compute stream waits on an event recorded after each copy, not
on the whole side stream, so it never waits for the batch after its own.

``volume_batches`` feeds the volumetric trainers from a ``VolumeLoader``'s
index batches, either through that copy or, with a corpus that
``build_corpus`` put on the device (``--device_cache``), by
``index_select`` there, so that only the indices cross.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional, Tuple

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


def build_corpus(dataset, device) -> Tuple[torch.Tensor, ...]:
    """Every item of a volume dataset stacked on ``device``: the images in
    f32 and, for a paired dataset, the 0/1 masks as uint8, a quarter of
    the bytes and exact when cast back."""
    cols = zip(*(dataset[i] for i in range(len(dataset))))
    return tuple(torch.from_numpy(np.stack(c) if j == 0 else np.stack(c).astype(np.uint8)).to(device)
                 for j, c in enumerate(cols))


def volume_batches(loader, device, corpus: Optional[Tuple[torch.Tensor, ...]] = None, skip: int = 0,
                   steps: Optional[int] = None) -> Iterator[Tuple[torch.Tensor, ...]]:
    """One epoch of ``loader`` (a ``VolumeLoader``, whose epoch counter
    advances) as tuples of f32 tensors on ``device``, from batch ``skip``
    up to batch ``steps``. The skipped batches are neither read nor
    gathered. With ``corpus`` the batches are gathered on the device by
    index; otherwise they are read on the host and copied one ahead."""
    picks = (idx for i, idx in enumerate(loader.iter_index_batches())
             if i >= skip and (steps is None or i < steps))
    if corpus is not None:
        for idx in picks:
            on_device = torch.from_numpy(idx.astype(np.int64)).to(device)
            yield tuple(c.index_select(0, on_device).float() for c in corpus)
        return
    host = (tuple(np.stack(col) for col in zip(*(loader.ds[int(i)] for i in idx))) for idx in picks)
    yield from device_arrays(host, device)
