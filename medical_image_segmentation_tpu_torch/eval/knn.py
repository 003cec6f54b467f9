"""Weighted-KNN online evaluation. Port of ``eval/knn.py:29-169``.

- The feature bank: L2-normalized backbone features of the train loader's
  first ``max_bank_size`` samples, built under ``torch.no_grad()`` on the
  device the features come from, and kept there.
- Prediction: cosine similarity → top-k (k = 200) → temperature-weighted
  soft vote (T = 0.07) per class.
- ``knn_predict_chunked`` streams the similarity product over bank chunks
  and merges each chunk's top-k, so the (B, N) matrix never exists. Top-k
  by similarity merges exactly across chunks (``exp(s/T)`` is monotone).

The similarity product is a plain matmul and the selection a ``topk``, as
in the JAX package, where both run in XLA outside any Pallas kernel.

Several ranks (``group``): the JAX evaluator works on global arrays, so
its bank holds every host's rows (``eval/knn.py:130-146`` there). Here
each rank embeds its shard of every bank batch and the rows of all ranks
are gathered (an all-reduce of a zero-filled buffer), in rank order, so
every rank holds the whole bank and ``max_bank_size`` counts global rows.
Each rank scores its own val rows; the accuracy is the global count of
hits over the global total.

``val_preprocess`` makes the images that the KNN and linear probes embed.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple

import torch

from medical_image_segmentation_tpu_torch.parallel.mesh import all_reduce_, gather_rows


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(eps)


def _vote(sim_k: torch.Tensor, labels_k: torch.Tensor, num_classes: int, temperature: float) -> torch.Tensor:
    """(B, num_classes) sums of ``exp(s/T)`` over each query's neighbours
    of each class."""
    weights = torch.exp(sim_k / temperature)
    scores = torch.zeros(sim_k.shape[0], num_classes, device=sim_k.device, dtype=torch.float32)
    return scores.scatter_add_(1, labels_k.long(), weights)


@torch.no_grad()
def knn_predict(features: torch.Tensor, bank: torch.Tensor, bank_labels: torch.Tensor, num_classes: int,
                k: int = 200, temperature: float = 0.07) -> torch.Tensor:
    """Soft-voting weighted KNN class scores (B, num_classes) of (B, D)
    query features (any norm) against an L2-normalized (N, D) bank."""
    features = _l2_normalize(features.float())
    sim = features @ bank.float().T
    sim_k, idx_k = torch.topk(sim, min(k, bank.shape[0]), dim=1)
    return _vote(sim_k, bank_labels[idx_k], num_classes, temperature)


def _chunk_topk(features: torch.Tensor, bank_chunk: torch.Tensor, labels_chunk: torch.Tensor,
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k similarities of (B, D) normalized queries against one bank
    chunk, and their labels."""
    sim = features @ bank_chunk.float().T
    sim_k, idx_k = torch.topk(sim, min(k, bank_chunk.shape[0]), dim=1)
    return sim_k, labels_chunk[idx_k]


def _merge_topk(sim_a: torch.Tensor, lab_a: torch.Tensor, sim_b: torch.Tensor, lab_b: torch.Tensor,
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The best ≤ k of two (B, ≤ k) candidate sets."""
    sim = torch.cat([sim_a, sim_b], dim=1)
    lab = torch.cat([lab_a, lab_b], dim=1)
    sim_k, idx = torch.topk(sim, min(k, sim.shape[1]), dim=1)
    return sim_k, torch.gather(lab, 1, idx)


@torch.no_grad()
def knn_predict_chunked(features: torch.Tensor, bank: torch.Tensor, bank_labels: torch.Tensor, num_classes: int,
                        k: int = 200, temperature: float = 0.07, chunk_size: int = 65536) -> torch.Tensor:
    """``knn_predict`` streamed over ``chunk_size`` rows of the bank at a
    time: the same scores, with at most (B, chunk_size) similarities live."""
    features = _l2_normalize(features.float())
    sim_k = lab_k = None
    for s in range(0, bank.shape[0], chunk_size):
        c_sim, c_lab = _chunk_topk(features, bank[s:s + chunk_size], bank_labels[s:s + chunk_size], k)
        if sim_k is None:
            sim_k, lab_k = c_sim, c_lab
        else:
            sim_k, lab_k = _merge_topk(sim_k, lab_k, c_sim, c_lab, k)
    return _vote(sim_k, lab_k, num_classes, temperature)


class KNNEvaluator:
    """Builds a feature bank with an ``embed_fn`` and scores a val loader.

    ``max_bank_size`` caps the bank at the train loader's first N samples
    (a uniform sample without replacement under the trainer's shuffled
    order); at 1M images × 512-d f32 an uncapped bank is ~2 GB beside the
    two towers. ``bank_chunk_size`` streams the similarity product once
    the bank is larger than it."""

    def __init__(self, num_classes: int, k: int = 200, temperature: float = 0.07,
                 max_bank_size: Optional[int] = None, bank_chunk_size: Optional[int] = None, group=None):
        self.num_classes = num_classes
        self.group = group
        self.k = k
        self.temperature = temperature
        self.max_bank_size = max_bank_size
        self.bank_chunk_size = bank_chunk_size

    @torch.no_grad()
    def build_bank(self, embed_fn: Callable[[torch.Tensor], torch.Tensor],
                   train_batches: Iterable[Tuple[torch.Tensor, torch.Tensor]]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N, D) normalized features and (N,) labels of the first
        ``max_bank_size`` train samples; the loop stops at the cap."""
        feats, labels, n = [], [], 0
        cap = self.max_bank_size
        for x, y in train_batches:
            if cap is not None and n >= cap:
                break
            f = _l2_normalize(embed_fn(x).float())
            y = torch.as_tensor(y, device=f.device)
            f, y = gather_rows(f, self.group), gather_rows(y, self.group)
            if cap is not None and n + f.shape[0] > cap:
                f, y = f[:cap - n], y[:cap - n]
            feats.append(f)
            labels.append(y)
            n += f.shape[0]
        return torch.cat(feats), torch.cat(labels)

    def scores(self, features: torch.Tensor, bank: torch.Tensor, bank_labels: torch.Tensor) -> torch.Tensor:
        if self.bank_chunk_size is not None and bank.shape[0] > self.bank_chunk_size:
            return knn_predict_chunked(features, bank, bank_labels, self.num_classes, k=self.k,
                                       temperature=self.temperature, chunk_size=self.bank_chunk_size)
        return knn_predict(features, bank, bank_labels, self.num_classes, k=self.k, temperature=self.temperature)

    @torch.no_grad()
    def evaluate(self, embed_fn: Callable[[torch.Tensor], torch.Tensor],
                 train_batches: Iterable[Tuple[torch.Tensor, torch.Tensor]],
                 val_batches: Iterable[Tuple[torch.Tensor, torch.Tensor]]) -> float:
        """Top-1 accuracy of the KNN vote over ``val_batches``; batches are
        (images, int labels), the images as ``embed_fn`` takes them."""
        bank, bank_labels = self.build_bank(embed_fn, train_batches)
        counts = torch.zeros(2, dtype=torch.int64, device=bank.device)
        for x, y in val_batches:
            pred = self.scores(embed_fn(x), bank, bank_labels).argmax(dim=-1)
            counts[0] += (pred == torch.as_tensor(y, device=pred.device)).sum()
            counts[1] += y.shape[0]
        correct, total = all_reduce_(counts, self.group).tolist()
        return correct / max(total, 1)


def val_preprocess(imgs: torch.Tensor, dm, full_image: bool = False) -> torch.Tensor:
    """What the probes embed and the SSL val pass scores: the val stats
    normalize, after a center crop to the train crop size unless
    ``full_image`` (``train_ssl.py:107-126``)."""
    x = imgs.float()
    if not full_image:
        _, h, w, _ = imgs.shape
        s = min(h, w, dm.crop_size)
        y0, x0 = (h - s) // 2, (w - s) // 2
        x = x[:, y0:y0 + s, x0:x0 + s, :]
    mean = torch.tensor(dm.val_mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(dm.val_std, dtype=torch.float32, device=x.device)
    return ((x - mean) / std).contiguous()
