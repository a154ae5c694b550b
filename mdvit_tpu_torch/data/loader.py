"""Device-resident multi-domain batching, the port of
``mdvit_tpu/data/loader.py``.

Every optimizer step takes one batch of B from EVERY domain, stacked into one
domain-contiguous (D·B, …) batch; an epoch is ``max(len(domain)) // B``
steps (the reference's ``iterations = max(len(loader))``). The uint8 corpus
sits on the card, uploaded once; the host sends only (D, B) index rows, and
the gather and augmentation run in the train step on the card.
"""
from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np
import torch

from mdvit_tpu_torch.data.datasets import DomainArrays
from mdvit_tpu_torch.data.preprocess import normalize


class DeviceDomainStore:
    """Each domain's uint8 train arrays on ``device``, uploaded once:
    ``images`` and ``masks`` are tuples of per-domain tensors."""

    def __init__(self, domains: Sequence[DomainArrays], device: torch.device | str):
        self.names = [d.name for d in domains]
        self.sizes = [len(d) for d in domains]
        self.images = tuple(torch.from_numpy(d.images).to(device) for d in domains)
        self.masks = tuple(torch.from_numpy(d.masks).to(device) for d in domains)


class RoundRobinSampler:
    """Per-domain shuffled index streams with drop_last and a re-shuffle on
    exhaustion (reference ``DataLoader(shuffle=True, drop_last=True)`` and its
    StopIteration re-iter); ``np.random.RandomState(seed + i)`` for domain i,
    so the rows equal the JAX package's."""

    def __init__(self, sizes: Sequence[int], batch_size: int, seed: int = 0):
        self.sizes = list(sizes)
        self.batch_size = batch_size
        small = [(i, s) for i, s in enumerate(self.sizes) if s < batch_size]
        if small:
            # a drop_last loader yields no batch for such a domain
            raise ValueError(f"batch_size={batch_size} exceeds the training-set size "
                             f"of domain(s) {small}")
        self._rngs = [np.random.RandomState(seed + i) for i in range(len(sizes))]
        self._queues = [self._fresh(i) for i in range(len(sizes))]

    def _fresh(self, i: int) -> list[int]:
        perm = self._rngs[i].permutation(self.sizes[i])
        usable = (self.sizes[i] // self.batch_size) * self.batch_size
        return list(perm[:usable])

    @property
    def steps_per_epoch(self) -> int:
        return max(s // self.batch_size for s in self.sizes)

    def next_batch(self) -> np.ndarray:
        """(D, B) int32 indices, one row per domain."""
        rows = []
        for i in range(len(self.sizes)):
            if len(self._queues[i]) < self.batch_size:
                self._queues[i] = self._fresh(i)
            rows.append(self._queues[i][: self.batch_size])
            del self._queues[i][: self.batch_size]
        return np.asarray(rows, np.int32)


def gather_batch(store_images: Sequence[torch.Tensor],
                 store_masks: Sequence[torch.Tensor], indices: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stack D per-domain batches from uint8 stores into one domain-contiguous
    (D·B, S, S, ·) fp32 batch plus its (D·B, D) one-hot. ``store_images[d]``
    is (N_d, S, S, 3), ``store_masks[d]`` (N_d, S, S), ``indices`` (D, B)."""
    d, b = indices.shape
    imgs = torch.cat([store_images[i][indices[i]] for i in range(d)]).float()
    masks = torch.cat([store_masks[i][indices[i]] for i in range(d)]).float()
    eye = torch.eye(d, dtype=torch.float32, device=imgs.device)
    return imgs, masks, eye.repeat_interleave(b, dim=0)


def eval_transform(images: torch.Tensor, masks: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The eval path (``augment.py:eval_transform``): normalised images and
    (B, S, S, 1) labels ``mask > 0.5``."""
    return normalize(images), (masks > 0.5).float()[..., None]


class EvalSplitStore:
    """One eval split on the card: all domains concatenated into one uint8
    (N, S, S, 3) images / (N, S, S) masks pair, uploaded once, plus
    per-domain offsets. The eval loop then sends only index rows."""

    def __init__(self, domains: Sequence[DomainArrays], device: torch.device | str):
        self.names = [d.name for d in domains]
        self.sizes = [len(d) for d in domains]
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes[:-1])]).astype(int)
        self.images = torch.from_numpy(
            np.concatenate([d.images for d in domains], axis=0)).to(device)
        self.masks = torch.from_numpy(
            np.concatenate([d.masks for d in domains], axis=0)).to(device)

    def domain(self, i: int) -> tuple[int, int]:
        return int(self.offsets[i]), int(self.sizes[i])


def eval_index_batches(offset: int, n: int, batch_size: int
                       ) -> Iterator[tuple[np.ndarray, int]]:
    """``(indices, valid)`` for one domain of an :class:`EvalSplitStore`:
    ``indices`` is a (batch_size,) int32 array of store rows; the ragged tail
    is padded with the domain's first row (every reduction of the eval step is
    masked by ``valid``)."""
    for start in range(0, n, batch_size):
        stop = min(start + batch_size, n)
        valid = stop - start
        idx = np.full((batch_size,), offset, np.int32)
        idx[:valid] = np.arange(offset + start, offset + stop, dtype=np.int32)
        yield idx, valid


def eval_batches(domain: DomainArrays, batch_size: int
                 ) -> Iterator[tuple[np.ndarray, np.ndarray, int]]:
    """Host eval batches (images, masks, valid), the ragged tail padded with
    zeros to ``batch_size``."""
    n = len(domain)
    for start in range(0, n, batch_size):
        stop = min(start + batch_size, n)
        imgs = domain.images[start:stop].astype(np.float32)
        msks = domain.masks[start:stop].astype(np.float32)
        valid = stop - start
        if valid < batch_size:
            pad = batch_size - valid
            imgs = np.concatenate([imgs, np.zeros((pad,) + imgs.shape[1:], np.float32)])
            msks = np.concatenate([msks, np.zeros((pad,) + msks.shape[1:], np.float32)])
        yield imgs, msks, valid
