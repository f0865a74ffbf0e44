"""Epoch-seeded index samplers; counterpart of ``nerf_tpu/data/samplers.py``.

A numpy copy: the same index sequences as the JAX package's for the same
seed. ``DistributedEpochSampler`` (an epoch-seeded shuffle, one shard a
rank, padded by wrap-around), ``IterationBasedSampler`` (a fixed number of
indices, epoch after epoch) and ``ImageSizeBatchSampler`` (one random crop
size a batch); and ``make_dataset_catalog``, the dataset roots by name.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


def epoch_shuffled_indices(n: int, epoch: int, seed: int = 0,
                           shuffle: bool = True) -> np.ndarray:
    """Deterministic per-epoch permutation (DistributedSampler semantics:
    every rank computes the same order for a given epoch)."""
    if not shuffle:
        return np.arange(n)
    rng = np.random.RandomState(seed + epoch)
    return rng.permutation(n)


def shard_indices(indices: np.ndarray, rank: int, world_size: int,
                  pad: bool = True) -> np.ndarray:
    """Contiguous-strided shard of an index list for one rank; pads by
    wrap-around so every rank gets equal length (DistributedSampler :107-125)."""
    n = len(indices)
    if pad and n % world_size != 0:
        extra = world_size - n % world_size
        indices = np.concatenate([indices, indices[:extra]])
    return indices[rank::world_size]


class DistributedEpochSampler:
    """Iterate dataset indices: epoch-seeded shuffle -> rank shard."""

    def __init__(self, n_items: int, rank: int = 0, world_size: int = 1,
                 shuffle: bool = True, seed: int = 0):
        self.n_items = n_items
        self.rank = rank
        self.world_size = world_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        idx = epoch_shuffled_indices(self.n_items, self.epoch, self.seed,
                                     self.shuffle)
        return iter(shard_indices(idx, self.rank, self.world_size).tolist())

    def __len__(self) -> int:
        return -(-self.n_items // self.world_size)


class IterationBasedSampler:
    """Repeat an index stream until ``num_iterations`` items are yielded
    (IterationBasedBatchSampler :50-72)."""

    def __init__(self, base: DistributedEpochSampler, num_iterations: int,
                 start_iter: int = 0):
        self.base = base
        self.num_iterations = num_iterations
        self.start_iter = start_iter

    def __iter__(self):
        it = self.start_iter
        epoch = self.base.epoch
        while it < self.num_iterations:
            self.base.set_epoch(epoch)
            for idx in self.base:
                if it >= self.num_iterations:
                    return
                yield idx
                it += 1
            epoch += 1

    def __len__(self):
        return self.num_iterations - self.start_iter


class ImageSizeBatchSampler:
    """Batches of (H, W, index): one random crop size per batch (reference
    ``ImageSizeBatchSampler``, samplers.py:10-47 — template residue there,
    implemented for surface completeness). Sizes are drawn uniformly from
    [min, max] rounded to multiples of ``divisor``; the same (H, W) is
    attached to every sample of a batch so variable-resolution pipelines can
    collate."""

    def __init__(self, sampler, batch_size: int, drop_last: bool = False,
                 min_size: int = 256, max_size: int = 480, divisor: int = 32,
                 seed: int = 0):
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.hmin = self.wmin = min_size
        self.hmax = self.wmax = max_size
        self.divisor = divisor
        self.rng = np.random.RandomState(seed)

    def _rand_size(self):
        h = self.rng.randint(self.hmin, self.hmax + 1)
        w = self.rng.randint(self.wmin, self.wmax + 1)
        h = (h | (self.divisor - 1)) + 1
        w = (w | (self.divisor - 1)) + 1
        return h, w

    def __iter__(self):
        batch = []
        h, w = self._rand_size()
        for idx in self.sampler:
            batch.append((idx, h, w))
            if len(batch) == self.batch_size:
                yield batch
                batch = []
                h, w = self._rand_size()
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)


def make_dataset_catalog() -> dict:
    """The static dataset-root catalog: dataset name -> its root."""
    return {
        "nerf_synthetic": "data/nerf_synthetic",
        "llff": "data/nerf_llff_data",
        "colmap": "data/colmap",
    }
