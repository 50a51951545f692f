"""Index samplers of the loaders; the port's copy of
``simpledepthestimation_tpu/data/samplers.py``, with numpy generators so that
the index order is the JAX package's: ``EpochSampler`` (per-epoch reshuffle,
padded to equal shards), ``TrainingSampler`` (an infinite rank-strided
stream) and ``InferenceSampler`` (contiguous shards covering the dataset
exactly).
"""

from __future__ import annotations

import itertools
from typing import Iterator, Optional

import numpy as np


class EpochSampler:
    """Per-epoch shuffled, padded, rank-sharded indices (DistributedSampler
    semantics: pad to a multiple of world_size by wrapping, then stride)."""

    def __init__(
        self,
        size: int,
        shuffle: bool = True,
        seed: int = 0,
        rank: int = 0,
        world_size: int = 1,
    ):
        assert size > 0
        self._size = size
        self._shuffle = shuffle
        self._seed = int(seed)
        self._rank = rank
        self._world = world_size
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def __len__(self) -> int:
        return (self._size + self._world - 1) // self._world

    def __iter__(self) -> Iterator[int]:
        if self._shuffle:
            g = np.random.default_rng(self._seed + self.epoch)
            indices = g.permutation(self._size)
        else:
            indices = np.arange(self._size)
        # pad by wrapping so every rank sees the same count
        total = len(self) * self._world
        if total > self._size:
            indices = np.concatenate([indices, indices[: total - self._size]])
        yield from indices[self._rank :: self._world].tolist()


class TrainingSampler:
    """Infinite stream of shuffled epochs, rank-strided
    (reference distributed_sampler.py:12-54)."""

    def __init__(
        self,
        size: int,
        shuffle: bool = True,
        seed: int = 0,
        rank: int = 0,
        world_size: int = 1,
    ):
        assert size > 0
        self._size = size
        self._shuffle = shuffle
        self._seed = int(seed)
        self._rank = rank
        self._world = world_size

    def __iter__(self) -> Iterator[int]:
        yield from itertools.islice(self._infinite(), self._rank, None, self._world)

    def _infinite(self) -> Iterator[int]:
        g = np.random.default_rng(self._seed)
        while True:
            if self._shuffle:
                yield from g.permutation(self._size).tolist()
            else:
                yield from range(self._size)


class InferenceSampler:
    """Contiguous shards covering the exact dataset; ranks may get unequal
    counts (reference distributed_sampler.py:57-84)."""

    def __init__(self, size: int, rank: int = 0, world_size: int = 1):
        assert size > 0
        shard_size = (size - 1) // world_size + 1
        begin = min(shard_size * rank, size)
        end = min(shard_size * (rank + 1), size)
        self._local_indices = range(begin, end)

    def __len__(self) -> int:
        return len(self._local_indices)

    def __iter__(self) -> Iterator[int]:
        yield from self._local_indices
