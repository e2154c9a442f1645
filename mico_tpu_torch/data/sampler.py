"""Sharded index samplers (counterpart of `mico_tpu/data/sampler.py`).

The reference's per-rank samplers:
  - torch DistributedSampler (train: shuffle, pad to a multiple of
    world_size so every rank sees the same number of batches);
  - DistributedSampler_wopadding (eval: no padding, so no eval sample is
    seen twice; reference data/utils/distributed.py:153-181).
The order comes from `np.random.default_rng(seed + epoch)`, as the JAX
package draws it, so both give the same indices for one seed. Across
processes each rank takes its shard (`data/build.py`): every rank draws
the same permutation and keeps every world-th index from its rank on.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np


class ShardedSampler:
    def __init__(self, num_samples: int, num_shards: int = 1,
                 shard_id: int = 0, shuffle: bool = True, pad: bool = True,
                 seed: int = 0):
        assert 0 <= shard_id < num_shards
        self.num_samples = num_samples
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.shuffle = shuffle
        self.pad = pad
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> List[int]:
        if self.shuffle:
            g = np.random.default_rng(self.seed + self.epoch)
            order = g.permutation(self.num_samples)
        else:
            order = np.arange(self.num_samples)
        if self.pad:
            total = ((self.num_samples + self.num_shards - 1)
                     // self.num_shards) * self.num_shards
            if total > len(order):
                order = np.concatenate([order, order[: total - len(order)]])
            return list(order[self.shard_id : total : self.num_shards])
        # no padding: a shard takes indices[shard::num_shards]; trailing
        # shards may get one fewer (reference distributed.py:170-176)
        return list(order[self.shard_id :: self.num_shards])

    def __iter__(self) -> Iterator[int]:
        return iter(self._indices())

    def __len__(self) -> int:
        if self.pad:
            return (self.num_samples + self.num_shards - 1) // self.num_shards
        n, k = divmod(self.num_samples, self.num_shards)
        return n + (1 if self.shard_id < k else 0)
