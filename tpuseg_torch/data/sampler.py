"""Per-host index sharding (reference: datasets/sampler.py:43-110).

Each rank takes a strided shard of an epoch-seeded permutation and feeds
its local slice of the global batch. Padded shards (training) repeat the
first indices so that every rank has the same length; unpadded shards
(validation) take ``indices[shard::num_shards]``, so the split is scored
exactly once over the ranks and shard lengths differ by at most one.
(``tpuseg``'s unpadded shards keep ``len // ranks`` indices each and skip
the last ``len % ranks``.)
"""
from __future__ import annotations

import numpy as np


class ShardedEpochSampler:
    """Epoch-seeded permutation, host-strided slicing; ``pad`` repeats
    indices up to a multiple of ``num_shards``, else each index is in
    exactly one shard."""

    def __init__(self, dataset_len: int, num_shards: int = 1, shard: int = 0,
                 shuffle: bool = True, pad: bool = True, seed: int = 0):
        self.dataset_len = dataset_len
        self.num_shards = num_shards
        self.shard = shard
        self.shuffle = shuffle
        self.pad = pad
        self.seed = seed
        self.epoch = 0
        self._recompute()

    def _recompute(self):
        if self.pad:
            self.num_samples = -(-self.dataset_len // self.num_shards)
            self.total_size = self.num_samples * self.num_shards
        else:
            self.num_samples = len(range(self.shard, self.dataset_len,
                                         self.num_shards))
            self.total_size = self.dataset_len

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def set_dataset_len(self, n: int):
        """After coarse-disable resize (reference: sampler.py:106-110)."""
        self.dataset_len = n
        self._recompute()

    def __len__(self):
        return self.num_samples

    def __iter__(self):
        rng = np.random.default_rng((self.seed, self.epoch))
        if self.shuffle:
            indices = rng.permutation(self.dataset_len).tolist()
        else:
            indices = list(range(self.dataset_len))
        if self.total_size > len(indices):
            indices += indices[: self.total_size - len(indices)]
        indices = indices[self.shard:self.total_size:self.num_shards]
        assert len(indices) == self.num_samples
        return iter(indices)
