"""Random sampling in batches that share one resolution (the AR bucket).

Counterpart of `dust3r_tpu/datasets/base/batched_sampler.py` on one
process, with the same draws: an epoch is a permutation of the usable
sample ids, cut into rows of `batch_size`, and one bucket drawn per row,
from a generator seeded by the epoch (+ 777). It yields (sample index,
bucket index) tuples; the data loader groups them `batch_size` at a time
(`torch.utils.data.BatchSampler`). The split across ranks comes with data
parallelism (ROADMAP A10).
"""
from __future__ import annotations

import numpy as np

_EPOCH_SEED_OFFSET = 777


class BatchedRandomSampler:
    def __init__(self, dataset, batch_size, pool_size, drop_last=True):
        self.batch_size = batch_size
        self.pool_size = pool_size
        self.epoch = None
        n = len(dataset)
        self.total_size = n // batch_size * batch_size if drop_last else n
        self.n_batches = -(-self.total_size // batch_size)

    def __len__(self):
        return self.total_size

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        seed = None if self.epoch is None else self.epoch + _EPOCH_SEED_OFFSET
        rng = np.random.default_rng(seed)
        samples = rng.permutation(self.total_size)
        buckets = rng.integers(self.pool_size, size=self.n_batches)
        for b in range(self.n_batches):
            feat = int(buckets[b])
            for s in samples[b * self.batch_size:(b + 1) * self.batch_size]:
                yield int(s), feat
