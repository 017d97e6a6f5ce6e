"""Random sampling in batches that share one resolution (the AR bucket),
split over the ranks of a data-parallel run.

Counterpart of `dust3r_tpu/datasets/base/batched_sampler.py`, with the same
draws: an epoch is a permutation of the usable sample ids, cut into rows
of `batch_size`, and one bucket drawn per row, from a generator seeded by
the epoch (+ 777), so every rank derives the same plan; rank r walks its
contiguous run of `batches_per_rank` rows. It yields (sample index, bucket
index) tuples; the data loader groups them `batch_size` at a time
(`torch.utils.data.BatchSampler`).
"""
from __future__ import annotations

import numpy as np

_EPOCH_SEED_OFFSET = 777


class BatchedRandomSampler:
    def __init__(self, dataset, batch_size, pool_size, world_size=1, rank=0, drop_last=True):
        if world_size > 1 and not drop_last:
            raise ValueError("must drop the last batch in distributed mode")
        self.batch_size = batch_size
        self.pool_size = pool_size
        self.world_size = world_size
        self.rank = rank
        self.epoch = None
        n = len(dataset)
        # whole batches divisible across the ranks (drop_last), or every
        # sample, a ragged last batch included (one rank)
        self.total_size = (n // (batch_size * world_size) * batch_size * world_size
                           if drop_last else n)
        self.n_batches = -(-self.total_size // batch_size)
        self.batches_per_rank = -(-self.n_batches // world_size)

    def __len__(self):
        return self.total_size // self.world_size

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        if self.epoch is None and self.world_size > 1:
            raise ValueError("use set_epoch() in distributed mode")
        seed = None if self.epoch is None else self.epoch + _EPOCH_SEED_OFFSET
        rng = np.random.default_rng(seed)
        samples = rng.permutation(self.total_size)
        buckets = rng.integers(self.pool_size, size=self.n_batches)
        first = self.rank * self.batches_per_rank
        for b in range(first, min(first + self.batches_per_rank, self.n_batches)):
            feat = int(buckets[b])
            for s in samples[b * self.batch_size:(b + 1) * self.batch_size]:
                yield int(s), feat
