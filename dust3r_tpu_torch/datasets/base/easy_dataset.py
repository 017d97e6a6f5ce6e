"""Dataset algebra: `2 * ds`, `1000 @ ds`, `ds1 + ds2`.

Counterpart of `dust3r_tpu/datasets/base/easy_dataset.py`: each
combinator says how a flat index routes to (child, child index);
`ResizedDataset` shuffles once an epoch from a seed of the epoch and
repeats its child until the new size is covered.
"""
from __future__ import annotations

import numpy as np

from .batched_sampler import BatchedRandomSampler


class EasyDataset:
    """Mixin giving datasets the combinators and a sampler factory."""

    def __add__(self, other):
        return CatDataset([self, other])

    def __rmul__(self, factor):
        return MulDataset(factor, self)

    def __rmatmul__(self, new_size):
        return ResizedDataset(new_size, self)

    def set_epoch(self, epoch):
        pass  # stateless datasets have nothing to reseed

    def make_sampler(self, batch_size, shuffle=True, drop_last=True):
        if not shuffle:
            raise NotImplementedError("sequential sampling not supported")
        return BatchedRandomSampler(self, batch_size, len(self._resolutions),
                                    drop_last=drop_last)


class _IndexMapped(EasyDataset):
    """A combinator that routes a flat index into one child."""

    def _route(self, idx):
        raise NotImplementedError

    def __getitem__(self, idx):
        ar = None
        if isinstance(idx, tuple):
            idx, ar = idx
        child, cidx = self._route(int(idx))
        return child[cidx if ar is None else (cidx, ar)]

    @property
    def _resolutions(self):
        return self.dataset._resolutions


class MulDataset(_IndexMapped):
    """Each element repeated `multiplicator` times."""

    def __init__(self, multiplicator, dataset):
        if not (isinstance(multiplicator, int) and multiplicator > 0):
            raise ValueError(f"multiplicator must be a positive int, got {multiplicator!r}")
        self.multiplicator = multiplicator
        self.dataset = dataset

    def __len__(self):
        return self.multiplicator * len(self.dataset)

    def __repr__(self):
        return f"{self.multiplicator}*{self.dataset!r}"

    def _route(self, idx):
        return self.dataset, idx // self.multiplicator


class ResizedDataset(_IndexMapped):
    """Length forced to `new_size`: shuffled from a seed of the epoch,
    repeated until the new size is covered; `set_epoch` comes first."""

    def __init__(self, new_size, dataset):
        if not (isinstance(new_size, int) and new_size > 0):
            raise ValueError(f"new size must be a positive int, got {new_size!r}")
        self.new_size = new_size
        self.dataset = dataset

    def __len__(self):
        return self.new_size

    def __repr__(self):
        size = str(self.new_size)
        for i in range((len(size) - 1) // 3):
            sep = -4 * i - 3
            size = size[:sep] + "_" + size[sep:]
        return f"{size} @ {self.dataset!r}"

    def set_epoch(self, epoch):
        rng = np.random.default_rng(seed=epoch + 777)
        perm = rng.permutation(len(self.dataset))
        reps = 1 + (self.new_size - 1) // len(self.dataset)
        self._mapping = np.tile(perm, reps)[:self.new_size]
        self.dataset.set_epoch(epoch)

    def _route(self, idx):
        if not hasattr(self, "_mapping"):
            raise RuntimeError("call set_epoch() before indexing a ResizedDataset")
        return self.dataset, int(self._mapping[idx])


class CatDataset(_IndexMapped):
    """Concatenation; the children's resolution pools must agree."""

    def __init__(self, datasets):
        if not all(isinstance(d, EasyDataset) for d in datasets):
            raise TypeError("CatDataset takes EasyDatasets")
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def __repr__(self):
        return " + ".join(repr(d) for d in self.datasets)

    def set_epoch(self, epoch):
        for d in self.datasets:
            d.set_epoch(epoch)

    def _route(self, idx):
        if not 0 <= idx < len(self):
            raise IndexError(idx)
        k = int(np.searchsorted(self._offsets, idx, "right")) - 1
        return self.datasets[k], idx - int(self._offsets[k])

    @property
    def _resolutions(self):
        res = self.datasets[0]._resolutions
        if not all(tuple(d._resolutions) == tuple(res) for d in self.datasets[1:]):
            raise ValueError("concatenated datasets must share their resolutions")
        return res
