"""Training datasets, their DSL and the data loader.

Counterpart of `dust3r_tpu/datasets/__init__.py`. The dataset DSL string
("1000 @ Co3d(...) + 100 @ WildRGBD(...)") is evaluated in a namespace of
the dataset classes and the transform names, with no builtins; the loader
is `torch.utils.data.DataLoader` over the batch-aligned sampler, with
worker processes (spawned) and pinned memory. The nine datasets of the
JAX package: Co3d, WildRGBD, ARKitScenes, BlendedMVS, MegaDepth,
ScanNetpp, StaticThings3D, Waymo and Habitat, read without cv2 (PIL, and
the port's EXR codec for the EXR depth maps).
"""
from __future__ import annotations

import multiprocessing

import numpy as np
import torch

from .base.base_stereo_view_dataset import BaseStereoViewDataset  # noqa: F401
from .arkitscenes import ARKitScenes, ScanNetpp
from .blendedmvs import BlendedMVS
from .co3d import Co3d, WildRGBD
from .habitat import Habitat
from .megadepth import MegaDepth
from .staticthings3d import StaticThings3D
from .waymo import Waymo

DATASET_CLASSES = dict(Co3d=Co3d, WildRGBD=WildRGBD, ARKitScenes=ARKitScenes,
                       BlendedMVS=BlendedMVS, MegaDepth=MegaDepth, ScanNetpp=ScanNetpp,
                       StaticThings3D=StaticThings3D, Waymo=Waymo, Habitat=Habitat)


def build_dataset(dataset_str):
    """Evaluate the dataset DSL in a restricted namespace: the dataset
    classes and the transform names the reference configs use bare
    (`transform=ColorJitter`)."""
    from .utils.transforms import TRANSFORM_DSL_NAMES

    namespace = {"__builtins__": {}}
    namespace.update(DATASET_CLASSES)
    namespace.update(TRANSFORM_DSL_NAMES)
    return eval(dataset_str, namespace)  # noqa: S307 - restricted namespace


def collate_views(samples):
    """[(view1, view2), ...] -> (view1 batch, view2 batch): arrays and
    numbers stacked into tensors, anything else (strings, index tuples)
    kept as lists."""
    out = []
    for v in range(len(samples[0])):
        batch = {}
        for k in samples[0][v].keys():
            vals = [s[v][k] for s in samples]
            if isinstance(vals[0], np.ndarray):
                batch[k] = torch.from_numpy(np.stack(vals))
            elif isinstance(vals[0], (int, float, np.integer, np.floating)):
                batch[k] = torch.from_numpy(np.asarray(vals))
            else:
                batch[k] = list(vals)
        out.append(batch)
    return tuple(out)


class DataLoader(torch.utils.data.DataLoader):
    """`torch.utils.data.DataLoader` with the JAX loader's `set_epoch`: the
    sampler's epoch (its plan) and the dataset's (ResizedDataset's
    shuffle), before each epoch's iteration (the workers take the dataset
    as it is then)."""

    def set_epoch(self, epoch):
        sampler = getattr(self.batch_sampler, "sampler", None)
        if hasattr(sampler, "set_epoch"):
            sampler.set_epoch(epoch)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)


def get_data_loader(dataset, batch_size, num_workers=4, shuffle=True, drop_last=True,
                    world_size=1, rank=0):
    """The reference's entry: a DSL string or a dataset -> the loader. A
    shuffled loader walks the batch-aligned sampler (one resolution a
    batch), rank `rank`'s share of it when `world_size` > 1; an unshuffled
    one every index in order, on every rank (test loaders are not split,
    as in JAX)."""
    if isinstance(dataset, str):
        dataset = build_dataset(dataset)
    workers = dict(num_workers=num_workers, collate_fn=collate_views,
                   pin_memory=torch.cuda.is_available())
    if num_workers > 0:
        workers["multiprocessing_context"] = multiprocessing.get_context("spawn")
    try:
        sampler = dataset.make_sampler(batch_size, shuffle=shuffle, world_size=world_size,
                                       rank=rank, drop_last=drop_last)
    except NotImplementedError:
        return DataLoader(dataset, batch_size=batch_size, shuffle=False, drop_last=drop_last,
                          **workers)
    batches = torch.utils.data.BatchSampler(sampler, batch_size, drop_last)
    return DataLoader(dataset, batch_sampler=batches, **workers)
