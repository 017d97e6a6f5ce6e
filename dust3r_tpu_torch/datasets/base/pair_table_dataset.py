"""The shared skeleton of the pair-table datasets.

Counterpart of `dust3r_tpu/datasets/base/pair_table_dataset.py`.
BlendedMVS, MegaDepth, StaticThings3D and Waymo are alike: an offline
preprocess script left a table of image pairs on disk, and a sample is one
row resolved to two frames (image, EXR depth, npz camera), each read and
sent through the base crop / resize.

Subclass contract:
  * `self.pairs`: the table of pair rows, set in __init__;
  * `dataset_label`: the `dataset` field of every view;
  * `_locate(row, rng)` -> (label, [frame, frame]): the sequence label
    (also each view's `label`) and two frame descriptors; the pair's
    random draws come here;
  * `_read_frame(label, frame, rng)` -> {img, depthmap, camera_pose,
    camera_intrinsics, instance} at full resolution; each frame's random
    draws come here.
"""
from __future__ import annotations

from .base_stereo_view_dataset import BaseStereoViewDataset


class PairTableDataset(BaseStereoViewDataset):
    dataset_label: str = None

    @property
    def n_scenes(self):
        """For get_stats; a subclass with a scene table overrides it."""
        return None

    def __len__(self):
        return len(self.pairs)

    def get_stats(self):
        n = self.n_scenes
        scenes = f" from {n} scenes" if n is not None else ""
        return f"{len(self)} pairs{scenes}"

    def _get_views(self, pair_idx, resolution, rng):
        label, frames = self._locate(self.pairs[pair_idx], rng)
        views = []
        for frame in frames:
            raw = self._read_frame(label, frame, rng)
            img, depth, K = self._crop_resize_if_necessary(
                raw["img"], raw["depthmap"], raw["camera_intrinsics"], resolution, rng,
                info=(label, raw["instance"]))
            views.append(dict(img=img, depthmap=depth,
                              camera_pose=raw["camera_pose"],  # cam2world
                              camera_intrinsics=K, dataset=self.dataset_label, label=label,
                              instance=raw["instance"]))
        return views
