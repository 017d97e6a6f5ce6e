"""ARKitScenes and ScanNet++ (one all_metadata.npz each).

Counterpart of `dust3r_tpu/datasets/arkitscenes.py`: a metadata npz
(scenes, sceneids, images, intrinsics, trajectories, pairs) describes
every frame and the selected pairs; a frame is a JPEG and a uint16 PNG
depth in millimetres, read unchanged, divided by 1000, its non-finite
values set to 0.

Disk layouts:
  ARKitScenes (`datasets_preprocess/preprocess_arkitscenes.py`):
    ROOT/{Training,Test}/all_metadata.npz
    ROOT/{Training,Test}/{scene}/vga_wide/{image with .jpg}   640x480
    ROOT/{Training,Test}/{scene}/lowres_depth/{image}.png     resized to it
  ScanNet++ (`datasets_preprocess/preprocess_scannetpp.py`):
    ROOT/all_metadata.npz
    ROOT/{scene}/images/{image}.jpg                           920x690
    ROOT/{scene}/depth/{image}.png
"""
from __future__ import annotations

import os.path as osp

import numpy as np

from ..utils.image import IMREAD_UNCHANGED, imread_cv2
from .base.base_stereo_view_dataset import BaseStereoViewDataset


class _MetadataPairsDataset(BaseStereoViewDataset):
    """One all_metadata.npz describing every frame and the pairs."""

    dataset_label = "?"

    def __init__(self, *args, ROOT, **kwargs):
        self.ROOT = ROOT
        super().__init__(*args, **kwargs)
        self._load_data()

    def _metadata_dir(self):
        return self.ROOT

    def _load_data(self):
        with np.load(osp.join(self._metadata_dir(), "all_metadata.npz")) as d:
            self.scenes = d["scenes"]
            self.sceneids = d["sceneids"]
            self.images = d["images"]
            self.intrinsics = d["intrinsics"].astype(np.float32)
            self.trajectories = d["trajectories"].astype(np.float32)
            self.pairs = d["pairs"][:, :2].astype(int)

    def __len__(self):
        return len(self.pairs)

    def _rgb_path(self, scene_dir, basename):
        raise NotImplementedError

    def _depth_path(self, scene_dir, basename):
        raise NotImplementedError

    def _scene_dir(self, scene_id):
        return osp.join(self._metadata_dir(), self.scenes[scene_id])

    def _get_views(self, idx, resolution, rng):
        views = []
        for view_idx in self.pairs[idx]:
            scene_id = self.sceneids[view_idx]
            scene_dir = self._scene_dir(scene_id)
            basename = self.images[view_idx]
            rgb_image = imread_cv2(self._rgb_path(scene_dir, basename))
            depthmap = imread_cv2(self._depth_path(scene_dir, basename), IMREAD_UNCHANGED)
            depthmap = depthmap.astype(np.float32) / 1000
            depthmap[~np.isfinite(depthmap)] = 0
            rgb_image, depthmap, intrinsics = self._crop_resize_if_necessary(
                rgb_image, depthmap, self.intrinsics[view_idx], resolution, rng=rng,
                info=view_idx)
            views.append(dict(img=rgb_image, depthmap=depthmap.astype(np.float32),
                              camera_pose=self.trajectories[view_idx].astype(np.float32),
                              camera_intrinsics=intrinsics.astype(np.float32),
                              dataset=self.dataset_label,
                              label=self.scenes[scene_id] + "_" + basename,
                              instance=f"{idx}_{view_idx}"))
        return views


class ARKitScenes(_MetadataPairsDataset):
    dataset_label = "arkitscenes"

    def __init__(self, *args, split, ROOT, **kwargs):
        splits = {"train": "Training", "test": "Test"}
        if split not in splits:
            raise ValueError(f"bad split={split}")
        super().__init__(*args, split=splits[split], ROOT=ROOT, **kwargs)

    def _metadata_dir(self):
        return osp.join(self.ROOT, self.split)

    def _rgb_path(self, scene_dir, basename):
        return osp.join(scene_dir, "vga_wide", basename.replace(".png", ".jpg"))

    def _depth_path(self, scene_dir, basename):
        return osp.join(scene_dir, "lowres_depth", basename)


class ScanNetpp(_MetadataPairsDataset):
    dataset_label = "ScanNet++"

    def __init__(self, *args, ROOT, **kwargs):
        super().__init__(*args, ROOT=ROOT, **kwargs)
        if self.split != "train":
            raise ValueError(f"ScanNet++ has the train split only, got split={self.split!r}")

    def _rgb_path(self, scene_dir, basename):
        return osp.join(scene_dir, "images", basename + ".jpg")

    def _depth_path(self, scene_dir, basename):
        return osp.join(scene_dir, "depth", basename + ".png")
