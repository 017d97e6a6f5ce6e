"""Habitat (pre-rendered five-view fans).

Counterpart of `dust3r_tpu/datasets/habitat.py`: each scene key names a
rendered fan of 5 views where the first (slot 0, the hub) overlaps every
other; a sample pairs the hub with one view drawn from slots 1-4; a view
whose stored pose is not finite (a renderer failure) is walked past to
the next slot, cyclically, and the requested slot is recorded as its
`instance`.

Disk layout (`datasets_preprocess/habitat/preprocess_habitat.py`, 512x512):
  ROOT/Habitat_{size}_scenes_{split}.txt   one scene key a line
  <scene dir>/<key>_{v}.jpeg               the image, v in 1..5
  <scene dir>/<key>_{v}_depth.exr          metric depth (half floats)
  <scene dir>/<key>_{v}_camera_params.json intrinsics, R / t cam2world
"""
from __future__ import annotations

import json
import os.path as osp

import numpy as np

from ..utils.image import imread_cv2
from .base.base_stereo_view_dataset import BaseStereoViewDataset

_N_VIEWS = 5  # views a fan; the hub view (file index 1) sees all


class Habitat(BaseStereoViewDataset):
    LAYOUT = dict(img="{key}_{v}.jpeg", depth="{key}_{v}_depth.exr",
                  cam="{key}_{v}_camera_params.json")

    def __init__(self, size, *args, ROOT, **kwargs):
        self.ROOT = ROOT
        super().__init__(*args, **kwargs)
        if self.split is None:
            raise ValueError("Habitat needs a split")
        with open(osp.join(ROOT, f"Habitat_{size}_scenes_{self.split}.txt")) as f:
            self.scenes = f.read().splitlines()
        self.instances = list(range(1, _N_VIEWS))  # the hub's partners: slots 1..4

    def filter_scene(self, label, instance=None):
        """Keep the scenes under `label`; an instance "<subscene>_<view>"
        also pins the partner view."""
        if instance:
            subscene, view = instance.split("_")
            label = f"{label}/{subscene}"
            self.instances = [int(view) - 1]
        kept = [s for s in self.scenes if s.startswith(label)]
        if not kept:
            raise ValueError(f"no scene was selected for {label=} {instance=}")
        self.scenes = kept

    def _frame_path(self, kind, scene_dir, key, slot):
        # slots count from 0, files from 1
        return osp.join(scene_dir, self.LAYOUT[kind].format(key=key, v=slot + 1))

    def _read_frame(self, scene_dir, key, slot, resolution, rng):
        """One rendered view -> (view dict, whether its pose is finite)."""
        import PIL.Image

        impath = self._frame_path("img", scene_dir, key, slot)
        image = PIL.Image.open(impath)
        depthmap = imread_cv2(self._frame_path("depth", scene_dir, key, slot))
        with open(self._frame_path("cam", scene_dir, key, slot)) as f:
            cam = json.load(f)
        intrinsics = np.float32(cam["camera_intrinsics"])
        camera_pose = np.eye(4, dtype=np.float32)
        camera_pose[:3, :3] = cam["R_cam2world"]
        camera_pose[:3, 3] = cam["t_cam2world"]
        image, depthmap, intrinsics = self._crop_resize_if_necessary(
            image, depthmap, intrinsics, resolution, rng, info=impath)
        view = dict(img=image, depthmap=depthmap, camera_pose=camera_pose,  # cam2world
                    camera_intrinsics=intrinsics, dataset="Habitat",
                    label=osp.relpath(scene_dir, self.ROOT), instance=f"{key}_{slot}")
        return view, bool(np.isfinite(camera_pose).all())

    def _get_views(self, idx, resolution, rng):
        scene_dir, key = osp.split(osp.join(self.ROOT, self.scenes[idx]))
        views = []
        for slot in (0, rng.choice(self.instances)):  # the hub and one partner
            for step in range(_N_VIEWS):  # walk (cyclically) past broken renders
                view, ok = self._read_frame(scene_dir, key, (slot + step) % _N_VIEWS,
                                            resolution, rng)
                if ok:
                    break
            view["instance"] = f"{key}_{slot}"  # the requested slot, as JAX records it
            views.append(view)
        return views
