"""Waymo Open Dataset.

Counterpart of `dust3r_tpu/datasets/waymo.py`: one `waymo_pairs.npz`
holds the scene and frame name tables and an integer pair table
(scene_id, frame1_id, frame2_id) indexing them; a frame is
<scene>/<frame>.{jpg,exr,npz} with a 4x4 cam2world and a sparse (lidar)
depth map.

Disk layout (`datasets_preprocess/preprocess_waymo.py`, 512 on the long
edge):
  ROOT/waymo_pairs.npz
  ROOT/{scene}/{frame}.{jpg,exr,npz}
"""
from __future__ import annotations

import os.path as osp

import numpy as np

from ..utils.image import imread_cv2
from .base.pair_table_dataset import PairTableDataset


class Waymo(PairTableDataset):
    """Outdoor driving scenes."""

    dataset_label = "Waymo"

    def __init__(self, *args, ROOT, **kwargs):
        self.ROOT = ROOT
        super().__init__(*args, **kwargs)
        with np.load(osp.join(ROOT, "waymo_pairs.npz")) as tables:
            self.scenes = tables["scenes"]
            self.frames = tables["frames"]
            self.pairs = tables["pairs"]
        if self.pairs[:, 0].max() != len(self.scenes) - 1:
            raise ValueError(f"the pair table's last scene id {self.pairs[:, 0].max()} is not "
                             f"the scene table's last, {len(self.scenes) - 1}")

    @property
    def n_scenes(self):
        return len(self.scenes)

    def _locate(self, row, rng):
        scene_id, f1, f2 = row
        return str(self.scenes[scene_id]), [str(self.frames[f1]), str(self.frames[f2])]

    def _read_frame(self, label, frame, rng):
        stem = osp.join(self.ROOT, label, frame)
        cam = np.load(stem + ".npz")
        return dict(img=imread_cv2(stem + ".jpg"), depthmap=imread_cv2(stem + ".exr"),
                    camera_pose=np.float32(cam["cam2world"]),
                    camera_intrinsics=np.float32(cam["intrinsics"]), instance=frame)
