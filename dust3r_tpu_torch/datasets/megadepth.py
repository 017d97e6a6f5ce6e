"""MegaDepth.

Counterpart of `dust3r_tpu/datasets/megadepth.py`: one `all_metadata.npz`
with the scene and image name tables and a structured pair table
(scene_id, im1_id, im2_id, score); a scene name "<landmark> <subscene>"
is a nested directory; scenes 0015 and 0022 are the val split, held out
of train. JAX forwards `split` to the base, where the reference's
keyword-only `split` shadows it (so there nothing is held out); the port
follows JAX.

Disk layout (`datasets_preprocess/preprocess_megadepth.py`, 800x600 or
600x800):
  ROOT/all_metadata.npz
  ROOT/{landmark}/{subscene}/{image}.{jpg,exr,npz}
"""
from __future__ import annotations

import os.path as osp

import numpy as np

from ..utils.image import imread_cv2
from .base.pair_table_dataset import PairTableDataset

_VAL_SCENES = ("0015", "0022")


class MegaDepth(PairTableDataset):
    dataset_label = "MegaDepth"

    def __init__(self, *args, split, ROOT, **kwargs):
        self.ROOT = ROOT
        super().__init__(*args, split=split, **kwargs)
        with np.load(osp.join(ROOT, "all_metadata.npz")) as tables:
            self.all_scenes = tables["scenes"]
            self.all_images = tables["images"]
            self.pairs = tables["pairs"]
        if self.split == "train":
            self.select_scene(_VAL_SCENES, opposite=True)
        elif self.split == "val":
            self.select_scene(_VAL_SCENES)
        elif self.split is not None:
            raise ValueError(f"bad split={self.split}")

    @property
    def n_scenes(self):
        return len(self.all_scenes)

    def select_scene(self, scene, *instances, opposite=False):
        """Keep the pairs of the scenes (and, given, the images) whose names
        start with the given prefixes; opposite=True keeps the others. Two
        instance prefixes pin both images of a pair, one pins either."""
        prefixes = (scene,) if isinstance(scene, str) else tuple(scene)
        scene_hit = [s.startswith(prefixes) for s in self.all_scenes]
        if not any(scene_hit):
            raise ValueError("no scene found")
        keep = np.isin(self.pairs["scene_id"], np.nonzero(scene_hit)[0])
        if instances:
            image_ids = np.nonzero([im.startswith(instances) for im in self.all_images])[0]
            if not len(image_ids):
                raise ValueError("no instance found")
            hit1 = np.isin(self.pairs["im1_id"], image_ids)
            hit2 = np.isin(self.pairs["im2_id"], image_ids)
            keep &= (hit1 & hit2) if len(instances) == 2 else (hit1 | hit2)
        if opposite:
            keep = ~keep
        if not keep.any():
            raise ValueError("no pair left")
        self.pairs = self.pairs[keep]

    def _locate(self, row, rng):
        scene_id, im1, im2, _score = row
        landmark, subscene = self.all_scenes[scene_id].split()
        return osp.join(landmark, subscene), [int(im1), int(im2)]

    def _read_frame(self, label, frame, rng):
        name = self.all_images[frame]
        stem = osp.join(self.ROOT, label, name)
        try:
            img = imread_cv2(stem + ".jpg")
            depth = imread_cv2(stem + ".exr")
            cam = np.load(stem + ".npz")
        except Exception as e:  # noqa: BLE001 - the JAX loader's message, its cause kept
            raise OSError(f"cannot load {name}, got exception {e}") from e
        return dict(img=img, depthmap=depth, camera_pose=np.float32(cam["cam2world"]),
                    camera_intrinsics=np.float32(cam["intrinsics"]), instance=name)
