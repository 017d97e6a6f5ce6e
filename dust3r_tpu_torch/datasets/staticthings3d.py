"""StaticThings3D.

Counterpart of `dust3r_tpu/datasets/staticthings3d.py`: the pair table
`staticthings_pairs.npy` has rows (scene, seq, cam1, im1, cam2, im2) with
byte-string camera tags; each frame exists in a "clean" and a "final"
render pass, one drawn per view; depths beyond 200 units are the
renderer's background, set to 0 when the background is masked (mask_bg
True, False or 'rand': drawn once a pair).

The draws come in JAX's order from the item's generator: the pair's
mask draw in `_locate`, then each frame's render pass in `_read_frame`,
before that frame's crop draws.

Disk layout (`datasets_preprocess/preprocess_staticthings3d.py`, 512x384):
  ROOT/staticthings_pairs.npy
  ROOT/TRAIN/{scene}/{seq:04d}/{left,right}/{num:04n}{.exr,.npz,_clean.jpg,_final.jpg}
"""
from __future__ import annotations

import os.path as osp

import numpy as np

from ..utils.image import imread_cv2
from .base.pair_table_dataset import PairTableDataset

_CAM_DIR = {b"l": "left", b"r": "right"}
_FAR_BG = 200  # the depth past which a pixel is the renderer's background


class StaticThings3D(PairTableDataset):
    """Synthetic indoor scenes (static FlyingThings3D)."""

    dataset_label = "StaticThings3D"

    def __init__(self, ROOT, *args, mask_bg="rand", **kwargs):
        self.ROOT = ROOT
        super().__init__(*args, **kwargs)
        if mask_bg not in (True, False, "rand"):
            raise ValueError(f"mask_bg {mask_bg!r} not in (True, False, 'rand')")
        self.mask_bg = mask_bg
        if self.split is not None:
            raise ValueError(f"StaticThings3D has no split, got split={self.split!r}")
        self.pairs = np.load(osp.join(ROOT, "staticthings_pairs.npy"))

    def _locate(self, row, rng):
        scene, seq, cam1, im1, cam2, im2 = row
        label = osp.join("TRAIN", scene.decode("ascii"), f"{seq:04d}")
        # one background-mask draw covers both views of the pair
        self._mask_bg_now = (self.mask_bg is True) or (
            self.mask_bg == "rand" and rng.choice(2))
        return label, [(_CAM_DIR[cam1], int(im1)), (_CAM_DIR[cam2], int(im2))]

    def _read_frame(self, label, frame, rng):
        cam_dir, num = frame
        render_pass = "clean" if rng.choice(2) else "final"
        stem = osp.join(self.ROOT, label, cam_dir, f"{num:04n}")
        cam = np.load(stem + ".npz")
        depth = imread_cv2(stem + ".exr")
        if self._mask_bg_now:
            depth[depth > _FAR_BG] = 0
        return dict(img=imread_cv2(f"{stem}_{render_pass}.jpg"), depthmap=depth,
                    camera_pose=cam["cam2world"], camera_intrinsics=cam["intrinsics"],
                    instance=f"{cam_dir}_{num:04n}_{render_pass}.jpg")
