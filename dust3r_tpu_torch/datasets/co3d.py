"""Co3D_v2 and WildRGB-D loaders.

Counterpart of `dust3r_tpu/datasets/co3d.py`: pairs of frames of one
100-frame sequence at index gaps of 5 to 30, each endpoint jittered by up
to 4 frames; JPEG images, PNG depth (Co3d: 16-bit, scaled by the frame's
maximum_depth; WildRGB-D: millimetres), optional background masking
(mask_bg True, False or 'rand': half of the time), and a frame whose
cropped depth is empty replaced by its nearest valid neighbour.

Disk layout (`datasets_preprocess/preprocess_co3d.py`):
  ROOT/selected_seqs_{split}.json
  ROOT/{category}/{sequence}/<LAYOUT entries below>
"""
from __future__ import annotations

import itertools
import json
import os.path as osp
from collections import deque

import numpy as np

from ..utils.image import IMREAD_UNCHANGED, imread_cv2
from .base.base_stereo_view_dataset import BaseStereoViewDataset

_PAIR_DELTAS = [(i, j) for i, j in itertools.combinations(range(100), 2)
                if 0 < abs(i - j) <= 30 and abs(i - j) % 5 == 0]
_JITTER = 4


class Co3d(BaseStereoViewDataset):
    LAYOUT = dict(
        meta=("images", "frame{v:06d}.npz"),
        img=("images", "frame{v:06d}.jpg"),
        depth=("depths", "frame{v:06d}.jpg.geometric.png"),
        mask=("masks", "frame{v:06d}.png"),
    )

    def __init__(self, mask_bg=True, *args, ROOT, **kwargs):
        self.ROOT = ROOT
        super().__init__(*args, **kwargs)
        if mask_bg not in (True, False, "rand"):
            raise ValueError(f"mask_bg {mask_bg!r} not in (True, False, 'rand')")
        self.mask_bg = mask_bg
        self.dataset_label = "Co3d_v2"
        self.scenes = self._load_scene_index()
        self.scene_list = list(self.scenes.keys())
        self.combinations = _PAIR_DELTAS
        # per (scene, resolution): frames whose cropped depth came back empty
        self.invalidate = {scene: {} for scene in self.scene_list}

    def _load_scene_index(self):
        with open(osp.join(self.ROOT, f"selected_seqs_{self.split}.json")) as f:
            per_category = json.load(f)
        return {(cat, seq): frames for cat, seqs in per_category.items() if seqs
                for seq, frames in seqs.items()}

    def __len__(self):
        return len(self.scene_list) * len(self.combinations)

    def _frame_path(self, kind, scene, view_idx):
        sub, template = self.LAYOUT[kind]
        return osp.join(self.ROOT, *scene, sub, template.format(v=view_idx))

    def _decode_depth(self, raw, metadata):
        return (raw.astype(np.float32) / 65535
                * np.nan_to_num(metadata["maximum_depth"])).astype(np.float32)

    def _load_frame(self, scene, view_idx, resolution, rng):
        """One frame's view (masked, cropped, resized) and its count of valid
        depth pixels."""
        impath = self._frame_path("img", scene, view_idx)
        metadata = np.load(self._frame_path("meta", scene, view_idx))
        camera_pose = metadata["camera_pose"].astype(np.float32)
        intrinsics = metadata["camera_intrinsics"].astype(np.float32)
        rgb_image = imread_cv2(impath)
        raw_depth = imread_cv2(self._frame_path("depth", scene, view_idx), IMREAD_UNCHANGED)
        depthmap = self._decode_depth(raw_depth, metadata)
        if self.mask_bg:
            mask = imread_cv2(self._frame_path("mask", scene, view_idx), IMREAD_UNCHANGED)
            fg = (mask.astype(np.float32) / 255) > 0.1
            if self.mask_bg != "rand" or rng.integers(2):
                depthmap = depthmap * fg
        rgb_image, depthmap, intrinsics = self._crop_resize_if_necessary(
            rgb_image, depthmap, intrinsics, resolution, rng=rng, info=impath)
        view = dict(img=rgb_image, depthmap=depthmap, camera_pose=camera_pose,
                    camera_intrinsics=intrinsics, dataset=self.dataset_label,
                    label=osp.join(*scene), instance=osp.split(impath)[1])
        return view, int((depthmap > 0.0).sum())

    def _get_views(self, idx, resolution, rng):
        scene = self.scene_list[idx // len(self.combinations)]
        image_pool = self.scenes[scene]
        i1, i2 = self.combinations[idx % len(self.combinations)]
        bad = self.invalidate[scene].setdefault(resolution, [False] * len(image_pool))
        last = len(image_pool) - 1
        queue = deque(max(0, min(e + int(rng.integers(-_JITTER, _JITTER + 1)), last))
                      for e in (i2, i1))
        views = []
        while queue:
            pool_idx = queue.popleft()
            if bad[pool_idx]:
                valid = [x for x in range(len(image_pool)) if not bad[x]]
                if not valid:
                    raise ValueError(f"All views invalid in {'/'.join(scene)}")
                pool_idx = min(valid, key=lambda x: abs(x - pool_idx))
            view, n_valid = self._load_frame(scene, image_pool[pool_idx], resolution, rng)
            if n_valid == 0:
                bad[pool_idx] = True
                queue.append(pool_idx)
                continue
            views.append(view)
        return views


class WildRGBD(Co3d):
    """WildRGB-D: Co3d's pairs, jitter and retry; its own file names and
    depth in millimetres."""

    LAYOUT = dict(
        meta=("metadata", "{v:0>5d}.npz"),
        img=("rgb", "{v:0>5d}.jpg"),
        depth=("depth", "{v:0>5d}.png"),
        mask=("masks", "{v:0>5d}.png"),
    )

    def __init__(self, mask_bg=True, *args, ROOT, **kwargs):
        super().__init__(mask_bg, *args, ROOT=ROOT, **kwargs)
        self.dataset_label = "WildRGBD"

    def _decode_depth(self, raw, metadata):
        return raw.astype(np.float32) / 1000.0
