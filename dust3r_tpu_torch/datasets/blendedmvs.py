"""BlendedMVS.

Counterpart of `dust3r_tpu/datasets/blendedmvs.py`: the pair table
`blendedmvs_pairs.npy` (structured: seq_high, seq_low, img1, img2,
score); a sequence's directory is the 24 hex digits of its two ids;
split by seq_low % 10 (every tenth scene is val); the camera as separate
R_cam2world / t_cam2world arrays.

Disk layout (`datasets_preprocess/preprocess_blendedmvs.py`, 512x384):
  ROOT/blendedmvs_pairs.npy
  ROOT/{seq_high:08x}{seq_low:016x}/{frame:08n}.{jpg,exr,npz}
"""
from __future__ import annotations

import os.path as osp

import numpy as np

from ..utils.image import imread_cv2
from .base.pair_table_dataset import PairTableDataset

_SPLIT_MOD = 10  # seq_low % 10 == 0: a val scene, else train


class BlendedMVS(PairTableDataset):
    """Outdoor multi-view stereo scenes."""

    dataset_label = "BlendedMVS"

    def __init__(self, *args, ROOT, split=None, **kwargs):
        self.ROOT = ROOT
        super().__init__(*args, **kwargs)
        table = np.load(osp.join(ROOT, "blendedmvs_pairs.npy"))
        if split is not None:
            in_val = (table["seq_low"] % _SPLIT_MOD) == 0
            keep = {"train": ~in_val, "val": in_val}
            if split not in keep:
                raise ValueError(f"bad split={split}")
            table = table[keep[split]]
        self.pairs = table

    @property
    def n_scenes(self):
        return len(np.unique(self.pairs["seq_low"]))

    def _locate(self, row, rng):
        seqh, seql, img1, img2, _score = row
        return f"{seqh:08x}{seql:016x}", [int(img1), int(img2)]

    def _read_frame(self, label, frame, rng):
        stem = osp.join(self.ROOT, label, f"{frame:08n}")
        cam = np.load(stem + ".npz")
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = cam["R_cam2world"]
        pose[:3, 3] = cam["t_cam2world"]
        return dict(img=imread_cv2(stem + ".jpg"), depthmap=imread_cv2(stem + ".exr"),
                    camera_pose=pose, camera_intrinsics=np.float32(cam["intrinsics"]),
                    instance=f"{frame:08n}")
