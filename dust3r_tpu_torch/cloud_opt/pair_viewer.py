"""PairViewer: the closed-form two-image "optimizer" (no gradient descent).

Counterpart of `dust3r_tpu/cloud_opt/pair_viewer.py`: focal by Weiszfeld,
relative pose by RANSAC-PnP, anchored on the more confident view. Host
numpy, the scene is two images; the accessors hand back tensors on the
scene's device, as PointCloudOptimizer's do.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.geometry import depthmap_to_absolute_camera_coordinates, geotrf, inv
from .base_opt import BasePCOptimizer
from .commons import edge_str
from .init_im_poses import estimate_focal, fast_pnp


class PairViewer(BasePCOptimizer):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        assert self.is_symmetrized and self.n_edges == 2, \
            "PairViewer requires a symmetrized 2-image scene"
        self.has_im_poses = True

        focals, pps, rel_poses, confs = [], [], [], []
        for i in range(self.n_imgs):
            s_ij = edge_str(i, 1 - i)
            conf = float(np.mean(self.conf_i[s_ij]) * np.mean(self.conf_j[s_ij]))
            if self.verbose:
                print(f"  - conf={conf:.3} for edge {i}-{1 - i}")
            confs.append(conf)
            H, W = self.imshapes[i]
            pp = np.array([W / 2, H / 2], np.float32)
            focal = estimate_focal(self.pred_i[s_ij], pp)
            focals.append(focal)
            pps.append(pp)
            # pose of camera i as seen from the other view's prediction
            res = fast_pnp(self.pred_j[edge_str(1 - i, i)], focal, msk=self.get_masks()[i],
                           pp=pp, niter_PnP=100)
            rel_poses.append(np.eye(4, dtype=np.float32) if res is None
                             else np.asarray(res[1], np.float32))

        # anchor on the more confident pair
        if confs[0] > confs[1]:
            poses = [np.eye(4, dtype=np.float32), rel_poses[1]]
            depth = [self.pred_i["0_1"][..., 2],
                     geotrf(inv(rel_poses[1]), self.pred_j["0_1"])[..., 2]]
        else:
            poses = [rel_poses[0], np.eye(4, dtype=np.float32)]
            depth = [geotrf(inv(rel_poses[0]), self.pred_j["1_0"])[..., 2],
                     self.pred_i["1_0"][..., 2]]
        self.im_poses_mat = np.stack(poses)
        self.depth = depth
        self.focals = np.asarray(focals, np.float32)
        self.pp = np.stack(pps)
        # nothing is trainable
        self.masks = {k: m * 0 for k, m in self.masks.items()}

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def get_focals(self):
        return self._tensor(self.focals)[:, None]

    def get_known_focal_mask(self):
        return np.ones(self.n_imgs, bool)

    def get_principal_points(self):
        return self._tensor(self.pp)

    def get_intrinsics(self):
        K = np.zeros((self.n_imgs, 3, 3), np.float32)
        K[:, 0, 0] = K[:, 1, 1] = self.focals
        K[:, :2, 2] = self.pp
        K[:, 2, 2] = 1
        return self._tensor(K)

    def get_im_poses(self):
        return self._tensor(self.im_poses_mat)

    def get_depthmaps(self, raw=False):
        return [self._tensor(d) for d in self.depth]

    def depth_to_pts3d(self, params=None):
        K = self.get_intrinsics().cpu().numpy()
        out = np.zeros((self.n_imgs, self.max_area, 3), np.float32)
        for i, (d, Ki, pose) in enumerate(zip(self.depth, K, self.im_poses_mat)):
            pts, _ = depthmap_to_absolute_camera_coordinates(d, Ki, pose)
            out[i, :d.size] = pts.reshape(-1, 3)
        return self._tensor(out)

    def _set_depthmap(self, idx, depth, force=False):
        if self.verbose:
            print("_set_depthmap is ignored in PairViewer")

    def forward(self):
        return float("nan")

    __call__ = forward
