"""Scenes with a known answer for the global aligner, host numpy."""
from __future__ import annotations

import numpy as np

from ..utils.geometry import depthmap_to_absolute_camera_coordinates, geotrf, inv


def synthetic_scene(n_imgs, H, W, focal, seed=0):
    """Exact pairwise pointmaps of a known scene, as tests/test_cloud_opt.py
    builds them: a smooth per-image depth and a circular camera rig,
    complete symmetrized graph. Returns (inference-style output, cam2world
    poses, focal)."""
    rng = np.random.default_rng(seed)
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], np.float32)
    poses, world_pts = [], []
    for k in range(n_imgs):
        ang = 0.25 * k
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]]
        pose[:3, 3] = [np.sin(ang) * 2, 0.1 * k, -2 * np.cos(ang)]
        poses.append(pose)
        yy, xx = np.mgrid[:H, :W]
        depth = (2.5 + 0.5 * np.sin(xx / 7 + k) * np.cos(yy / 5)
                 + 0.05 * rng.standard_normal((H, W))).astype(np.float32)
        world_pts.append(depthmap_to_absolute_camera_coordinates(depth, K, pose)[0])
    edges = [(i, j) for i in range(n_imgs) for j in range(n_imgs) if i != j]
    pred1, pred2, conf1, conf2 = [], [], [], []
    for i, j in edges:
        w2c = inv(poses[i])
        pred1.append(geotrf(w2c, world_pts[i]))
        pred2.append(geotrf(w2c, world_pts[j]))
        conf1.append(np.full((H, W), 3.5, np.float32) + rng.uniform(0, 1, (H, W)).astype(np.float32))
        conf2.append(np.full((H, W), 3.5, np.float32) + rng.uniform(0, 1, (H, W)).astype(np.float32))
    out = dict(view1=dict(idx=[i for i, j in edges]), view2=dict(idx=[j for i, j in edges]),
               pred1=dict(pts3d=np.stack(pred1), conf=np.stack(conf1)),
               pred2=dict(pts3d_in_other_view=np.stack(pred2), conf=np.stack(conf2)))
    return out, poses, focal
