"""Geometry the global aligner reaches: pixel grids, rigid transforms,
depth <-> pointmap conversion.

Counterpart of the parts of `dust3r_tpu/utils/geometry.py` that the aligner
and its init use. `xy_grid`, `geotrf`, `inv` and `depthmap_to_pts3d` take
torch tensors; `geotrf` and `inv` also take numpy arrays and then compute
in fp32 and return numpy, as the JAX versions compute host numpy input in
fp32 (the aligner's init calls them so). `depthmap_to_absolute_camera_coordinates`,
`get_med_dist_between_poses`, the COLMAP / OpenCV intrinsics converters and
visloc's `find_reciprocal_matches` are host numpy, as in the JAX package.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def xy_grid(W, H, origin=(0, 0), homogeneous=False, dtype=torch.float32, device=None):
    """(H, W, 2) grid with out[j, i] = (i + ox, j + oy); x (the column) first."""
    x = torch.arange(origin[0], origin[0] + W, dtype=dtype, device=device)
    y = torch.arange(origin[1], origin[1] + H, dtype=dtype, device=device)
    gy, gx = torch.meshgrid(y, x, indexing="ij")
    if homogeneous:
        return torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    return torch.stack([gx, gy], dim=-1)


def _host(fn):
    """Run a torch function on numpy arguments in fp32 and return numpy."""
    @functools.wraps(fn)
    def wrapped(*args, **kw):
        if not any(isinstance(a, np.ndarray) for a in args):
            return fn(*args, **kw)
        args = [torch.as_tensor(np.asarray(a), dtype=torch.float32) for a in args]
        return fn(*args, **kw).numpy()
    return wrapped


@_host
def geotrf(Trf, pts, ncol=None, norm=0):
    """Apply homogeneous transform(s) to points.

    Trf: (..., d+1, d+1) (rotate + translate) or (..., d, d) (linear map);
    its batch dims are a prefix of pts' batch dims. pts: (..., d). norm != 0
    projects onto the plane last-coord == norm; ncol truncates the output.
    """
    out_shape = pts.shape[:-1]
    d = pts.shape[-1]
    ncol = ncol or d
    if Trf.dim() == 2:
        R = Trf
    else:
        batch = Trf.shape[:-2]
        n_extra = pts.dim() - 1 - len(batch)
        R = Trf.reshape(*batch, *(1,) * n_extra, *Trf.shape[-2:])
    if Trf.shape[-1] == d + 1:
        # all output rows, the homogeneous one included, so that norm= can
        # divide by it
        res = torch.einsum("...ij,...j->...i", R[..., :, :d], pts) + R[..., :, d]
    elif Trf.shape[-1] == d:
        res = torch.einsum("...ij,...j->...i", R[..., :d, :d], pts)
    else:
        raise ValueError(f"incompatible shapes Trf={tuple(Trf.shape)} pts={tuple(pts.shape)}")
    if norm:
        res = res / res[..., -1:]
        if norm != 1:
            res = res * norm
    return res[..., :ncol].reshape(*out_shape, ncol)


@_host
def inv(mat):
    """Invert matrices (stacked ok)."""
    return torch.linalg.inv(mat)


def depthmap_to_pts3d(depth, pseudo_focal, pp=None):
    """Lift (B, H, W) depth to (B, H, W, 3) camera-frame points.

    pseudo_focal: (B, H, W), (B, 1, H, W) or (B, 2, H, W). pp: (B, 2), or
    None for the centre ((W-1)/2, (H-1)/2).
    """
    B, H, W = depth.shape
    if pseudo_focal.dim() == 3:
        fx = fy = pseudo_focal
    elif pseudo_focal.dim() == 4:
        fx = pseudo_focal[:, 0]
        fy = pseudo_focal[:, 1] if pseudo_focal.shape[1] == 2 else fx
    else:
        raise ValueError(f"bad focal shape {tuple(pseudo_focal.shape)}")
    grid = xy_grid(W, H, dtype=depth.dtype, device=depth.device)
    gx, gy = grid[..., 0], grid[..., 1]
    if pp is None:
        gx = (gx - (W - 1) / 2).expand(B, H, W)
        gy = (gy - (H - 1) / 2).expand(B, H, W)
    else:
        gx = gx[None] - pp[:, 0, None, None]
        gy = gy[None] - pp[:, 1, None, None]
    return torch.stack([depth * gx / fx, depth * gy / fy, depth], dim=-1)


def depthmap_to_camera_coordinates(depthmap, camera_intrinsics):
    """(H, W) depth + 3x3 K -> (H, W, 3) camera points and validity mask
    (host numpy)."""
    K = np.asarray(camera_intrinsics, dtype=np.float32)
    depthmap = np.asarray(depthmap)
    H, W = depthmap.shape
    fu, fv = K[0, 0], K[1, 1]
    cu, cv = K[0, 2], K[1, 2]
    gx, gy = np.meshgrid(np.arange(W, dtype=depthmap.dtype),
                         np.arange(H, dtype=depthmap.dtype), indexing="xy")
    # a focal of 0 (Weiszfeld on degenerate pointmaps) gives non-finite
    # points, silently, as the reference does
    with np.errstate(divide="ignore", invalid="ignore"):
        x = (gx - cu) * depthmap / fu
        y = (gy - cv) * depthmap / fv
    X_cam = np.stack([x, y, depthmap], axis=-1).astype(np.float32)
    return X_cam, depthmap > 0.0


def depthmap_to_absolute_camera_coordinates(depthmap, camera_intrinsics, camera_pose):
    """As above, then the cam2world pose applied (host numpy)."""
    X_cam, valid_mask = depthmap_to_camera_coordinates(depthmap, camera_intrinsics)
    if camera_pose is None:
        return X_cam, valid_mask
    camera_pose = np.asarray(camera_pose, dtype=np.float32)
    R, t = camera_pose[:3, :3], camera_pose[:3, 3]
    return np.einsum("ik,vuk->vui", R, X_cam) + t, valid_mask


def get_med_dist_between_poses(poses):
    """Median pairwise camera-centre distance (host)."""
    from scipy.spatial.distance import pdist

    return float(np.median(pdist([np.asarray(p)[:3, 3] for p in poses])))


def colmap_to_opencv_intrinsics(K):
    """COLMAP's pixel convention (the centre of the top-left pixel at 0.5)
    -> OpenCV's (at 0): the principal point moves by -0.5 (host numpy)."""
    K = np.array(K, copy=True)
    K[0, 2] -= 0.5
    K[1, 2] -= 0.5
    return K


def opencv_to_colmap_intrinsics(K):
    """The inverse of `colmap_to_opencv_intrinsics`."""
    K = np.array(K, copy=True)
    K[0, 2] += 0.5
    K[1, 2] += 0.5
    return K


def find_reciprocal_matches(P1, P2):
    """Reciprocal nearest neighbours between two 3D point sets (host, scipy
    cKDTree). Returns (reciprocal_in_P2: (len(P2),) bool, nn2_in_P1:
    (len(P2),) index of each P2 point's nearest P1 point, their count)."""
    from scipy.spatial import cKDTree as KDTree

    P1 = np.asarray(P1)
    P2 = np.asarray(P2)
    tree1 = KDTree(P1)
    tree2 = KDTree(P2)
    _, nn1_in_P2 = tree2.query(P1, workers=8)
    _, nn2_in_P1 = tree1.query(P2, workers=8)
    reciprocal_in_P2 = nn1_in_P2[nn2_in_P1] == np.arange(len(nn2_in_P1))
    return reciprocal_in_P2, nn2_in_P1, int(reciprocal_in_P2.sum())
