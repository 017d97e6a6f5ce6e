"""Geometry of the global aligner and of training: pixel grids, rigid
transforms, depth <-> pointmap conversion, masked statistics and the
losses' pointcloud normalization.

Counterpart of the parts of `dust3r_tpu/utils/geometry.py` that the aligner
and its init use. `xy_grid`, `geotrf`, `inv` and `depthmap_to_pts3d` take
torch tensors; `geotrf` and `inv` also take numpy arrays and then compute
in fp32 and return numpy, as the JAX versions compute host numpy input in
fp32 (the aligner's init calls them so). `depthmap_to_absolute_camera_coordinates`,
`get_med_dist_between_poses`, the COLMAP / OpenCV intrinsics converters and
visloc's `find_reciprocal_matches` are host numpy, as in the JAX package.
Training's `closed_form_pose_inverse`, `depth_to_world_pts3d`, the masked
reductions (`masked_mean`, `masked_median`, `masked_quantile`: dense, with
static shapes, the same numbers as boolean indexing) and the
normalizations (`normalize_pointcloud`, `get_joint_pointcloud_depth`,
`get_joint_pointcloud_center_scale`) take torch tensors.
"""
from __future__ import annotations

import functools
import math

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


def closed_form_pose_inverse(T):
    """Invert (..., 4, 4) rigid transforms: [[Rᵀ, -Rᵀ t], [0, 1]]."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    top = torch.cat([Rt, -torch.einsum("...ij,...j->...i", Rt, t)[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=T.dtype, device=T.device)
    return torch.cat([top, bottom.expand(*T.shape[:-2], 1, 4)], dim=-2)


def depth_to_world_pts3d(depthmap, camera_intrinsics, camera_pose):
    """(B, H, W) depth, (B, 3, 3) K and (B, 4, 4) cam2world -> (B, H, W, 3)
    world points in fp32, the rays from K⁻¹ (u, v, 1) (so the row-permuted K
    of a transposed portrait view works too)."""
    d = depthmap.float()
    B, H, W = d.shape
    gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=d.device),
                            torch.arange(W, dtype=torch.float32, device=d.device),
                            indexing="ij")
    uv1 = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    rays = torch.einsum("bij,hwj->bhwi", torch.linalg.inv(camera_intrinsics.float()), uv1)
    T = camera_pose.float()
    return (torch.einsum("bij,bhwj->bhwi", T[:, :3, :3], rays * d[..., None])
            + T[:, None, None, :3, 3])


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


# ---------------------------------------------------------------------- #
# masked statistics and pointcloud normalization (training's losses)
# ---------------------------------------------------------------------- #

def masked_mean(x, mask, dim=None, eps=1e-8):
    """Mean of x where mask, 0 where the mask is empty."""
    mask = mask.to(x.dtype)
    if dim is None:
        return (x * mask).sum() / (mask.sum()).clamp(min=eps)
    return (x * mask).sum(dim) / mask.sum(dim).clamp(min=eps)


def _sorted_valid(x, mask, dim):
    """x with masked-out entries at +inf, sorted along dim, and the count
    of valid entries."""
    filled = torch.where(mask, x, torch.full_like(x, math.inf))
    return torch.sort(filled, dim=dim).values, mask.sum(dim)


def masked_median(x, mask, dim=-1):
    """Median of the valid entries along dim, the lower middle for an even
    count (torch.nanmedian's convention)."""
    sorted_x, n = _sorted_valid(x, mask, dim)
    idx = (n - 1).clamp(min=0) // 2
    return torch.take_along_dim(sorted_x, idx.unsqueeze(dim), dim).squeeze(dim)


def masked_quantile(x, mask, q, dim=-1):
    """Linearly interpolated quantile of the valid entries along dim."""
    sorted_x, n = _sorted_valid(x, mask, dim)
    pos = q * (n.to(x.dtype) - 1).clamp(min=0)
    lo, hi = pos.floor().long(), pos.ceil().long()
    frac = (pos - lo.to(x.dtype)).unsqueeze(dim)
    take = lambda i: torch.take_along_dim(sorted_x, i.unsqueeze(dim), dim)  # noqa: E731
    return (take(lo) * (1 - frac) + take(hi) * frac).squeeze(dim)


def _flatten_pts(pts, valid):
    B = pts.shape[0]
    flat = pts.reshape(B, -1, 3)
    mask = (torch.ones(flat.shape[:2], dtype=torch.bool, device=pts.device) if valid is None
            else valid.reshape(B, -1))
    return flat, mask


def normalize_pointcloud(pts1, pts2=None, norm_mode="avg_dis", valid1=None, valid2=None,
                         ret_factor=False):
    """Divide pointmaps by one scale per sample: norm_mode '<norm>_<dis>',
    norm in {avg, median, sqrt}, dis in {dis, log1p, warp-log1p} (avg only);
    warp-log1p zeroes invalid points, as the reference does."""
    norm, dis_mode = norm_mode.split("_", 1)
    flat1, m1 = _flatten_pts(pts1, valid1)
    if pts2 is not None:
        flat2, m2 = _flatten_pts(pts2, valid2)
        all_pts, all_mask = torch.cat([flat1, flat2], 1), torch.cat([m1, m2], 1)
    else:
        all_pts, all_mask = flat1, m1
    dis = all_pts.norm(dim=-1)
    if norm == "avg":
        if dis_mode == "log1p":
            dis = torch.log1p(dis)
        elif dis_mode == "warp-log1p":
            log_dis = torch.log1p(dis)
            warp = torch.where(all_mask, log_dis / dis.clamp(min=1e-8), torch.zeros_like(dis))
            n1 = flat1.shape[1]
            pts1 = pts1 * warp[:, :n1].reshape(*pts1.shape[:-1], 1)
            if pts2 is not None:
                pts2 = pts2 * warp[:, n1:].reshape(*pts2.shape[:-1], 1)
            dis = torch.where(all_mask, log_dis, torch.zeros_like(log_dis))
        elif dis_mode != "dis":
            raise ValueError(f"bad dis_mode {dis_mode}")
        norm_factor = masked_mean(dis, all_mask, dim=1)
    elif norm == "median":
        norm_factor = masked_median(dis, all_mask, dim=1).detach()
    elif norm == "sqrt":
        norm_factor = masked_mean(dis.sqrt(), all_mask, dim=1) ** 2
    else:
        raise ValueError(f"bad norm mode {norm}")
    nf = norm_factor.clamp(min=1e-8).reshape(-1, *(1,) * (pts1.dim() - 1))
    res = pts1 / nf
    if pts2 is not None:
        res = (res, pts2 / nf)
        return res + (nf,) if ret_factor else res
    return (res, nf) if ret_factor else res


def get_joint_pointcloud_depth(z1, z2, valid_mask1, valid_mask2=None, quantile=0.5):
    """Joint masked median (or quantile) of two views' depths, (B,); no
    gradient (the reference runs it under no_grad)."""
    B = z1.shape[0]
    _z, m = z1.reshape(B, -1), (valid_mask1.reshape(B, -1) if valid_mask1 is not None
                                else torch.ones_like(z1.reshape(B, -1), dtype=torch.bool))
    if z2 is not None:
        m2 = (valid_mask2.reshape(B, -1) if valid_mask2 is not None
              else torch.ones_like(z2.reshape(B, -1), dtype=torch.bool))
        _z, m = torch.cat([_z, z2.reshape(B, -1)], -1), torch.cat([m, m2], -1)
    out = masked_median(_z, m) if quantile == 0.5 else masked_quantile(_z, m, quantile)
    return out.detach()


def get_joint_pointcloud_center_scale(pts1, pts2=None, valid_mask1=None, valid_mask2=None,
                                      z_only=False, center=True):
    """Masked median centre (B, 1, 1, 3) and median distance to it
    (B, 1, 1, 1) of the joint cloud; no gradient."""
    flat1, m1 = _flatten_pts(pts1, valid_mask1)
    if pts2 is not None:
        flat2, m2 = _flatten_pts(pts2, valid_mask2)
        _pts, m = torch.cat([flat1, flat2], 1), torch.cat([m1, m2], 1)
    else:
        _pts, m = flat1, m1
    _center = masked_median(_pts.transpose(1, 2), m[:, None, :].expand(-1, 3, -1))[:, None]
    if z_only:
        _center = torch.cat([torch.zeros_like(_center[..., :2]), _center[..., 2:]], -1)
    ref = _pts - _center if center else _pts
    scale = masked_median(ref.norm(dim=-1), m, dim=1)
    return _center[:, None].detach(), scale[:, None, None, None].detach()
