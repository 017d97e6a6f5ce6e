"""Pose parametrizations: quaternions, sim(3) helpers, signed log/exp maps.

Counterpart of `dust3r_tpu/utils/pose.py` (which replaces the reference's
`roma`). Quaternions are XYZW, the rotation acting as R(q) @ v. The torch
functions serve the aligner's loss; the init-time writes (`matrix_to_pose_vec`,
`rigid_points_registration`, `align_multiple_poses`) are host numpy in
float64, as in the JAX package, whose fp32 versions measurably degraded the
post-init consistency.
"""
from __future__ import annotations

import numpy as np
import torch


def signed_log1p(x):
    """sign(x) log(1 + |x|), for torch tensors and numpy arrays."""
    if isinstance(x, np.ndarray):
        return np.sign(x) * np.log1p(np.abs(x))
    return torch.sign(x) * torch.log1p(torch.abs(x))


def signed_expm1(x):
    return torch.sign(x) * torch.expm1(torch.abs(x))


def quat_normalize(q, eps=1e-12):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=eps)


def quat_to_rotmat(q):
    """Unit quaternion (..., 4) [x, y, z, w] -> rotation matrix (..., 3, 3)."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(*q.shape[:-1], 3, 3)


def rotmat_to_quat(R):
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) [x, y, z, w],
    host float64: branch-free Shepperd-style extraction, the four candidate
    quaternions keyed by which diagonal term dominates, and the best one."""
    R = np.asarray(R, np.float64)
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    # candidates as (x, y, z, w)
    cands = np.stack([
        np.stack([m21 - m12, m02 - m20, m10 - m01, 1 + tr], axis=-1),
        np.stack([1 + m00 - m11 - m22, m01 + m10, m02 + m20, m21 - m12], axis=-1),
        np.stack([m01 + m10, 1 - m00 + m11 - m22, m12 + m21, m02 - m20], axis=-1),
        np.stack([m02 + m20, m12 + m21, 1 - m00 - m11 + m22, m10 - m01], axis=-1),
    ], axis=-2)
    scores = np.stack([1 + tr, 1 + m00 - m11 - m22, 1 - m00 + m11 - m22,
                       1 - m00 - m11 + m22], axis=-1)
    best = np.argmax(scores, axis=-1)
    q = np.take_along_axis(cands, np.repeat(best[..., None, None], 4, axis=-1),
                           axis=-2).squeeze(-2)
    return q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)


def pose_vec_to_matrix(vec):
    """(..., >=7) [qx qy qz qw tx ty tz (log s)] -> (..., 4, 4) cam2world,
    the translation stored through signed_log1p."""
    R = quat_to_rotmat(quat_normalize(vec[..., :4]))
    T = signed_expm1(vec[..., 4:7])
    top = torch.cat([R, T[..., None]], dim=-1)
    # made on the device: a tensor from a host list would wait for it
    bottom = torch.zeros(*vec.shape[:-1], 1, 4, dtype=vec.dtype, device=vec.device)
    bottom[..., 3] = 1
    return torch.cat([top, bottom], dim=-2)


def matrix_to_pose_vec(M, scale=None):
    """Inverse of pose_vec_to_matrix for init writes (host, float64): the
    translation is divided by `scale` first and log(scale) appended when
    given."""
    M = np.asarray(M, np.float64)
    q = rotmat_to_quat(M[..., :3, :3])
    T = M[..., :3, 3]
    if scale is not None:
        T = T / scale
    vec = np.concatenate([q, signed_log1p(T)], axis=-1)
    if scale is not None:
        logs = np.log(np.broadcast_to(np.asarray(scale, np.float64), M.shape[:-2] + (1,)))
        vec = np.concatenate([vec, logs], axis=-1)
    return vec


def sRT_to_4x4(scale, R, T, dtype=np.float32):
    """[[s R, T], [0, 1]] (host numpy)."""
    trf = np.eye(4, dtype=dtype)
    trf[:3, :3] = np.asarray(R, dtype) * scale
    trf[:3, 3] = np.asarray(T, dtype).reshape(3)
    return trf


def rigid_points_registration(pts1, pts2, weights=None, compute_scaling=True):
    """Weighted Umeyama: (s, R, T) minimizing ||s R pts1 + T - pts2||^2, in
    float64 numpy. pts: (N, 3); weights: (N,) nonnegative."""
    pts1 = np.asarray(pts1, np.float64).reshape(-1, 3)
    pts2 = np.asarray(pts2, np.float64).reshape(-1, 3)
    w = (np.ones(pts1.shape[0], np.float64) if weights is None
         else np.asarray(weights, np.float64).reshape(-1))
    wn = (w / max(float(np.sum(w)), 1e-12))[:, None]
    mu1 = np.sum(wn * pts1, axis=0)
    mu2 = np.sum(wn * pts2, axis=0)
    c1 = pts1 - mu1
    c2 = pts2 - mu2
    cov = (wn * c1).T @ c2
    U, S, Vt = np.linalg.svd(cov.T)  # cov.T maps pts1-space to pts2-space
    D = np.array([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))], np.float64)
    R = (U * D) @ Vt
    if compute_scaling:
        var1 = np.sum(wn * np.sum(c1 * c1, axis=-1, keepdims=True))
        s = np.sum(S * D) / max(float(var1), 1e-12)
    else:
        s = np.float64(1.0)
    return s, R, mu2 - s * (R @ mu1)


def align_multiple_poses(src_poses, target_poses):
    """sim(3) aligning one set of cam2world poses onto another: register the
    camera centres plus a point a little along each optical axis."""
    from .geometry import get_med_dist_between_poses

    def center_and_z(poses):
        eps = get_med_dist_between_poses(poses) / 100
        return np.concatenate([poses[:, :3, 3], poses[:, :3, 3] + eps * poses[:, :3, 2]])

    return rigid_points_registration(center_and_z(np.asarray(src_poses, np.float64)),
                                     center_and_z(np.asarray(target_poses, np.float64)))
