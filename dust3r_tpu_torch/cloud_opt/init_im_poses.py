"""Initialization of the global aligner: MST propagation + RANSAC-PnP.

Counterpart of `dust3r_tpu/cloud_opt/init_im_poses.py`. Host side, as in
the JAX package and the reference: the scene's host copies of the
predictions go through float64 registrations and a numpy PnP, and the
results are written into the scene's parameters once.

`fast_pnp` is the one place the port does not follow the JAX code: that
calls `cv2.solvePnPRansac` (SQPnP), and the port carries no cv2. Its solver
here is plain numpy with cv2's contract (RANSAC over `niter_PnP` samples
per tentative focal, 5 px inliers, the focal with the most inliers, a refit
on them); tests/test_torch_port_cloud_opt.py holds it against cv2.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import scipy.sparse as sp
import torch

from ..post_process import estimate_focal_knowing_depth
from ..utils.geometry import geotrf, inv
from ..utils.pose import align_multiple_poses, rigid_points_registration, sRT_to_4x4
from .commons import edge_str

PNP_SEED = 0  # RANSAC samples come from np.random.default_rng(PNP_SEED) on each call
PNP_REPROJ_PX = 5.0  # inlier threshold, cv2's reprojectionError=5
PNP_SAMPLE = 6  # points per RANSAC sample: the linear (DLT) solver's minimum
PNP_REFINE_STEPS = 5  # Gauss-Newton steps on the reprojection error of the inliers


def estimate_focal(pts3d_i, pp=None):
    """Weiszfeld focal of one (H, W, 3) host pointmap, in fp32 on the CPU."""
    H, W, _ = pts3d_i.shape
    if pp is None:
        pp = np.array([W / 2, H / 2], np.float32)
    focal = estimate_focal_knowing_depth(
        torch.as_tensor(np.asarray(pts3d_i, np.float32))[None],
        torch.as_tensor(np.asarray(pp, np.float32))[None], focal_mode="weiszfeld")
    return float(focal[0])


@lru_cache(maxsize=None)
def pixel_grid(H, W):
    return np.mgrid[:W, :H].T.astype(np.float32)


def _pnp_linear(X, xn):
    """Least-squares [R | t] from world points X (S, n, 3) and normalized
    image points xn (S, n, 2), n >= 6, batched over S: the 12-vector of P
    nearest the null space of the DLT system (on Hartley-normalized X),
    its left 3x3 projected onto SO(3). Returns R (S, 3, 3), t (S, 3)."""
    c = X.mean(axis=-2, keepdims=True)
    s = np.sqrt(3) / np.maximum(np.linalg.norm(X - c, axis=-1).mean(axis=-1), 1e-12)
    Xh = np.concatenate([(X - c) * s[:, None, None], np.ones(X.shape[:-1] + (1,))], axis=-1)
    zero = np.zeros_like(Xh)
    rows_u = np.concatenate([-Xh, zero, xn[..., :1] * Xh], axis=-1)  # (S, n, 12)
    rows_v = np.concatenate([zero, -Xh, xn[..., 1:] * Xh], axis=-1)
    A = np.concatenate([rows_u, rows_v], axis=-2)
    _, vecs = np.linalg.eigh(np.einsum("sni,snj->sij", A, A))
    P = vecs[..., 0].reshape(-1, 3, 4)  # eigenvalues ascend: the least one
    # undo the normalization: P [s (X - c); 1] = P T [X; 1]
    T = np.zeros((len(P), 4, 4))
    T[:, :3, :3] = s[:, None, None] * np.eye(3)
    T[:, :3, 3] = -s[:, None] * c[:, 0]
    T[:, 3, 3] = 1
    P = P @ T
    # P = lambda [R | t]: det(lambda R) = lambda^3 fixes the sign of lambda
    P = P * np.sign(np.linalg.det(P[:, :, :3]))[:, None, None]
    U, S, Vt = np.linalg.svd(P[:, :, :3])
    R = U @ Vt
    return R, P[:, :, 3] / S.mean(axis=-1)[:, None]


def _project(K, R, t, X):
    """Pixels (S, n, 2) and depths (S, n) of X (n, 3) under poses (S, ...)."""
    cam = np.einsum("sij,nj->sni", R, X) + t[:, None, :]
    z = cam[..., 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        uv = cam[..., :2] / z[..., None] * K[[0, 1], [0, 1]] + K[:2, 2]
    return uv, z


def _skew(v):
    o = np.zeros(v.shape[:-1])
    return np.stack([np.stack([o, -v[..., 2], v[..., 1]], -1),
                     np.stack([v[..., 2], o, -v[..., 0]], -1),
                     np.stack([-v[..., 1], v[..., 0], o], -1)], -2)


def _rodrigues(w):
    theta = np.linalg.norm(w)
    if theta < 1e-15:
        return np.eye(3) + _skew(w)
    k = _skew(w / theta)
    return np.eye(3) + np.sin(theta) * k + (1 - np.cos(theta)) * k @ k


def _refine(K, R, t, X, px, steps=PNP_REFINE_STEPS):
    """Gauss-Newton on the pixel reprojection error of X (n, 3) against px
    (n, 2), rotation updated on the left by a Rodrigues step."""
    f = K[[0, 1], [0, 1]]
    for _ in range(steps):
        cam = X @ R.T + t
        x, y, z = cam[:, 0], cam[:, 1], cam[:, 2]
        r = np.stack([f[0] * x / z + K[0, 2], f[1] * y / z + K[1, 2]], -1) - px
        dpi = np.zeros((len(X), 2, 3))
        dpi[:, 0, 0] = f[0] / z
        dpi[:, 0, 2] = -f[0] * x / z ** 2
        dpi[:, 1, 1] = f[1] / z
        dpi[:, 1, 2] = -f[1] * y / z ** 2
        # d cam / d(w, dt) = [-[R X]x | I]
        J = np.concatenate([dpi @ -_skew(cam - t), dpi], axis=-1).reshape(-1, 6)
        try:
            delta = np.linalg.solve(J.T @ J, -J.T @ r.reshape(-1))
        except np.linalg.LinAlgError:
            break
        R = _rodrigues(delta[:3]) @ R
        t = t + delta[3:]
    return R, t


def _inliers(K, R, t, X, px):
    uv, z = _project(K, R, t, X)
    return (((uv - px) ** 2).sum(-1) <= PNP_REPROJ_PX ** 2) & (z > 0)


def _pnp_ransac(X, px, K, niter, rng):
    """(inlier count, R, t): the best of `niter` 6-point samples, refit on
    its inliers, with the refit's inliers where it has more; (0, None,
    None) when no sample has an inlier."""
    Kinv = np.linalg.inv(K)
    xn = px @ Kinv[:2, :2].T + Kinv[:2, 2]
    idx = np.stack([rng.choice(len(X), PNP_SAMPLE, replace=False) for _ in range(niter)])
    R, t = _pnp_linear(X[idx], xn[idx])
    counts = _inliers(K, R, t, X, px).sum(-1)
    best = int(np.argmax(counts))
    n_inl, R, t = int(counts[best]), R[best], t[best]
    if n_inl < PNP_SAMPLE:
        return (n_inl, R, t) if n_inl else (0, None, None)
    keep = _inliers(K, R[None], t[None], X, px)[0]
    R1, t1 = _pnp_linear(X[keep][None], xn[keep][None])
    R1, t1 = _refine(K, R1[0], t1[0], X[keep], px[keep])
    if not (np.isfinite(R1).all() and np.isfinite(t1).all()):
        return n_inl, R, t
    return max(n_inl, int(_inliers(K, R1[None], t1[None], X, px).sum())), R1, t1


def fast_pnp(pts3d, focal, msk, pp=None, niter_PnP=10):
    """RANSAC-PnP for one image; tries 21 geomspace focals if `focal` is
    None. Returns (focal, cam2world 4x4) or None."""
    msk = np.asarray(msk)
    if msk.sum() < PNP_SAMPLE:
        return None
    pts3d = np.asarray(pts3d, np.float32)
    H, W, _ = pts3d.shape
    pixels = pixel_grid(H, W)
    if focal is None:
        S = max(W, H)
        tentative_focals = np.geomspace(S / 2, S * 3, 21)
    else:
        tentative_focals = [focal]
    pp = (W / 2, H / 2) if pp is None else np.asarray(pp)
    X = pts3d[msk].astype(np.float64)
    px = pixels[msk].astype(np.float64)
    rng = np.random.default_rng(PNP_SEED)
    best = (0, None, None, None)
    for f in tentative_focals:
        K = np.array([(f, 0, pp[0]), (0, f, pp[1]), (0, 0, 1)], np.float64)
        n_inl, R, T = _pnp_ransac(X, px, K, niter_PnP, rng)
        if n_inl > best[0]:
            best = (n_inl, R, T, f)
    if not best[0]:
        return None
    _, R, T, best_focal = best
    world2cam = sRT_to_4x4(1, R, T)
    return best_focal, inv(world2cam)


def _registration(pts_src, pts_tgt, conf):
    s, R, T = rigid_points_registration(np.asarray(pts_src).reshape(-1, 3),
                                        np.asarray(pts_tgt).reshape(-1, 3),
                                        weights=np.asarray(conf).reshape(-1))
    return float(s), R, T


def minimum_spanning_tree(imshapes, edges, pred_i, pred_j, conf_i, conf_j, im_conf,
                          min_conf_thr, has_im_poses=True, niter_PnP=10, verbose=True,
                          edge_scores=None):
    """Build a consistent initial scene by walking the confidence MST.

    Returns (pts3d per image, msp_edges, im_focals, im_poses)."""
    n_imgs = len(imshapes)
    if edge_scores is None:
        edge_scores = {(i, j): float(np.mean(conf_i[edge_str(i, j)])
                                     * np.mean(conf_j[edge_str(i, j)]))
                       for i, j in edges}
    graph = sp.dok_array((n_imgs, n_imgs))
    for (i, j), score in edge_scores.items():
        graph[i, j] = -score
    msp = sp.csgraph.minimum_spanning_tree(graph).tocoo()

    todo = sorted(zip(-msp.data, msp.row, msp.col))  # best last
    pts3d = [None] * n_imgs
    im_poses = [None] * n_imgs
    im_focals = [None] * n_imgs

    score, i, j = todo.pop()
    if verbose:
        print(f" init edge ({i}*,{j}*) score={score}")
    s_ij = edge_str(i, j)
    pts3d[i] = np.array(pred_i[s_ij])
    pts3d[j] = np.array(pred_j[s_ij])
    done = {i, j}
    if has_im_poses:
        im_poses[i] = np.eye(4, dtype=np.float32)
        im_focals[i] = estimate_focal(pred_i[s_ij])

    msp_edges = [(i, j)]
    while todo:
        score, i, j = todo.pop()
        s_ij = edge_str(i, j)
        if im_focals[i] is None:
            im_focals[i] = estimate_focal(pred_i[s_ij])
        if i in done:
            if verbose:
                print(f" init edge ({i},{j}*) score={score}")
            assert j not in done
            s, R, T = _registration(pred_i[s_ij], pts3d[i], conf_i[s_ij])
            pts3d[j] = geotrf(sRT_to_4x4(s, R, T), pred_j[s_ij])
            done.add(j)
            msp_edges.append((i, j))
            if has_im_poses and im_poses[i] is None:
                im_poses[i] = sRT_to_4x4(1, R, T)
        elif j in done:
            if verbose:
                print(f" init edge ({i}*,{j}) score={score}")
            assert i not in done
            s, R, T = _registration(pred_j[s_ij], pts3d[j], conf_j[s_ij])
            pts3d[i] = geotrf(sRT_to_4x4(s, R, T), pred_i[s_ij])
            done.add(i)
            msp_edges.append((i, j))
            if has_im_poses and im_poses[i] is None:
                im_poses[i] = sRT_to_4x4(1, R, T)
        else:
            todo.insert(0, (score, i, j))  # retry later

    if has_im_poses:
        # the remaining focals from the best edges, the remaining poses by PnP
        pair_scores = np.array([-s for s in edge_scores.values()])
        edge_arr = np.array(list(edge_scores.keys()))
        for i, j in edge_arr[np.argsort(pair_scores)].tolist():
            if im_focals[i] is None:
                im_focals[i] = estimate_focal(pred_i[edge_str(i, j)])
        for i in range(n_imgs):
            if im_poses[i] is None:
                msk = im_conf[i] > min_conf_thr
                res = fast_pnp(pts3d[i], im_focals[i], msk=msk, niter_PnP=niter_PnP)
                if res:
                    im_focals[i], im_poses[i] = res
            if im_poses[i] is None:
                im_poses[i] = np.eye(4, dtype=np.float32)
        im_poses = np.stack(im_poses)
    else:
        im_poses = im_focals = None
    return pts3d, msp_edges, im_focals, im_poses


def init_minimum_spanning_tree(scene, niter_PnP=10):
    pts3d, _, im_focals, im_poses = minimum_spanning_tree(
        scene.imshapes, scene.edges, scene.pred_i, scene.pred_j, scene.conf_i,
        scene.conf_j, scene.im_conf, scene.min_conf_thr,
        has_im_poses=scene.has_im_poses, niter_PnP=niter_PnP, verbose=scene.verbose,
        edge_scores=scene.edge_scores())
    return init_from_pts3d(scene, pts3d, im_focals, im_poses)


def init_from_pts3d(scene, pts3d, im_focals, im_poses):
    """Write per-image pointclouds, poses and focals into the scene."""
    nkp, known_poses_msk, known_poses = get_known_poses(scene)
    if nkp == 1:
        raise NotImplementedError("Would be simpler to just align everything afterwards "
                                  "on the single known pose")
    if nkp > 1:
        s, R, T = align_multiple_poses(im_poses[known_poses_msk],
                                       known_poses[known_poses_msk])
        trf = sRT_to_4x4(float(s), R, T)
        im_poses = trf @ im_poses
        im_poses[:, :3, :3] /= float(s)
        pts3d = [geotrf(trf, p) for p in pts3d]

    # pairwise poses from conf-weighted registration
    for e, (i, j) in enumerate(scene.edges):
        s_ij = edge_str(i, j)
        s, R, T = _registration(scene.pred_i[s_ij], pts3d[i], scene.conf_i[s_ij])
        scene._set_pose("pw_poses", e, R, T, scale=s)

    s_factor = float(scene.get_pw_norm_scale_factor())
    im_poses[:, :3, 3] *= s_factor
    pts3d = [p * s_factor for p in pts3d]

    if scene.has_im_poses:
        for i in range(scene.n_imgs):
            cam2world = im_poses[i]
            depth = geotrf(inv(cam2world), pts3d[i])[..., 2]
            scene._set_depthmap(i, depth)
            scene._set_pose("im_poses", i, cam2world)
            if im_focals[i] is not None:
                scene._set_focal(i, im_focals[i])

    if scene.verbose:
        print(" init loss =", scene.forward())


def get_known_poses(scene):
    if scene.has_im_poses:
        known_msk = ~scene.masks["im_poses"].any(axis=1)
        known_poses = scene.get_im_poses().cpu().numpy()
        return int(known_msk.sum()), known_msk, known_poses
    return 0, None, None


def get_known_focals(scene):
    if scene.has_im_poses:
        known_msk = scene.get_known_focal_mask()
        # one focal per image: fx_and_fy scenes store (N, 2), averaged as
        # the reference does
        focals = scene.get_focals().cpu().numpy().reshape(scene.n_imgs, -1).mean(axis=1)
        return int(known_msk.sum()), known_msk, focals
    return 0, None, None


def init_from_known_poses(scene, niter_PnP=10, min_conf_thr=3):
    """Pairwise poses and depths when every camera pose is preset."""
    nkp, known_msk, known_poses = get_known_poses(scene)
    assert nkp == scene.n_imgs, "not all poses are known"
    nkf, _, im_focals = get_known_focals(scene)
    assert nkf == scene.n_imgs
    im_pp = scene.get_principal_points().cpu().numpy()

    best_depthmaps = {}
    for e, (i, j) in enumerate(scene.edges):
        s_ij = edge_str(i, j)
        P1 = np.eye(4, dtype=np.float32)
        ci = np.asarray(scene.conf_i[s_ij])
        msk = ci > min(min_conf_thr, ci.min() - 0.1)
        res = fast_pnp(scene.pred_j[s_ij], float(im_focals[i]), pp=im_pp[i], msk=msk,
                       niter_PnP=niter_PnP)
        assert res is not None, f"PnP failed for edge {s_ij}"
        _, P2 = res
        s, R, T = align_multiple_poses(np.stack([P1, np.asarray(P2, np.float32)]),
                                       known_poses[[i, j]])
        scene._set_pose("pw_poses", e, R, T, scale=float(s), force=True)
        score = float(ci.mean())
        if score > best_depthmaps.get(i, (0,))[0]:
            best_depthmaps[i] = score, s_ij, float(s)

    for n in range(scene.n_imgs):
        assert known_msk[n]
        _, s_ij, scale = best_depthmaps[n]
        depth = np.asarray(scene.pred_i[s_ij])[:, :, 2]
        scene._set_depthmap(n, depth * scale, force=True)
