"""RANSAC-PnP for visual localization.

Counterpart of `dust3r_tpu/visloc/localization.py` (reference
dust3r_visloc/localization.py:30-140), with the same modes. The JAX
package's default mode, "cv2", is `cv2.undistortPoints` followed by
`cv2.solvePnPRansac(SOLVEPNP_SQPNP)`; the port carries no cv2, so that
mode is served here in numpy (ROADMAP.md §C):

  * `undistort_points` inverts OpenCV's distortion model by the fixed-point
    iteration `cv2.undistortPoints(pts, K, dist, R=None, P=K)` runs with its
    default criteria (5 iterations), in float64, returning the input's
    float type as cv2 does;
  * `ransac_pnp` draws 4-point samples from an explicit seeded generator,
    solves Grunert's P3P on the first three (up to four poses, on coplanar
    points as well as in general position), keeps the pose that best
    reprojects the fourth, and counts inliers (squared reprojection error
    within the threshold squared, positive depth) over the points a chunk
    at a time, so memory stays bounded at 100k points; it stops as cv2's
    RANSAC does, at N = log(1 - 0.9999) / log(1 - w^4) iterations for the
    best inlier ratio w so far, at most 10,000; the best pose is refined by
    Gauss-Newton on the reprojection error of its inliers
    (`cloud_opt.init_im_poses._refine`, the aligner's PnP refinement), the
    inliers taken again after each refinement.

"poselib" and "pycolmap" call those packages, imported when the mode is
used, as the JAX package does; neither is on this repo's machines.
"""
from __future__ import annotations

import math

import numpy as np

from ..cloud_opt.init_im_poses import _project, _refine
from ..utils.geometry import opencv_to_colmap_intrinsics

PNP_SEED = 0  # the RANSAC samples come from np.random.default_rng(PNP_SEED) on each call
CONFIDENCE = 0.9999
MAX_ITERATIONS = 10_000
SAMPLE = 4  # P3P on three points; the fourth picks one of its poses
BATCH = 64  # hypotheses drawn, solved and scored together
SCORE_ELEMS = 1 << 21  # points x hypotheses scored at once: ~8 MB a fp32 array
UNDISTORT_ITERS = 5  # cv2.undistortPoints' default TermCriteria(COUNT, 5, 0.01)
REFINE_STEPS = 10  # Gauss-Newton steps of one refinement
REFINE_ROUNDS = 3  # refinements, the inliers taken again after each


def undistort_points(pts, K, distortion):
    """`cv2.undistortPoints(pts, K, distortion, R=None, P=K)` for (N, 2)
    pixels: OpenCV's radial, tangential, rational and thin-prism model (4, 5,
    8 or 12 coefficients) inverted by its fixed-point iteration, in float64;
    the result has the input's float type (float64 for other types)."""
    pts = np.asarray(pts)
    out_dtype = pts.dtype if pts.dtype in (np.float32, np.float64) else np.float64
    uv = pts.reshape(-1, 2).astype(np.float64)
    K = np.asarray(K, np.float64)
    d = np.asarray(distortion, np.float64).ravel()
    if len(d) not in (4, 5, 8, 12):
        raise ValueError(f"{len(d)} distortion coefficients: 4, 5, 8 or 12 are supported")
    k = np.zeros(12)
    k[:len(d)] = d
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    ifx, ify = 1.0 / fx, 1.0 / fy
    u, v = uv[:, 0], uv[:, 1]
    x0 = x = (u - cx) * ifx
    y0 = y = (v - cy) * ify
    active = np.ones(len(uv), bool)
    for _ in range(UNDISTORT_ITERS):
        r2 = x * x + y * y
        icdist = (1 + ((k[7] * r2 + k[6]) * r2 + k[5]) * r2) / \
            (1 + ((k[4] * r2 + k[1]) * r2 + k[0]) * r2)
        # OpenCV gives up on a point whose icdist turns negative: its
        # undistorted position is then its normalized one
        active &= ~(icdist < 0)
        dx = 2 * k[2] * x * y + k[3] * (r2 + 2 * x * x) + k[8] * r2 + k[9] * r2 * r2
        dy = k[2] * (r2 + 2 * y * y) + 2 * k[3] * x * y + k[10] * r2 + k[11] * r2 * r2
        x = np.where(active, (x0 - dx) * icdist, np.where(icdist < 0, x0, x))
        y = np.where(active, (y0 - dy) * icdist, np.where(icdist < 0, y0, y))
    out = np.stack([K[0, 0] * x + K[0, 1] * y + K[0, 2],
                    K[1, 0] * x + K[1, 1] * y + K[1, 2]], axis=-1)
    return out.astype(out_dtype).reshape(pts.shape)


def _kabsch(X, Y):
    """Rigid R, t with Y ~ R X + t, batched: X (..., n, 3), Y (..., n, 3)."""
    cx, cy = X.mean(axis=-2, keepdims=True), Y.mean(axis=-2, keepdims=True)
    H = np.swapaxes(X - cx, -1, -2) @ (Y - cy)
    U, _, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(np.swapaxes(Vt, -1, -2) @ np.swapaxes(U, -1, -2)))
    D = np.broadcast_to(np.eye(3), H.shape).copy()
    D[..., 2, 2] = np.where(d == 0, 1, d)
    R = np.swapaxes(Vt, -1, -2) @ D @ np.swapaxes(U, -1, -2)
    t = cy[..., 0, :] - np.einsum("...ij,...j->...i", R, cx[..., 0, :])
    return R, t


def p3p(f, X):
    """Grunert's three-point pose (Haralick et al. 1994), batched over S
    samples: f (S, 3, 3) unit bearings, X (S, 3, 3) the world points.
    Returns R (S, 4, 3, 3) and t (S, 4, 3), world to camera, one a root of
    the quartic (NaN where a root gives no pose)."""
    f1, f2, f3 = f[:, 0], f[:, 1], f[:, 2]
    P1, P2, P3 = X[:, 0], X[:, 1], X[:, 2]
    a2 = ((P2 - P3) ** 2).sum(-1)
    b2 = ((P1 - P3) ** 2).sum(-1)
    c2 = ((P1 - P2) ** 2).sum(-1)
    ca, cb, cg = (f2 * f3).sum(-1), (f1 * f3).sum(-1), (f1 * f2).sum(-1)
    with np.errstate(all="ignore"):
        amc, apc = (a2 - c2) / b2, (a2 + c2) / b2
        A4 = (amc - 1) ** 2 - 4 * c2 / b2 * ca ** 2
        A3 = 4 * (amc * (1 - amc) * cb - (1 - apc) * ca * cg + 2 * c2 / b2 * ca ** 2 * cb)
        A2 = 2 * (amc ** 2 - 1 + 2 * amc ** 2 * cb ** 2 + 2 * (b2 - c2) / b2 * ca ** 2
                  - 4 * apc * ca * cb * cg + 2 * (b2 - a2) / b2 * cg ** 2)
        A1 = 4 * (-amc * (1 + amc) * cb + 2 * a2 / b2 * cg ** 2 * cb - (1 - apc) * ca * cg)
        A0 = (1 + amc) ** 2 - 4 * a2 / b2 * cg ** 2
        coef = np.stack([A3, A2, A1, A0], -1) / A4[:, None]
        ok = np.isfinite(coef).all(-1)
        comp = np.zeros((len(f), 4, 4))
        comp[:, 0] = -np.where(ok[:, None], coef, 0)
        comp[:, 1, 0] = comp[:, 2, 1] = comp[:, 3, 2] = 1
        v = np.linalg.eigvals(comp).real  # (S, 4): the real parts of the roots
        for _ in range(2):  # Newton on the quartic polishes each root
            p = (((v + coef[:, :1]) * v + coef[:, 1:2]) * v + coef[:, 2:3]) * v + coef[:, 3:]
            dp = ((4 * v + 3 * coef[:, :1]) * v + 2 * coef[:, 1:2]) * v + coef[:, 2:3]
            v = np.where(dp != 0, v - p / dp, v)
        a2, b2, c2 = a2[:, None], b2[:, None], c2[:, None]
        cb, ca, cg = cb[:, None], ca[:, None], cg[:, None]
        s1 = np.sqrt(b2 / (1 + v ** 2 - 2 * v * cb))
        s3 = v * s1
        # s2 from the (P1, P2) equation, the root that best fits (P2, P3):
        # Grunert's closed form for it divides by cos(gamma) - v cos(alpha),
        # which vanishes when the three depths are nearly equal
        disc = np.sqrt(np.maximum(s1 ** 2 * (cg ** 2 - 1) + c2, 0))
        s2 = np.stack([s1 * cg + disc, s1 * cg - disc], -1)
        fit = np.abs(s2 ** 2 - 2 * s2 * (s3 * ca)[..., None] + (s3 ** 2 - a2)[..., None])
        s2 = np.take_along_axis(s2, np.nan_to_num(fit, nan=np.inf).argmin(-1)[..., None],
                                -1)[..., 0]
        s = np.stack([s1, s2, s3], -1)  # (S, 4, 3) depths along the rays
    good = ok[:, None] & np.isfinite(s).all(-1) & (s > 0).all(-1)
    Y = s[..., None] * f[:, None]  # (S, 4, 3, 3) the points in the camera
    Y = np.where(good[..., None, None], Y, 0)
    R, t = _kabsch(np.broadcast_to(X[:, None], Y.shape), Y)
    R[~good] = np.nan
    t[~good] = np.nan
    return R, t


def _bearings(xn):
    b = np.concatenate([xn, np.ones(xn.shape[:-1] + (1,))], -1)
    return b / np.linalg.norm(b, axis=-1, keepdims=True)


def _draw(rng, n, size):
    """(size, SAMPLE) indices into n points, distinct within each row."""
    idx = rng.integers(0, n, (size, SAMPLE))
    while True:
        srt = np.sort(idx, axis=1)
        dup = (srt[:, 1:] == srt[:, :-1]).any(axis=1)
        if not dup.any():
            return idx
        idx[dup] = rng.integers(0, n, (int(dup.sum()), SAMPLE))


def _update_num_iters(ep, niters):
    """cv2's RANSACUpdateNumIters for outlier ratio ep, capped at niters."""
    num = math.log(max(1 - CONFIDENCE, np.finfo(float).tiny))
    denom = 1 - (1 - ep) ** SAMPLE
    if denom < np.finfo(float).tiny:
        return 0
    denom = math.log(denom)
    return niters if denom >= 0 or -num >= niters * -denom else int(round(num / denom))


def _count_inliers(feats, R, t, K, thr2):
    """Inliers of each pose (B, 3, 3), (B, 3) over the points, a chunk of
    SCORE_ELEMS // B points at a time, in fp32: the squared error times z^2,
    (fx x + (cx - u) z)^2 + (fy y + (cy - v) z)^2, against thr^2 z^2, z > 0."""
    fu, fv, xh = feats
    P = np.concatenate([R, t[..., None]], -1)  # (B, 3, 4)
    wu = np.concatenate([K[0, 0] * P[:, 0].T, P[:, 2].T]).astype(np.float32)
    wv = np.concatenate([K[1, 1] * P[:, 1].T, P[:, 2].T]).astype(np.float32)
    wz = np.ascontiguousarray(P[:, 2].T, np.float32)
    counts = np.zeros(len(R), np.int64)
    step = max(1, SCORE_ELEMS // len(R))
    for a in range(0, len(xh), step):
        eu = fu[a:a + step] @ wu
        ev = fv[a:a + step] @ wv
        z = xh[a:a + step] @ wz
        front = z > 0
        eu *= eu
        ev *= ev
        eu += ev
        z *= z
        z *= thr2
        front &= eu <= z
        counts += np.count_nonzero(front, axis=0)
    return counts


def _inliers(K, R, t, X, px, thr2):
    uv, z = _project(K, R[None], t[None], X)
    return (((uv[0] - px) ** 2).sum(-1) <= thr2) & (z[0] > 0)


def ransac_pnp(pts3d, pts2d, K, reprojection_error):
    """World-to-camera (R, t, inlier mask) of undistorted pixels `pts2d`
    (N, 2) of world points `pts3d` (N, 3) under intrinsics K (its skew taken
    as 0, as the aligner's `_project` and `_refine` take it), or None when no
    sample has SAMPLE inliers. See the module docstring. Each call leaves
    its hypotheses drawn and its inliers in `ransac_pnp.last_stats`."""
    ransac_pnp.last_stats = {}
    X = np.asarray(pts3d, np.float64).reshape(-1, 3)
    px = np.asarray(pts2d, np.float64).reshape(-1, 2)
    K = np.asarray(K, np.float64)
    n = len(X)
    if n < SAMPLE:
        return None
    thr2 = float(reprojection_error) ** 2
    centre = X.mean(axis=0)  # the solve runs on centred points: fp32 scores keep their digits
    Xc = X - centre
    Kinv = np.linalg.inv(K)
    rays = _bearings(px @ Kinv[:2, :2].T + Kinv[:2, 2])
    xh = np.concatenate([Xc, np.ones((n, 1))], -1)
    feats = (np.concatenate([xh, (K[0, 2] - px[:, :1]) * xh], -1).astype(np.float32),
             np.concatenate([xh, (K[1, 2] - px[:, 1:]) * xh], -1).astype(np.float32),
             xh.astype(np.float32))
    rng = np.random.default_rng(PNP_SEED)
    best, best_count, niters, done = None, SAMPLE - 1, MAX_ITERATIONS, 0
    while done < niters:
        idx = _draw(rng, n, BATCH)
        R, t = p3p(rays[idx[:, :3]], Xc[idx[:, :3]])
        cam = np.einsum("skij,sj->ski", R, Xc[idx[:, 3]]) + t  # the fourth point
        with np.errstate(divide="ignore", invalid="ignore"):
            err = ((cam[..., :2] / cam[..., 2:] - (px[idx[:, 3]] @ Kinv[:2, :2].T
                                                   + Kinv[:2, 2])[:, None]) ** 2).sum(-1)
        err = np.where(np.isfinite(err) & (cam[..., 2] > 0), err, np.inf)
        pick = err.argmin(axis=1)
        R, t = R[np.arange(BATCH), pick], t[np.arange(BATCH), pick]
        solved = np.isfinite(err.min(axis=1))
        counts = np.zeros(BATCH, np.int64)
        if solved.any():
            counts[solved] = _count_inliers(feats, R[solved], t[solved], K, thr2)
        for k in range(BATCH):  # in draw order, as a sequential RANSAC takes them
            if done >= niters:
                break
            done += 1
            if counts[k] > best_count:
                best, best_count = (R[k], t[k]), int(counts[k])
                niters = _update_num_iters((n - best_count) / n, niters)
    ransac_pnp.last_stats = dict(iterations=done, inliers=0)
    if best is None:
        return None
    R, t = best
    keep = _inliers(K, R, t, Xc, px, thr2)
    for _ in range(REFINE_ROUNDS):
        R1, t1 = _refine(K, R, t, Xc[keep], px[keep], steps=REFINE_STEPS)
        if not (np.isfinite(R1).all() and np.isfinite(t1).all()):
            break
        keep1 = _inliers(K, R1, t1, Xc, px, thr2)
        if keep1.sum() < keep.sum():
            break
        R, t, same, keep = R1, t1, np.array_equal(keep1, keep), keep1
        if same:
            break
    ransac_pnp.last_stats["inliers"] = int(keep.sum())
    return R, t - R @ centre, keep


ransac_pnp.last_stats = {}


def run_pnp(pts2D, pts3D, K, distortion=None, mode="cv2", reprojectionError=5, img_size=None):
    """Estimate the query camera pose from 2D <-> 3D matches.

    Returns (success, cam2world 4x4 or None). As in the JAX package, any
    exception inside the solve is printed and gives (False, None)."""
    if mode not in ("cv2", "poselib", "pycolmap"):
        raise ValueError(f"pnp mode {mode!r} not in ('cv2', 'poselib', 'pycolmap')")
    try:
        if len(pts2D) <= 4:
            return False, None
        confidence = CONFIDENCE
        iterationsCount = MAX_ITERATIONS

        if mode == "cv2":
            if distortion is not None:
                pts2D = undistort_points(np.copy(pts2D), K, np.array(distortion)).reshape(-1, 2)
            res = ransac_pnp(pts3D, pts2D, K, reprojectionError)
            if res is None:
                return False, None
            R, t, _ = res  # world2cam
            RT = np.r_[np.c_[R, t], [(0, 0, 0, 1)]]
            return True, np.linalg.inv(RT)

        colmap_K = opencv_to_colmap_intrinsics(K)
        fx, fy = colmap_K[0, 0], colmap_K[1, 1]
        cx, cy = colmap_K[0, 2], colmap_K[1, 2]
        width = img_size[0] if img_size is not None else int(cx * 2)
        height = img_size[1] if img_size is not None else int(cy * 2)
        pts2D = np.copy(pts2D)
        pts2D[:, 0] += 0.5
        pts2D[:, 1] += 0.5
        if distortion is None:
            model, params = "PINHOLE", [fx, fy, cx, cy]
        else:
            model, params = "OPENCV", [fx, fy, cx, cy] + list(distortion)

        if mode == "poselib":
            try:
                import poselib
            except ImportError as e:
                raise RuntimeError("poselib not installed") from e
            camera = {"model": model, "width": width, "height": height, "params": params}
            pose, _ = poselib.estimate_absolute_pose(
                pts2D, pts3D, camera,
                {"max_reproj_error": reprojectionError, "max_iterations": iterationsCount,
                 "success_prob": confidence}, {})
            if pose is None:
                return False, None
            RT = np.r_[pose.Rt, [(0, 0, 0, 1)]]
            return True, np.linalg.inv(RT)

        try:
            import pycolmap
            from packaging import version

            new_enough = version.parse(pycolmap.__version__) >= version.parse("0.5.0")
        except ImportError:
            new_enough = False
        if not new_enough:
            raise RuntimeError("pycolmap >= 0.5.0 not installed")
        if img_size is None:
            raise ValueError("pycolmap needs img_size")
        cam = pycolmap.Camera(model=model, width=width, height=height, params=params)
        est_opts = dict(ransac=dict(max_error=reprojectionError, min_inlier_ratio=0.01,
                                    min_num_trials=1000, max_num_trials=100000,
                                    confidence=confidence))
        ref_opts = dict(refine_focal_length=False, refine_extra_params=False)
        ret = pycolmap.absolute_pose_estimation(pts2D, pts3D, cam, estimation_options=est_opts,
                                                refinement_options=ref_opts)
        if ret is None or ret.get("num_inliers", 0) <= 0:
            return False, None
        mat = ret["cam_from_world"].matrix
        mat = mat() if callable(mat) else mat
        w2c = np.r_[mat, [(0, 0, 0, 1)]]
        return True, np.linalg.inv(w2c)
    except Exception as e:  # the reference's behaviour: any exception is a failure
        print(f"error during pnp: {e}")
        return False, None
