"""The port's losses, their DSL, the training geometry and the prediction
decoding against the JAX package, on the CPU.

The same seeded numpy gt and predictions go through both packages: each
criterion's loss and details within 1e-6 relative, its gradients with
respect to the predictions within 1e-5 of their largest; the geometry
functions and `get_pred_pts3d` / `find_opt_scaling` within 1e-6. The inputs
hold an empty mask (one view of one sample), `dist_clip` and
`reduction='none'`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dust3r_tpu.inference as jinf
import dust3r_tpu.losses as jlosses
from dust3r_tpu.training import build_criterion as jax_build_criterion
from dust3r_tpu.utils import geometry as jgeo
import dust3r_tpu_torch.inference as tinf
from dust3r_tpu_torch import losses
from dust3r_tpu_torch.utils import geometry as geo

B, H, W = 3, 6, 5


def _pose(rng):
    a = rng.standard_normal(3) * 0.3
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    R = np.eye(3) + np.sin(1) * K + (1 - np.cos(1)) * K @ K / max(np.linalg.norm(a), 1e-9) ** 2 \
        * np.linalg.norm(a) ** 2
    u, _, vt = np.linalg.svd(R)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3], T[:3, 3] = u @ vt, rng.standard_normal(3)
    return T


def make_case(seed):
    rng = np.random.default_rng(seed)
    gts, preds = [], []
    for side in range(2):
        valid = rng.uniform(size=(B, H, W)) > 0.3
        if side == 1:
            valid[2] = False  # an empty mask
        gts.append(dict(camera_pose=np.stack([_pose(rng) for _ in range(B)]),
                        pts3d=(rng.standard_normal((B, H, W, 3)) + [0, 0, 4]).astype(np.float32),
                        valid_mask=valid,
                        camera_intrinsics=np.tile(np.float32([[5, 0, 2.5], [0, 5, 3], [0, 0, 1]]),
                                                  (B, 1, 1))))
        key = "pts3d" if side == 0 else "pts3d_in_other_view"
        preds.append({key: (rng.standard_normal((B, H, W, 3)) + [0, 0, 3]).astype(np.float32),
                      "conf": (1 + rng.exponential(size=(B, H, W))).astype(np.float32)})
    return gts, preds


def _jax(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _torch(d, grad=False):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).requires_grad_(
        grad and np.issubdtype(v.dtype, np.floating)) for k, v in d.items()}


CRITERIA = [
    "ConfLoss(Regr3D(L21, norm_mode='avg_dis'), alpha=0.2)",
    "Regr3D(L21, norm_mode='avg_dis')",
    "Regr3D(L21, norm_mode='median_dis')",
    "Regr3D(L21, norm_mode='sqrt_dis')",
    "Regr3D(L21, norm_mode='avg_log1p')",
    "ConfLoss(Regr3D(L21, norm_mode='avg_warp-log1p'), alpha=0.5)",
    "Regr3D(L21, norm_mode='avg_dis', gt_scale=True)",
    "Regr3D_ShiftInv(L21)",
    "Regr3D_ScaleInv(L21)",
    "Regr3D_ScaleShiftInv(L21, gt_scale=True)",
    "ConfLoss(Regr3D(L21, norm_mode='avg_dis'), alpha=0.2) + 0.1 * Regr3D_ScaleShiftInv(L21, "
    "gt_scale=True)",
    "2 * Regr3D(L21) + Regr3D_ScaleInv(L21) * 0.5",
]


def _run_both(crit_str, seed, **kw):
    gts, preds = make_case(seed)
    jcrit, tcrit = jax_build_criterion(crit_str), losses.build_criterion(crit_str)
    assert repr(tcrit) == repr(jcrit)

    def jloss(p1, p2):
        return jcrit(_jax(gts[0]), _jax(gts[1]), p1, p2, **kw)

    (jl, jdet), jgrads = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        _jax(preds[0]), _jax(preds[1]))
    tp1, tp2 = _torch(preds[0], True), _torch(preds[1], True)
    tl, tdet = tcrit(_torch(gts[0]), _torch(gts[1]), tp1, tp2, **kw)
    keys = [(0, k) for k in tp1] + [(1, k) for k in tp2]
    leaves = [tp1[k] if side == 0 else tp2[k] for side, k in keys]
    tgrads = torch.autograd.grad(tl, leaves, allow_unused=True)
    tgrads = [torch.zeros_like(x) if g is None else g for g, x in zip(tgrads, leaves)]
    jgrads = [jgrads[side][k] for side, k in keys]
    return (jl, jdet, jgrads), (tl.detach(), tdet, tgrads)


@pytest.mark.parametrize("crit_str", CRITERIA)
def test_criterion_matches_jax(crit_str):
    (jl, jdet, jgrads), (tl, tdet, tgrads) = _run_both(crit_str, 3)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert set(tdet) == set(jdet)
    for k in jdet:
        np.testing.assert_allclose(float(tdet[k].detach()), float(jdet[k]), rtol=1e-6)
    for got, w in zip(tgrads, jgrads):
        w = np.asarray(w)
        assert np.abs(got.numpy() - w).max() <= 1e-5 * max(np.abs(w).max(), 1e-12)


def test_dist_clip_matches_jax():
    crit = "ConfLoss(Regr3D(L21, norm_mode='avg_dis'), alpha=0.2)"
    (jl, jdet, _), (tl, tdet, _) = _run_both(crit, 4, dist_clip=4.5)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    (jl0, _, _), _ = _run_both(crit, 4)
    assert float(jl) != float(jl0)  # the clip removed points


def test_reduction_none_matches_jax():
    gts, preds = make_case(6)
    jcrit = jlosses.Regr3D(jlosses.L21).with_reduction("none")
    tcrit = losses.Regr3D(losses.L21).with_reduction("none")
    (jout, jdet) = jcrit(_jax(gts[0]), _jax(gts[1]), _jax(preds[0]), _jax(preds[1]))
    (tout, tdet) = tcrit(_torch(gts[0]), _torch(gts[1]), _torch(preds[0]), _torch(preds[1]))
    for (tl, tm), (jl, jm) in zip(tout, jout):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6, atol=1e-6)
        assert np.array_equal(tm.numpy(), np.asarray(jm))
    for k in jdet:
        np.testing.assert_allclose(float(tdet[k]), float(jdet[k]), rtol=1e-6)
    with pytest.raises(ValueError, match="weighted"):
        (2 * tcrit)(_torch(gts[0]), _torch(gts[1]), _torch(preds[0]), _torch(preds[1]))


def test_l21_sum_and_mean_match_jax():
    rng = np.random.default_rng(7)
    a, b = (rng.standard_normal((2, 4, 5, 3)).astype(np.float32) for _ in range(2))
    m = rng.uniform(size=(2, 4, 5)) > 0.5
    for red in ("mean", "sum"):
        got = losses.L21Loss(red)(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(m))
        want = jlosses.L21Loss(red)(jnp.asarray(a), jnp.asarray(b), jnp.asarray(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _close(got, want, tol=1e-6):
    """Within tol of max(1, max |want|); a non-finite entry (the median of
    an empty mask is +inf in both) equal."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    fin = np.isfinite(want)
    assert np.array_equal(got[~fin], want[~fin], equal_nan=True)
    assert np.abs(got[fin] - want[fin]).max(initial=0) <= tol * max(np.abs(want[fin]).max(
        initial=0), 1.0)


def test_geometry_matches_jax():
    rng = np.random.default_rng(11)
    poses = np.stack([_pose(rng) for _ in range(B)])
    _close(geo.closed_form_pose_inverse(torch.from_numpy(poses)),
           jgeo.closed_form_pose_inverse(jnp.asarray(poses)))
    depth = rng.uniform(1, 3, (B, H, W)).astype(np.float32)
    K = np.tile(np.float32([[5, 0, 2.5], [0, 6, 3], [0, 0, 1]]), (B, 1, 1))
    K[1] = K[1][[1, 0, 2]]  # a transposed portrait view's row-permuted K
    _close(geo.depth_to_world_pts3d(*map(torch.from_numpy, (depth, K, poses))),
           jgeo.depth_to_world_pts3d(*map(jnp.asarray, (depth, K, poses))))
    x = rng.standard_normal((B, 40)).astype(np.float32)
    m = rng.uniform(size=(B, 40)) > 0.4
    m[1] = False
    m[2, :3] = True
    m[2, 3:] = False
    tx, tm = torch.from_numpy(x), torch.from_numpy(m)
    _close(geo.masked_mean(tx, tm, dim=1), jgeo.masked_mean(jnp.asarray(x), jnp.asarray(m), 1))
    _close(geo.masked_mean(tx, tm), jgeo.masked_mean(jnp.asarray(x), jnp.asarray(m)))
    _close(geo.masked_median(tx, tm), jgeo.masked_median(jnp.asarray(x), jnp.asarray(m)))
    for q in (0.1, 0.5, 0.93):
        _close(geo.masked_quantile(tx, tm, q), jgeo.masked_quantile(jnp.asarray(x),
                                                                    jnp.asarray(m), q))
    p1, p2 = (rng.standard_normal((B, H, W, 3)).astype(np.float32) for _ in range(2))
    v1, v2 = (rng.uniform(size=(B, H, W)) > 0.3 for _ in range(2))
    for mode in ("avg_dis", "avg_log1p", "avg_warp-log1p", "median_dis", "sqrt_dis"):
        got = geo.normalize_pointcloud(*map(torch.from_numpy, (p1, p2)), mode,
                                       *map(torch.from_numpy, (v1, v2)), ret_factor=True)
        want = jgeo.normalize_pointcloud(*map(jnp.asarray, (p1, p2)), mode,
                                         *map(jnp.asarray, (v1, v2)), ret_factor=True)
        for a, b in zip(got, want):
            _close(a, b)
        _close(geo.normalize_pointcloud(torch.from_numpy(p1), None, mode),
               jgeo.normalize_pointcloud(jnp.asarray(p1), None, mode))
    for q in (0.5, 0.25):
        _close(geo.get_joint_pointcloud_depth(*map(torch.from_numpy, (p1[..., 2], p2[..., 2],
                                                                      v1, v2)), quantile=q),
               jgeo.get_joint_pointcloud_depth(*map(jnp.asarray, (p1[..., 2], p2[..., 2], v1,
                                                                  v2)), quantile=q))
    for z_only in (False, True):
        got = geo.get_joint_pointcloud_center_scale(*map(torch.from_numpy, (p1, p2, v1, v2)),
                                                    z_only=z_only)
        want = jgeo.get_joint_pointcloud_center_scale(*map(jnp.asarray, (p1, p2, v1, v2)),
                                                      z_only=z_only)
        for a, b in zip(got, want):
            _close(a, b)


def test_pred_decoding_matches_jax():
    rng = np.random.default_rng(12)
    gts, preds = make_case(12)
    for side, use_pose in ((0, False), (1, True)):
        _close(tinf.get_pred_pts3d(_torch(gts[side]), _torch(preds[side]), use_pose),
               jinf.get_pred_pts3d(_jax(gts[side]), _jax(preds[side]), use_pose))
    depth = rng.uniform(1, 3, (B, H, W)).astype(np.float32)
    focal = rng.uniform(4, 6, (B, H, W)).astype(np.float32)
    pose = np.stack([_pose(rng) for _ in range(B)])
    pred = dict(depth=depth, pseudo_focal=focal, camera_pose=pose)
    _close(tinf.get_pred_pts3d(_torch(gts[0]), _torch(pred), True),
           jinf.get_pred_pts3d(_jax(gts[0]), _jax(pred), True))
    g1, g2 = gts[0]["pts3d"], gts[1]["pts3d"]
    r1 = (2.0 * g1 + 0.1 * rng.standard_normal(g1.shape)).astype(np.float32)
    r2 = (2.0 * g2 + 0.1 * rng.standard_normal(g2.shape)).astype(np.float32)
    v1, v2 = gts[0]["valid_mask"], gts[1]["valid_mask"]
    for mode in ("avg", "median", "weiszfeld", "weiszfeld_stop_grad"):
        got = tinf.find_opt_scaling(*map(torch.from_numpy, (g1, g2, r1, r2)), mode,
                                    *map(torch.from_numpy, (v1, v2)))
        want = jinf.find_opt_scaling(*map(jnp.asarray, (g1, g2, r1, r2)), mode,
                                     *map(jnp.asarray, (v1, v2)))
        _close(got, want)
    _close(tinf.find_opt_scaling(torch.from_numpy(g1), None, torch.from_numpy(r1)),
           jinf.find_opt_scaling(jnp.asarray(g1), None, jnp.asarray(r1)))
