"""The port's global aligner, and the geometry, pose and focal code it
reaches, against the JAX package on the CPU.

Scenes come from `make_synthetic_scene` (tests/test_cloud_opt.py: exact
pairwise pointmaps of a known rig, H = 24, W = 32) and every other input
from a seeded numpy generator; both packages take the same arrays. The
port runs on CPU tensors. Tolerances: 1e-5 in fp32 (relative to the
largest |value| where gradients are compared), 1e-9 for the float64 host
code, and the ones stated at each aligner run.

The port's PnP is its own numpy solver (the JAX package calls cv2, which
the port does not carry); `test_pnp_*` hold it to cv2, through the JAX
package's `fast_pnp`.
"""
import os.path as osp
import sys

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

sys.path.insert(0, osp.dirname(osp.abspath(__file__)))

from dust3r_tpu import post_process as jpost  # noqa: E402
from dust3r_tpu.cloud_opt import GlobalAlignerMode as JaxMode  # noqa: E402
from dust3r_tpu.cloud_opt import global_aligner as jax_global_aligner  # noqa: E402
from dust3r_tpu.cloud_opt import init_im_poses as jinit  # noqa: E402
from dust3r_tpu.cloud_opt import ModularPointCloudOptimizer as JaxModular  # noqa: E402
from dust3r_tpu.cloud_opt.base_opt import alignment_value_and_grad  # noqa: E402
from dust3r_tpu.utils import geometry as jgeo  # noqa: E402
from dust3r_tpu.utils import pose as jpose  # noqa: E402
from dust3r_tpu_torch import post_process  # noqa: E402
from dust3r_tpu_torch.cloud_opt import (GlobalAlignerMode, ModularPointCloudOptimizer,  # noqa: E402
                                        global_aligner)
from dust3r_tpu_torch.cloud_opt import init_im_poses  # noqa: E402
from dust3r_tpu_torch.cloud_opt.commons import make_lr_schedule  # noqa: E402
from dust3r_tpu_torch.cloud_opt.optimizer import adam_step  # noqa: E402
from dust3r_tpu_torch.utils import geometry, pose  # noqa: E402
from test_cloud_opt import angular_error_deg, make_synthetic_scene, relpose  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
TOL64 = dict(rtol=1e-9, atol=1e-9)
GOLDEN = osp.join(osp.dirname(osp.abspath(__file__)), "golden", "aligner_trajectory.npz")
OBS = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.tensor(np.asarray(x))


def _scenes(out, obs="fp32", **kw):
    """The same inference output in both aligners."""
    jdt, tdt = OBS[obs]
    js = jax_global_aligner(out, mode=JaxMode.PointCloudOptimizer, verbose=False,
                            obs_dtype=jdt, **kw)
    ts = global_aligner(out, device="cpu", verbose=False, obs_dtype=tdt, **kw)
    return js, ts


def mixed_scene():
    """Four images, two of them cut to 16 of their 24 rows: the observations
    of the smaller ones are zero-padded to the largest area."""
    out, *_ = make_synthetic_scene(n_imgs=4)
    rows = {0: 24, 1: 24, 2: 16, 3: 16}
    edges = list(zip(out["view1"]["idx"], out["view2"]["idx"]))
    pred1 = dict(pts3d=[out["pred1"]["pts3d"][e][:rows[i]] for e, (i, j) in enumerate(edges)],
                 conf=[out["pred1"]["conf"][e][:rows[i]] for e, (i, j) in enumerate(edges)])
    pred2 = dict(pts3d_in_other_view=[out["pred2"]["pts3d_in_other_view"][e][:rows[j]]
                                      for e, (i, j) in enumerate(edges)],
                 conf=[out["pred2"]["conf"][e][:rows[j]] for e, (i, j) in enumerate(edges)])
    return dict(view1=dict(idx=out["view1"]["idx"]), view2=dict(idx=out["view2"]["idx"]),
                pred1=pred1, pred2=pred2)


# ---------------------------------------------------------------------- #
# geometry, pose, focal
# ---------------------------------------------------------------------- #

GEOTRF_CASES = {  # name: (Trf shape, pts shape, kwargs)
    "4x4_on_pointmap": ((4, 4), (5, 7, 3), {}),
    "batched_4x4": ((3, 4, 4), (3, 5, 7, 3), {}),
    "intrinsics_norm": ((3, 3), (5, 7, 3), dict(norm=1, ncol=2)),
    "homography_2d": ((3, 3), (11, 2), dict(norm=2)),
    "linear_3x3": ((2, 3, 3), (2, 6, 3), {}),
}


@pytest.mark.parametrize("case", sorted(GEOTRF_CASES))
def test_geotrf_matches_jax(case):
    tshape, pshape, kw = GEOTRF_CASES[case]
    rng = np.random.default_rng(0)
    trf = rng.standard_normal(tshape).astype(np.float32)
    trf[..., -1, -1] += 3  # keep homogeneous coordinates away from 0
    pts = rng.standard_normal(pshape).astype(np.float32)
    want = np.asarray(jgeo.geotrf(trf, pts, **kw))
    np.testing.assert_allclose(_np(geometry.geotrf(_t(trf), _t(pts), **kw)), want, **TOL)
    got_np = geometry.geotrf(trf, pts, **kw)  # host numpy in, numpy out
    assert isinstance(got_np, np.ndarray) and got_np.dtype == np.float32
    np.testing.assert_allclose(got_np, want, **TOL)


def test_xy_grid_and_inv_match_jax():
    np.testing.assert_array_equal(_np(geometry.xy_grid(7, 5)), np.asarray(jgeo.xy_grid(7, 5)))
    np.testing.assert_array_equal(_np(geometry.xy_grid(4, 3, origin=(2, 1), homogeneous=True)),
                                  np.asarray(jgeo.xy_grid(4, 3, origin=(2, 1),
                                                          homogeneous=True)))
    rng = np.random.default_rng(1)
    mats = (rng.standard_normal((3, 4, 4)) + 4 * np.eye(4)).astype(np.float32)
    np.testing.assert_allclose(_np(geometry.inv(_t(mats))), np.asarray(jgeo.inv(mats)), **TOL)
    np.testing.assert_allclose(geometry.inv(mats), np.asarray(jgeo.inv(mats)), **TOL)


@pytest.mark.parametrize("focal_dims", [3, 4, "4x2"])
@pytest.mark.parametrize("with_pp", [False, True])
def test_depthmap_to_pts3d_matches_jax(focal_dims, with_pp):
    rng = np.random.default_rng(2)
    depth = rng.uniform(1, 3, (2, 5, 7)).astype(np.float32)
    shape = {3: (2, 5, 7), 4: (2, 1, 5, 7), "4x2": (2, 2, 5, 7)}[focal_dims]
    focal = rng.uniform(20, 40, shape).astype(np.float32)
    pp = rng.uniform(2, 4, (2, 2)).astype(np.float32) if with_pp else None
    want = jgeo.depthmap_to_pts3d(depth, focal, pp)
    got = geometry.depthmap_to_pts3d(_t(depth), _t(focal), None if pp is None else _t(pp))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_host_geometry_matches_jax():
    rng = np.random.default_rng(3)
    depth = rng.uniform(1, 3, (6, 8)).astype(np.float32)
    K = np.array([[30, 0, 4], [0, 31, 3], [0, 0, 1]], np.float32)
    pose4 = np.eye(4, dtype=np.float32)
    pose4[:3, 3] = rng.standard_normal(3)
    for cam in (pose4, None):
        got, gmask = geometry.depthmap_to_absolute_camera_coordinates(depth, K, cam)
        want, wmask = jgeo.depthmap_to_absolute_camera_coordinates(depth, K, cam)
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_array_equal(gmask, wmask)
    poses = rng.standard_normal((5, 4, 4))
    assert geometry.get_med_dist_between_poses(poses) == pytest.approx(
        jgeo.get_med_dist_between_poses(poses), rel=1e-12)


def test_pose_functions_match_jax():
    rng = np.random.default_rng(4)
    vec = rng.standard_normal((6, 8)).astype(np.float32)
    np.testing.assert_allclose(_np(pose.pose_vec_to_matrix(_t(vec))),
                               np.asarray(jpose.pose_vec_to_matrix(vec)), **TOL)
    q = vec[:, :4] / np.linalg.norm(vec[:, :4], axis=-1, keepdims=True)
    R = np.asarray(jpose.quat_to_rotmat(jnp.asarray(q)))
    np.testing.assert_allclose(_np(pose.quat_to_rotmat(_t(q))), R, **TOL)
    R64 = R.astype(np.float64)
    np.testing.assert_allclose(pose.rotmat_to_quat(R64), jpose.rotmat_to_quat(R64), **TOL64)
    M = np.asarray(jpose.pose_vec_to_matrix(vec), np.float64)
    for scale in (None, 2.5):
        np.testing.assert_allclose(pose.matrix_to_pose_vec(M, scale=scale),
                                   jpose.matrix_to_pose_vec(M, scale=scale), **TOL64)
    x = rng.standard_normal(9).astype(np.float32) * 3
    np.testing.assert_allclose(_np(pose.signed_expm1(_t(x))),
                               np.asarray(jpose.signed_expm1(x)), **TOL)
    np.testing.assert_allclose(_np(pose.signed_log1p(_t(x))),
                               np.asarray(jpose.signed_log1p(x)), **TOL)
    np.testing.assert_allclose(pose.signed_log1p(x.astype(np.float64)),
                               jpose.signed_log1p(x.astype(np.float64), xp=np), **TOL64)
    np.testing.assert_array_equal(pose.sRT_to_4x4(1.5, R64[0], vec[0, 4:7]),
                                  np.asarray(jpose.sRT_to_4x4(1.5, R64[0], vec[0, 4:7])))


def test_registration_and_pose_alignment_match_jax():
    rng = np.random.default_rng(5)
    pts1 = rng.standard_normal((50, 3))
    pts2 = 1.7 * pts1 @ np.linalg.qr(rng.standard_normal((3, 3)))[0] + 0.3
    pts2 += 0.01 * rng.standard_normal(pts2.shape)
    w = rng.uniform(0.5, 2, 50)
    for weights in (None, w):
        for a, b in zip(pose.rigid_points_registration(pts1, pts2, weights),
                        jpose.rigid_points_registration(pts1, pts2, weights)):
            np.testing.assert_allclose(a, b, **TOL64)
    src = np.asarray(jpose.pose_vec_to_matrix(rng.standard_normal((4, 7)).astype(np.float32)))
    tgt = np.asarray(jpose.pose_vec_to_matrix(rng.standard_normal((4, 7)).astype(np.float32)))
    for a, b in zip(pose.align_multiple_poses(src, tgt), jpose.align_multiple_poses(src, tgt)):
        np.testing.assert_allclose(a, b, **TOL64)


@pytest.mark.parametrize("mode", ["median", "weiszfeld"])
def test_estimate_focal_matches_jax(mode):
    out, *_ = make_synthetic_scene(n_imgs=2)
    pts = out["pred1"]["pts3d"][:2]
    rng = np.random.default_rng(6)
    pts = pts + 0.01 * rng.standard_normal(pts.shape).astype(np.float32)
    pp = np.array([[16, 12], [15, 13]], np.float32)
    want = np.asarray(jpost.estimate_focal_knowing_depth(pts, pp, focal_mode=mode))
    got = post_process.estimate_focal_knowing_depth(_t(pts), _t(pp), focal_mode=mode)
    np.testing.assert_allclose(_np(got), want, **TOL)
    assert init_im_poses.estimate_focal(pts[0]) == pytest.approx(
        jinit.estimate_focal(pts[0]), rel=1e-5)


def test_lr_schedules_match_jax():
    from dust3r_tpu.cloud_opt.commons import make_lr_schedule as jax_schedule

    for sched in ("cosine", "linear"):
        np.testing.assert_allclose(make_lr_schedule(sched, 300, 0.01, 1e-6),
                                   np.asarray(jax_schedule(sched, 300, 0.01, 1e-6)), **TOL)


# ---------------------------------------------------------------------- #
# the aligner
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("layout", ["uniform", "mixed"])
@pytest.mark.parametrize("obs", sorted(OBS))
def test_loss_and_grads_match_jax(obs, layout):
    """At the scenes' seeded random start, loss and gradient of every
    parameter against `alignment_value_and_grad`."""
    out = make_synthetic_scene(n_imgs=4)[0] if layout == "uniform" else mixed_scene()
    js, ts = _scenes(out, obs)
    for k in ts.params:
        np.testing.assert_array_equal(_np(ts.params[k]), np.asarray(js.params[k]), err_msg=k)
    loss, grads = alignment_value_and_grad(js.pts3d_fn, js.loss_spec, js.params, js.consts)
    params = {k: v.clone().requires_grad_(True) for k, v in ts.params.items()}
    tloss = ts.loss_fn(params)
    tgrads = torch.autograd.grad(tloss, list(params.values()))
    assert tloss.item() == pytest.approx(float(loss), rel=1e-5)
    for k, g in zip(params, tgrads):
        want = np.asarray(grads[k])
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(_np(g) / scale, want / scale, **TOL, err_msg=k)
    # per-image pointmaps come back at each image's own shape
    for got, want in zip(ts.get_pts3d(), js.get_pts3d()):
        assert tuple(got.shape) == np.asarray(want).shape
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_adam_step_matches_optax():
    rng = np.random.default_rng(7)
    shapes = {"a": (5, 3), "b": (4,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    masks = {"a": (rng.random(shapes["a"]) > 0.3).astype(np.float32), "b": np.ones(4, np.float32)}
    opt = optax.scale_by_adam(b1=0.9, b2=0.9)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jp)
    tp = {k: _t(v).clone() for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in tp.items()}
    nu = {k: torch.zeros_like(v) for k, v in tp.items()}
    for step, lr in ((1, 0.01), (2, 0.008), (3, 0.005)):
        grads = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        upd, state = opt.update({k: jnp.asarray(g * masks[k]) for k, g in grads.items()}, state)
        jp = {k: jp[k] - lr * upd[k] for k in jp}
        adam_step(tp, {k: _t(g) for k, g in grads.items()}, {k: _t(m) for k, m in masks.items()},
                  mu, nu, step, lr)
        for k in tp:
            np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]), rtol=1e-6, atol=1e-6)
    # frozen entries never move
    np.testing.assert_array_equal(_np(tp["a"])[masks["a"] == 0], params["a"][masks["a"] == 0])


def test_mst_init_matches_jax():
    """The same spanning tree, and the same parameters after the init (the
    images that the tree does not pose go through PnP: cv2 there, the
    port's solver here, on exact data)."""
    out, *_ = make_synthetic_scene(n_imgs=5)
    js, ts = _scenes(out)
    args = lambda s: (s.imshapes, s.edges, s.pred_i, s.pred_j, s.conf_i, s.conf_j,  # noqa: E731
                      s.im_conf, s.min_conf_thr)
    jt = jinit.minimum_spanning_tree(*args(js), verbose=False, edge_scores=js.edge_scores())
    tt = init_im_poses.minimum_spanning_tree(*args(ts), verbose=False,
                                             edge_scores=ts.edge_scores())
    assert [tuple(map(int, e)) for e in tt[1]] == [tuple(map(int, e)) for e in jt[1]]
    np.testing.assert_allclose(tt[2], jt[2], rtol=1e-5)  # focals
    np.testing.assert_allclose(tt[3], jt[3], atol=1e-5)  # poses
    jinit.init_minimum_spanning_tree(js)
    init_im_poses.init_minimum_spanning_tree(ts)
    for k in ts.params:
        np.testing.assert_allclose(_np(ts.params[k]), np.asarray(js.params[k]), **TOL,
                                   err_msg=k)
    assert ts.forward() == pytest.approx(js.forward(), abs=1e-6)


def test_alignment_matches_jax():
    """300 cosine iterations, fp32 observations, from the seeded random
    start (init=None), against the JAX run on the same scene. (From an MST
    init this exact scene starts at the optimum, where the run is chaotic:
    see test_alignment_against_the_golden.)"""
    out, *_ = make_synthetic_scene(n_imgs=5, seed=0)
    js, ts = _scenes(out)
    jfinal = js.compute_global_alignment(init=None, niter=300, schedule="cosine", lr=0.01)
    tfinal = ts.compute_global_alignment(init=None, niter=300, schedule="cosine", lr=0.01)
    assert ts.last_losses.shape == (300,) and np.isfinite(ts.last_losses).all()
    np.testing.assert_allclose(np.log10(ts.last_losses), np.log10(np.asarray(js.last_losses)),
                               atol=0.05)
    np.testing.assert_allclose(tfinal, jfinal, rtol=0.1)
    np.testing.assert_allclose(_np(ts.get_focals()), np.asarray(js.get_focals()), rtol=1e-3)
    np.testing.assert_allclose(_np(ts.get_im_poses()), np.asarray(js.get_im_poses()), atol=1e-3)


# The golden run (tests/test_golden.py::TestAlignerTrajectoryGolden) starts
# from an MST init of an exact scene, at a loss of 3e-7 where every gradient
# is rounding noise and Adam's first steps follow its signs: the trajectory
# depends on the last bit of the init and on the order of every float sum.
# Measured on the JAX package itself, its log-depths perturbed by N(0, 3e-7)
# (the size of the port's init difference), over 24 seeds: log10 losses
# move by 0.49-0.51 (at iteration 0, the perturbation itself), the final
# loss ends 15-45 % above the golden's, the focals move by 1.5e-3-3.3e-3
# relative, the poses by 2.6e-3-7.0e-3. The port lands 25-49 % below the
# golden's final loss, depending only on the order of the pose transform's
# three multiply-adds. So the final loss is held to a ceiling, the JAX
# package's own spread above the golden: a run that converges less is
# caught, one that lands closer to the exact scene is not. The rest is held
# at about the JAX spread; the golden's own tolerances hold only for a
# bitwise rerun.
GOLDEN_SPREAD = dict(log10_loss=0.5, final_above=0.45, focal_rtol=5e-3, pose_atol=1e-2)


def test_alignment_against_the_golden():
    out, poses, _, focal = make_synthetic_scene(n_imgs=5, seed=0)
    ts = global_aligner(out, device="cpu", verbose=False, obs_dtype=torch.float32)
    final = ts.compute_global_alignment(init="mst", niter=300, schedule="cosine", lr=0.01)
    golden = np.load(GOLDEN)
    np.testing.assert_allclose(np.log10(ts.last_losses[::10]),
                               np.log10(golden["losses_every10"]),
                               atol=GOLDEN_SPREAD["log10_loss"])
    assert 0 < final <= float(golden["final_loss"]) * (1 + GOLDEN_SPREAD["final_above"])
    np.testing.assert_allclose(_np(ts.get_focals()).ravel(), golden["focals"],
                               rtol=GOLDEN_SPREAD["focal_rtol"])
    np.testing.assert_allclose(_np(ts.get_im_poses()), golden["im_poses"],
                               atol=GOLDEN_SPREAD["pose_atol"])
    # and the scene itself: focals to 1 %, relative rotations to 1 degree
    np.testing.assert_allclose(_np(ts.get_focals()).ravel(), focal, rtol=1e-2)
    est = _np(ts.get_im_poses())
    for k in range(1, len(poses)):
        assert angular_error_deg(relpose(poses[0], poses[k])[:3, :3],
                                 relpose(est[0], est[k])[:3, :3]) < 1.0


def test_bf16_observations_recover_the_scene():
    """The default bf16 observations, MST init, 300 iterations: what
    chip_smoke.py asks of its full-resolution scene."""
    out, poses, depths, focal = make_synthetic_scene(n_imgs=4, seed=1)
    ts = global_aligner(out, device="cpu", verbose=False)
    assert ts.obs_pred_i.dtype == torch.bfloat16 and ts.obs_w_i.dtype == torch.bfloat16
    ts.compute_global_alignment(init="mst", niter=300, schedule="cosine", lr=0.01)
    assert ts.last_losses[-1] < ts.last_losses[10]
    np.testing.assert_allclose(_np(ts.get_focals()).ravel(), focal, rtol=1e-2)
    est = _np(ts.get_im_poses())
    for k in range(1, len(poses)):
        assert angular_error_deg(relpose(poses[0], poses[k])[:3, :3],
                                 relpose(est[0], est[k])[:3, :3]) < 1.0
    pts = ts.get_pts3d()
    assert len(pts) == 4 and tuple(pts[0].shape) == (24, 32, 3)


def test_accessors_and_clean_pointcloud_match_jax():
    """With the JAX scene's parameters loaded into the port's: pointmaps,
    depthmaps, poses, intrinsics, masks, conf maps and the occlusion
    cleaning."""
    out, *_ = make_synthetic_scene(n_imgs=3)
    js, ts = _scenes(out)
    js.compute_global_alignment(init="mst", niter=20, lr=0.01)
    ts.load_state_dict(js.state_dict())
    for got, want in ((ts.get_pts3d(), js.get_pts3d()), (ts.get_depthmaps(), js.get_depthmaps())):
        for a, b in zip(got, want):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(_np(ts.get_im_poses()), np.asarray(js.get_im_poses()), **TOL)
    np.testing.assert_allclose(_np(ts.get_intrinsics()), np.asarray(js.get_intrinsics()), **TOL)
    for a, b in zip(ts.get_masks(), js.get_masks()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ts.get_conf(), js.get_conf()):
        np.testing.assert_allclose(a, b, **TOL)
    assert ts.forward() == pytest.approx(js.forward(), rel=1e-5)
    for a, b in zip(ts.clean_pointcloud().im_conf, js.clean_pointcloud().im_conf):
        np.testing.assert_allclose(a, b, **TOL)


def test_known_poses_init_matches_jax():
    out, poses, depths, focal = make_synthetic_scene(n_imgs=3)
    js, ts = _scenes(out)
    for s in (js, ts):
        s.preset_pose(poses)
        s.preset_focal([focal] * 3)
    jinit.init_from_known_poses(js, min_conf_thr=js.min_conf_thr)
    init_im_poses.init_from_known_poses(ts, min_conf_thr=ts.min_conf_thr)
    for k in ts.params:
        np.testing.assert_allclose(_np(ts.params[k]), np.asarray(js.params[k]), rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    assert not ts.norm_pw_scale
    loss = ts.compute_global_alignment(init=None, niter=100, lr=0.01)
    assert loss < 0.05
    np.testing.assert_allclose(_np(ts.get_im_poses()), np.stack(poses), atol=1e-4)
    np.testing.assert_allclose(_np(ts.get_focals()).ravel(), focal, rtol=1e-5)
    with pytest.raises(AssertionError, match="incomplete mask"):
        ts.preset_pose([poses[0]], pose_msk=[0])


def test_pair_viewer_matches_jax():
    out, poses, depths, focal = make_synthetic_scene(n_imgs=2)
    jv = jax_global_aligner(out, mode=JaxMode.PairViewer, verbose=False)
    tv = global_aligner(out, mode=GlobalAlignerMode.PairViewer, device="cpu", verbose=False)
    np.testing.assert_allclose(_np(tv.get_focals()).ravel(), np.asarray(jv.get_focals()),
                               rtol=1e-5)
    np.testing.assert_allclose(_np(tv.get_im_poses()), np.asarray(jv.get_im_poses()), atol=1e-3)
    for a, b in zip(tv.get_depthmaps(), jv.get_depthmaps()):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-3, atol=1e-3)
    pts = tv.get_pts3d()
    assert len(pts) == 2 and tuple(pts[0].shape) == (24, 32, 3)
    est = _np(tv.get_im_poses())
    assert angular_error_deg(relpose(poses[0], poses[1])[:3, :3],
                             relpose(est[0], est[1])[:3, :3]) < 2.0
    assert np.isnan(tv.forward())
    assert np.isnan(tv.compute_global_alignment(init=None, niter=10))  # nothing to optimize


def test_device_tensor_predictions_build_the_same_scene():
    """Predictions as `InferenceEngine.infer_pairs(..., to_cpu=False)` hands
    them over (stacked tensors) build the scene that numpy builds."""
    out, *_ = make_synthetic_scene(n_imgs=3)
    as_tensors = dict(view1=out["view1"], view2=out["view2"],
                      pred1={k: _t(v) for k, v in out["pred1"].items()},
                      pred2={k: _t(v) for k, v in out["pred2"].items()})
    a = global_aligner(out, device="cpu", verbose=False)
    b = global_aligner(as_tensors, verbose=False)  # tensors stay on their device
    assert b.device == torch.device("cpu")
    for name in ("obs_pred_i", "obs_pred_j", "obs_w_i", "obs_w_j"):
        torch.testing.assert_close(getattr(b, name), getattr(a, name), rtol=0, atol=0)
    assert b.forward() == a.forward()
    for s in a.str_edges:
        np.testing.assert_array_equal(b.pred_i[s], a.pred_i[s])


def test_not_ported_paths_raise():
    """`show` (trimesh) is not ported and says which queue item holds it; a
    `mesh=` that is not a list of devices (JAX's takes a jax Mesh, the
    port's a device list: tests/test_torch_port_parallel.py drives it) and
    an observation type the JAX package does not store are refused."""
    out, *_ = make_synthetic_scene(n_imgs=3)
    for mesh in (object(), [], "cpu", [object()]):
        with pytest.raises(TypeError, match="list of devices"):
            global_aligner(out, mesh=mesh, device="cpu")
    scene = global_aligner(out, device="cpu", verbose=False)
    with pytest.raises(NotImplementedError, match="trimesh"):
        scene.show()
    with pytest.raises(ValueError, match="int8"):
        global_aligner(out, obs_dtype=torch.float16, device="cpu")


# ---------------------------------------------------------------------- #
# the aligner's options (tolerances of the scratch check recorded in
# ROADMAP.md §C: loss 1e-6 relative, gradients 1e-6 of max |grad|, every
# parameter after 40 iterations within 1e-6)
# ---------------------------------------------------------------------- #

# every option away from its default in one of three scenes (each scene is a
# compile of the JAX loop): dist, conf, the adaptors, the principal points,
# base_scale, min_conf_thr, focal_break, pw_break and the schedule. The l2
# distance (a square root, steep near 0) has a scene of its own
OPTIONS = {
    "dist_l2": (dict(dist="l2"), "cosine"),
    "sqrt_adaptors_base_scale": (dict(conf="sqrt", allow_pw_adaptors=True, base_scale=0.3),
                                 "cosine"),
    "none_pp_thr_breaks_linear": (dict(conf="none", optimize_pp=True, min_conf_thr=4.0,
                                       focal_break=12, pw_break=9), "linear"),
}


def assert_grads_match(tgrads, grads, names, tol=1e-6):
    for k, g in zip(names, tgrads):
        want = np.asarray(grads[k])
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(_np(g) / scale, want / scale, rtol=0, atol=tol, err_msg=k)


def loss_and_grads(js, ts):
    loss, grads = alignment_value_and_grad(js.pts3d_fn, js.loss_spec, js.params, js.consts)
    params = {k: v.clone().requires_grad_(True) for k, v in ts.params.items()}
    tloss = ts.loss_fn(params)
    return float(loss), grads, tloss.item(), torch.autograd.grad(tloss, list(params.values()))


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_aligner_options_match_jax(option):
    """Loss and gradients at the seeded random start, then 40 Adam
    iterations from it, fp32 observations, against the JAX aligner."""
    kw, schedule = OPTIONS[option]
    out = make_synthetic_scene(n_imgs=4, seed=3)[0]
    js, ts = _scenes(out, **kw)
    loss, grads, tloss, tgrads = loss_and_grads(js, ts)
    assert tloss == pytest.approx(loss, rel=1e-6)
    assert_grads_match(tgrads, grads, list(ts.params))
    for s in (js, ts):
        s.compute_global_alignment(init=None, niter=40, schedule=schedule, lr=0.01)
    np.testing.assert_allclose(ts.last_losses, np.asarray(js.last_losses), rtol=1e-6)
    for k in ts.params:  # within 1e-6 of the largest |value| of each parameter
        want = np.asarray(js.params[k])
        scale = max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(_np(ts.params[k]) / scale, want / scale, rtol=0, atol=1e-6,
                                   err_msg=k)


# ---------------------------------------------------------------------- #
# ModularPointCloudOptimizer (tests/test_cloud_opt.py:218-343)
# ---------------------------------------------------------------------- #

def _modular(out, **kw):
    args = (out["view1"], out["view2"], out["pred1"], out["pred2"])
    return (JaxModular(*args, verbose=False, **kw),
            ModularPointCloudOptimizer(*args, verbose=False, device="cpu",
                                       obs_dtype=torch.bfloat16, **kw))


def _same_state(js, ts, tol=TOL):
    for k in ts.masks:
        np.testing.assert_array_equal(ts.masks[k], np.asarray(js.masks[k]), err_msg=k)
    for k in ts.params:
        np.testing.assert_allclose(_np(ts.params[k]), np.asarray(js.params[k]), **tol,
                                   err_msg=k)
    assert ts.norm_pw_scale == js.norm_pw_scale


def test_modular_partial_presets_match_jax():
    """Partial presets freeze only the images they assign; norm_pw_scale
    follows the cumulative count of known poses; an empty preset is a
    no-op; the global_aligner mode builds the same scene."""
    out, poses, depths, focal = make_synthetic_scene(n_imgs=3)
    js, ts = _modular(out)
    _same_state(js, ts)
    steps = [("preset_pose", ([poses[0]],), {}),
             ("preset_pose", ([poses[1]],), dict(pose_msk=[1])),
             ("preset_focal", ([focal],), {}),
             ("preset_principal_point", ([[15.0, 11.0]],), dict(msk=[2])),
             ("preset_pose", (np.zeros((0, 4, 4)),), dict(pose_msk=[])),
             ("preset_focal", ([],), {})]
    norm = []
    for name, args, kw in steps:
        for s in (js, ts):
            getattr(s, name)(*args, **kw)
        _same_state(js, ts)
        norm.append(ts.norm_pw_scale)
    assert norm == [True, False, False, False, False, False]
    assert not ts.masks["im_poses"][:2].any() and ts.masks["im_poses"][2].all()
    assert not ts.masks["im_focals"][0].any() and ts.masks["im_focals"][1:].all()
    np.testing.assert_allclose(_np(ts.get_focals())[0, 0], focal, rtol=1e-5)
    via_mode = global_aligner(out, mode=GlobalAlignerMode.ModularPointCloudOptimizer,
                              device="cpu", verbose=False, obs_dtype=torch.bfloat16)
    assert isinstance(via_mode, ModularPointCloudOptimizer)
    with pytest.raises(AssertionError, match="incomplete mask"):  # the dense optimizer's rule
        global_aligner(out, device="cpu", verbose=False).preset_pose([poses[0]], pose_msk=[0])


def test_modular_fx_and_fy_and_focal_brake_match_jax():
    """Two focals an image, preset from intrinsics with fx != fy; the
    known-focal average; `focal_brake` as the focal scale; loss and
    gradients against the JAX aligner; then 10 MST-initialised iterations
    run (finite, the preset focals kept)."""
    from dust3r_tpu.cloud_opt.init_im_poses import get_known_focals as jax_known

    out, poses, depths, focal = make_synthetic_scene(n_imgs=3)
    js, ts = _modular(out, fx_and_fy=True, focal_brake=15)
    assert ts.focal_break == js.focal_break == 15 and _np(ts.get_focals()).shape == (3, 2)
    K = np.eye(3, dtype=np.float32)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = 42.0, 37.0, 16.0, 12.0
    for s in (js, ts):
        s.preset_intrinsics([K] * 3)
    _same_state(js, ts)
    np.testing.assert_allclose(_np(ts.get_intrinsics()), np.asarray(js.get_intrinsics()),
                               **TOL)
    n, msk, focals = init_im_poses.get_known_focals(ts)
    jn, jmsk, jfocals = jax_known(js)
    assert n == jn == 3 and focals.shape == (3,)
    np.testing.assert_array_equal(msk, jmsk)
    np.testing.assert_allclose(focals, np.asarray(jfocals), rtol=1e-6)
    loss, grads, tloss, tgrads = loss_and_grads(js, ts)
    assert tloss == pytest.approx(loss, rel=1e-5)
    assert_grads_match(tgrads, grads, list(ts.params), tol=1e-5)
    assert np.isfinite(ts.compute_global_alignment(init="mst", niter=10, lr=0.01))
    np.testing.assert_allclose(_np(ts.get_focals()), np.asarray(js.get_focals()), rtol=1e-5)


def test_modular_known_poses_init_fx_and_fy_matches_jax():
    out, poses, depths, focal = make_synthetic_scene(n_imgs=3)
    js, ts = _modular(out, fx_and_fy=True)
    H, W = ts.imshapes[0]
    K = np.eye(3, dtype=np.float32)
    K[0, 0] = K[1, 1] = focal
    K[0, 2], K[1, 2] = W / 2, H / 2
    for s in (js, ts):
        s.preset_pose(list(poses))
        s.preset_intrinsics([K] * 3)
    jinit.init_from_known_poses(js, min_conf_thr=js.min_conf_thr)
    init_im_poses.init_from_known_poses(ts, min_conf_thr=ts.min_conf_thr)
    _same_state(js, ts, dict(rtol=1e-4, atol=1e-4))
    loss = ts.compute_global_alignment(init=None, niter=50, lr=0.01)
    assert np.isfinite(loss) and loss < 0.05
    np.testing.assert_allclose(_np(ts.get_im_poses()), np.stack(poses), atol=1e-4)


# ---------------------------------------------------------------------- #
# int8 observations
# ---------------------------------------------------------------------- #

INT8_GRAPHS = {  # complete (one row an image, no padding) and a star with padded rows
    "complete": None,
    "star": [(0, 1), (1, 0), (0, 2), (2, 0), (0, 3), (3, 0), (1, 2), (2, 1)],
}


def _int8_scenes(graph, **kw):
    out = make_synthetic_scene(n_imgs=4, seed=4, edges=INT8_GRAPHS[graph])[0]
    js = jax_global_aligner(out, mode=JaxMode.PointCloudOptimizer, verbose=False,
                            obs_dtype="int8")
    ts = global_aligner(out, device="cpu", verbose=False, obs_dtype="int8", **kw)
    return out, js, ts


@pytest.mark.parametrize("graph", sorted(INT8_GRAPHS))
def test_int8_q_and_scales_are_the_jax_packages(graph):
    """The stored q and scales of every edge against the JAX package's
    image-grouped planes: edge e's slot is its rank among the edges of its
    image on that side."""
    _, js, ts = _int8_scenes(graph)
    assert ts.obs_pred_i.dtype == torch.int8 and js._n_img_groups[0] == 1
    assert "group_img_i" not in js.consts  # rows are images
    for side, idx in (("i", ts.idx_i.tolist()), ("j", ts.idx_j.tolist())):
        q_pred, q_w = _np(getattr(ts, "obs_pred_" + side)), _np(getattr(ts, "obs_w_" + side))
        s_pred, s_w = _np(ts.obs_scale["pred_" + side]), _np(ts.obs_scale["w_" + side])
        jp, jw = (np.asarray(js.consts[f"group_{k}_{side}"])[0] for k in ("pred", "w"))
        jps, jws = (np.asarray(js.consts[f"group_{k}_{side}_scale"])[0] for k in ("pred", "w"))
        for e, n in enumerate(idx):
            slot = idx[:e].count(n)
            np.testing.assert_array_equal(q_pred[e], jp[:, n, slot].T)
            np.testing.assert_array_equal(s_pred[e], jps[:, n, slot])
            np.testing.assert_array_equal(q_w[e], jw[n, slot])
            np.testing.assert_array_equal(s_w[e], jws[n, slot])
        assert q_w.min() >= 0  # symmetric int8 on non-negative weights, as there


@pytest.mark.parametrize("graph", sorted(INT8_GRAPHS))
def test_int8_loss_and_grads_match_jax(graph):
    """Loss within 1e-6 relative and gradients within 1e-6 of max |grad|
    of the JAX int8 scene's, the port dequantizing 3 edges at a time."""
    _, js, ts = _int8_scenes(graph, edge_chunk=3)
    loss, grads, tloss, tgrads = loss_and_grads(js, ts)
    assert tloss == pytest.approx(loss, rel=1e-6)
    assert_grads_match(tgrads, grads, list(ts.params))
    assert ts.forward() == pytest.approx(js.forward(), rel=1e-6)


def test_int8_temporaries_stay_within_one_chunk():
    """Every dequantized tensor spans at most one chunk of edges, and the
    edge loop keeps for the backward no more fp32 than the world points and
    one chunk (the chunks are checkpointed: recomputed in the backward, one
    at a time), where the unchunked fp32 loss keeps several copies of the
    whole set; the gradients equal those of one unchunked pass."""
    out, _, ts = _int8_scenes("complete", edge_chunk=3)
    A, E = ts.max_area, ts.n_edges
    spans = []
    real = ts.dequantize

    def spy(q, scale):
        spans.append(q.shape[0])
        return real(q, scale)

    def kept(fn):
        """fp32 storages (their sizes) that autograd keeps for the backward."""
        saved = {}

        def pack(t):
            if t.dtype == torch.float32:
                saved[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes() // 4
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = fn()
        return out, saved

    params = {k: v.clone().requires_grad_(True) for k, v in ts.params.items()}
    _, base = kept(lambda: (ts.depth_to_pts3d(params), ts.get_pw_poses(params),
                            ts.get_adaptors(params)))
    ts.dequantize = spy
    loss, saved = kept(lambda: ts.loss_fn(params))
    grads = torch.autograd.grad(loss, list(params.values()))
    ts.dequantize = real
    extra = sum(saved.values()) - sum(base.values())  # the edge loop's, after the points'
    assert spans and max(spans) <= 3
    assert len(spans) >= 4 * 2 * -(-E // 3)  # each side's chunks, forward and backward
    # the checkpoints hold the world points (N, A, 3) as their input, and
    # the chunks' small scales; nothing of an edge's observations
    assert extra <= (ts.n_imgs + 3) * A * 3 < E * A * 3, (extra, E * A * 3)
    fp32 = global_aligner(out, device="cpu", verbose=False, obs_dtype=torch.float32)
    _, flat = kept(lambda: fp32.loss_fn({k: v.clone().requires_grad_(True)
                                         for k, v in fp32.params.items()}))
    assert sum(flat.values()) - sum(base.values()) >= 2 * E * A * 3  # what chunks avoid
    ts.edge_chunk = E  # one pass
    whole = torch.autograd.grad(ts.loss_fn(params), list(params.values()))
    for a, b in zip(grads, whole):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_int8_recovers_the_scene_as_the_jax_package_requires():
    """tests/test_cloud_opt.py::TestInt8ObsAccuracyDelta on the port: int8
    against fp32 observations, MST init, 150 cosine iterations."""
    out, poses, depths, focal = make_synthetic_scene(n_imgs=4, seed=2)
    res = {}
    for dt in (torch.float32, "int8"):
        scene = global_aligner(out, device="cpu", verbose=False, obs_dtype=dt)
        loss = scene.compute_global_alignment(init="mst", niter=150, schedule="cosine",
                                              lr=0.01)
        est = _np(scene.get_im_poses())
        res[str(dt)] = dict(
            loss=loss, focal_err=np.abs(_np(scene.get_focals()).ravel() - focal).max() / focal,
            pose_err=max(angular_error_deg(relpose(poses[0], poses[k])[:3, :3],
                                           relpose(est[0], est[k])[:3, :3])
                         for k in range(1, 4)))
    a, b = res[str(torch.float32)], res["int8"]
    assert b["loss"] < 0.03
    assert b["focal_err"] <= a["focal_err"] + 0.01
    assert b["pose_err"] <= a["pose_err"] + 0.3


# ---------------------------------------------------------------------- #
# mask_sky, get_dense_pts3d
# ---------------------------------------------------------------------- #

def sky_scene(n_imgs=3):
    """The synthetic scene with images: a bright, low-saturation band on
    top (sky) over seeded noise."""
    out, *_ = make_synthetic_scene(n_imgs=n_imgs)
    rng = np.random.default_rng(8)
    H, W = out["pred1"]["conf"].shape[1:]
    imgs = rng.uniform(-1, 0.2, (n_imgs, H, W, 3)).astype(np.float32)
    imgs[:, :H // 3] = np.float32([0.75, 0.8, 0.9])
    for side in ("view1", "view2"):
        out[side]["img"] = imgs[np.asarray(out[side]["idx"])]
    return out


def test_mask_sky_and_dense_pts3d_match_jax():
    out = sky_scene()
    js, ts = _scenes(out)
    for a, b in zip(ts.imgs, js.imgs):
        np.testing.assert_array_equal(a, b)
    js.compute_global_alignment(init="mst", niter=10, lr=0.01)
    ts.load_state_dict(js.state_dict())
    jm, tm = js.mask_sky(), ts.mask_sky()
    assert tm is not ts and tm.obs_pred_i is ts.obs_pred_i  # shallow: observations shared
    for got, want, before in zip(tm.im_conf, jm.im_conf, ts.im_conf):
        np.testing.assert_array_equal(got, want)
        assert (got == 0).any() and not (before == 0).any()  # the sky, and only the copy
    pts, depths, confs = ts.get_dense_pts3d()
    jpts, jdepths, jconfs = js.get_dense_pts3d()
    for a, b in zip(pts, jpts):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5, atol=1e-4)
    for a, b in zip(depths, jdepths):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5, atol=1e-4)
    for a, b in zip(confs, jconfs):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------- #
# PnP: the port's numpy solver against cv2 (through the JAX fast_pnp)
# ---------------------------------------------------------------------- #

def pnp_scene(H, W, focal, seed, noise=0.0, outliers=0.0, pp=None):
    """A pointmap of a slanted, rippled surface seen by a camera at a seeded
    pose with the given focal and principal point (default: the centre);
    world points with Gaussian noise, and a share of them thrown off by ~1
    unit. Returns (pts3d (H, W, 3) fp32, cam2world)."""
    from scipy.spatial.transform import Rotation

    cx, cy = (W / 2, H / 2) if pp is None else pp
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:H, :W].astype(np.float64)
    depth = 1.5 + 4 * (xx / W) * (yy / H) + 0.5 * np.sin(xx / 9) * np.cos(yy / 7)
    cam = np.stack([(xx - cx) * depth / focal, (yy - cy) * depth / focal, depth], -1)
    R = Rotation.from_rotvec(rng.normal(size=3) * 0.3).as_matrix()
    t = rng.normal(size=3)
    X = (cam - t) @ R + noise * rng.standard_normal(cam.shape)
    off = rng.random((H, W)) < outliers
    X[off] += rng.normal(size=(int(off.sum()), 3))
    c2w = np.eye(4)
    c2w[:3, :3], c2w[:3, 3] = R.T, -R.T @ t
    return X.astype(np.float32), c2w


@pytest.mark.parametrize("pp", [None, (30.0, 26.0)])
@pytest.mark.parametrize("focal", [40.0, 90.0])
def test_pnp_matches_cv2_on_exact_data(focal, pp):
    H, W = 48, 64
    X, c2w = pnp_scene(H, W, focal, seed=int(focal), pp=pp)
    msk = np.ones((H, W), bool)
    msk[::7, ::5] = False
    want = jinit.fast_pnp(X, focal, msk, pp=pp)
    got = init_im_poses.fast_pnp(X, focal, msk, pp=pp)
    assert got[0] == want[0] == focal
    np.testing.assert_allclose(got[1], want[1], atol=1e-3)
    np.testing.assert_allclose(got[1], c2w, atol=1e-3)


@pytest.mark.parametrize("seed,k", [(0, 3), (1, 8), (2, 12)])
def test_pnp_picks_cv2s_focal(seed, k):
    """Unknown focal, 0.05 % noise and 20 % gross outliers: both solvers try
    the 21 candidates and keep the one with the most inliers; the scene's
    focal is candidate k."""
    H, W = 192, 256
    cands = np.geomspace(W / 2, W * 3, 21)
    X, c2w = pnp_scene(H, W, cands[k], seed, noise=5e-4, outliers=0.2)
    msk = np.ones((H, W), bool)
    want = jinit.fast_pnp(X, None, msk)
    got = init_im_poses.fast_pnp(X, None, msk)
    assert got[0] == want[0] == cands[k]
    np.testing.assert_allclose(got[1], want[1], atol=1e-3)


def test_pnp_gives_up_like_cv2():
    X, _ = pnp_scene(8, 8, 10.0, 0)
    few = np.zeros((8, 8), bool)
    few[0, :3] = True
    assert init_im_poses.fast_pnp(X, 10.0, few) is None
    assert jinit.fast_pnp(X, 10.0, few) is None


@pytest.mark.parametrize("focal", [0.0, float("nan"), float("inf"), -10.0])
def test_pnp_takes_a_degenerate_focal_like_cv2(focal):
    """A focal estimated from a degenerate pointmap can be 0 (or not
    finite): cv2 then finds no pose, and the port's solver gives up too
    instead of inverting a singular K; a negative focal is a camera for
    both."""
    X, _ = pnp_scene(16, 32, 20.0, 3)
    msk = np.ones((16, 32), bool)
    want = jinit.fast_pnp(X, focal, msk)
    got = init_im_poses.fast_pnp(X, focal, msk)
    assert (got is None) == (want is None) == (not np.isfinite(focal) or focal == 0)
    if want is not None:
        assert got[0] == want[0] == focal


def test_chip_smoke_scene_is_the_tests_scene():
    """chip_smoke.py builds its full-resolution scene (`tools.scenes`) as
    make_synthetic_scene builds this file's, with the port's geometry in
    place of the JAX one."""
    from dust3r_tpu_torch.tools.scenes import synthetic_scene

    out, poses, focal = synthetic_scene(4, 24, 32, 40.0, seed=0)
    ref, ref_poses, _, ref_focal = make_synthetic_scene(n_imgs=4, H=24, W=32, focal=40.0)
    assert focal == ref_focal
    np.testing.assert_array_equal(np.stack(poses), np.stack(ref_poses))
    for side in ("view1", "view2"):
        assert list(out[side]["idx"]) == list(ref[side]["idx"])
    for side, key in (("pred1", "pts3d"), ("pred1", "conf"), ("pred2", "pts3d_in_other_view"),
                      ("pred2", "conf")):
        np.testing.assert_allclose(out[side][key], ref[side][key], **TOL)
