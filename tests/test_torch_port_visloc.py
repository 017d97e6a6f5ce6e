"""The port's visual localization against the JAX package's.

Each ported function is held to its JAX counterpart on the same seeded
inputs: the bucket table and the resize plumbing (exact), COLMAP and
pairsfile parsing (equal dicts), the LTVL export and the stats line (byte
for byte), the intrinsics converters and the reciprocal matches (exact),
`ImgNorm` (the numpy formula bit for bit; the JAX one, which goes
through the native image core where it is built, within 2^-23, one fp32
ulp at 1: `x * (2 / 255) - 1` rounds otherwise than `(x / 255 - 0.5) /
0.5`). `run_pnp`'s numpy solver is held to the JAX
`run_pnp` (cv2's undistortPoints + solvePnPRansac(SQPNP)): on exact
correspondences, in general position and on a plane, with and without
k1, the pose within 1e-5 of JAX's; with 1 px noise and 30 % outliers over
ten seeds each pose within 0.02 units and 0.2 degrees of the truth, at
most 3x cv2's error plus 2e-3 units / 0.02 degrees, and the mean error
over the seeds at most 1.25x cv2's; the undistortion within 1e-6 px of
cv2's (float64; the fp32 result within one ulp). `localize_query`,
the COLMAP dataset end to end (kapture stubbed as
tests/test_visloc_colmap_e2e.py stubs it) and `main` on a tiny model that
both packages load from one `.pth` are held to the root `visloc.py`: the same
PnP inputs, poses within 0.01 units and 0.2 degrees of the truth,
pointmaps within 1e-5 relative, the same export format and stats line.
"""
import hashlib
import os.path as osp
import re
import sys
import types

import numpy as np
import PIL.Image
import pytest
import torch

import dust3r_tpu.visloc.datasets.base_colmap as jcolmap
import dust3r_tpu.visloc.evaluation as jeval
import dust3r_tpu.visloc.localization as jloc
import dust3r_tpu.visloc.utils as jutils
from dust3r_tpu.datasets.utils.transforms import ImgNorm as jImgNorm
from dust3r_tpu.utils import geometry as jgeom
from dust3r_tpu_torch.datasets.utils.transforms import ImgNorm
from dust3r_tpu_torch.tools.visloc_scenes import (OracleEngine, SceneSpec,
                                                  SyntheticColmapDataset, write_scene)
from dust3r_tpu_torch.utils import geometry
from dust3r_tpu_torch.visloc import cli, evaluation, localization, utils
from dust3r_tpu_torch.visloc.datasets import DATASET_REGISTRY, base_colmap

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, osp.dirname(osp.abspath(__file__)))
import visloc as jvisloc  # noqa: E402
import test_visloc_colmap_e2e as e2e  # noqa: E402
from test_visloc_colmap_e2e import scene_dir  # noqa: E402,F401  (the fixture)

NOISY_TE, NOISY_AE = 0.02, 0.2  # noisy PnP: each pose's bound to the truth
CV2_FACTOR, CV2_TE, CV2_AE = 3.0, 2e-3, 0.02  # ... and to cv2's error
MEAN_FACTOR = 1.25  # the mean error over the seeds against cv2's mean
NUMBER = re.compile(r"=(np\.float64\([^)]*\)|[-+0-9.e]+|inf|nan)")  # a stats line's values


def assert_same(a, b, where="value"):
    """Equal nested dicts / lists / tuples / arrays, arrays bit for bit
    (NaN equal to NaN) with the same dtype."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), where
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for n, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{n}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


# ------------------------------------------------------------- the buckets
@pytest.mark.parametrize("maxdim", [224, 512])
@pytest.mark.parametrize("orientation", ["landscape", "portrait"])
def test_buckets_and_resize_match_jax(maxdim, orientation):
    """Every bucket of the table, at its own size (the identity) and at
    seeded sizes around it: the bucket, to_resize / to_orig, the resized
    image (uint8, float, mask) and rescale_points3d, all exact."""
    rng = np.random.default_rng(maxdim + (orientation == "portrait"))
    sizes = []
    for ratio, (w, h) in utils.ratios_resolutions[maxdim].items():
        sizes.append((h, w))
        for _ in range(3):
            long = int(rng.integers(w // 2, 3 * w))
            short = max(8, int(long / ratio * rng.uniform(0.85, 1.15)))
            sizes.append((short, long))
    for H, W in sizes:
        if orientation == "portrait":
            H, W = W, H
        assert_same(utils.get_HW_resolution(H, W, maxdim), jutils.get_HW_resolution(H, W, maxdim))
        img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        for is_mask in (False, True):
            op, to_resize, to_orig = utils.get_resize_function(maxdim, 16, H, W, is_mask)
            jop, jto_resize, jto_orig = jutils.get_resize_function(maxdim, 16, H, W, is_mask)
            assert_same((to_resize, to_orig), (jto_resize, jto_orig), f"{H}x{W}")
            assert_same(op(img), jop(img), f"{H}x{W} uint8")
            assert_same(op(img[..., 0]), jop(img[..., 0]), f"{H}x{W} one channel")
        fimg = ImgNorm(img)
        assert_same(op(fimg), jop(fimg), f"{H}x{W} float")
        HR, WR = (op(img[..., 0]).shape if not (to_resize == np.eye(3)).all() else (H, W))
        pts2d = np.stack([rng.uniform(-2, W + 2, 500), rng.uniform(-2, H + 2, 500)], -1)
        pts3d = rng.normal(size=(500, 3)).astype(np.float32)
        assert_same(utils.rescale_points3d(pts2d, pts3d, to_resize, HR, WR),
                    jutils.rescale_points3d(pts2d, pts3d, to_resize, HR, WR), f"{H}x{W} rescale")


# ----------------------------------------------------- COLMAP, pairs, export
def _write_colmap_model(path, rng):
    cams = ["1 SIMPLE_PINHOLE 640 480 500 320 240", "2 PINHOLE 800 600 610.5 605.25 400 300",
            "3 SIMPLE_RADIAL 1920 1080 1650 960 540 -0.0375",
            "4 RADIAL 1024 768 900 512 384 0.01 -0.002",
            "5 OPENCV 1200 1600 1400 1401 600 800 0.01 -0.02 0.001 0.0005"]
    (path / "cameras.txt").write_text("# cameras\n# header\n" + "\n".join(cams) + "\n")
    img_lines, pid = ["# images"], 0
    pts_lines = ["# points3D"]
    for k in range(1, 7):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        t = rng.normal(size=3) * 3
        img_lines.append(f"{k} " + " ".join(repr(float(v)) for v in (*q, *t))
                         + f" {1 + k % 5} seq{k % 2}/img{k}.jpg")
        obs = []
        for _ in range(int(rng.integers(3, 12))):
            x, y = rng.uniform(0, 1000, 2)
            if rng.uniform() < 0.2:
                obs += [f"{x:.4f}", f"{y:.4f}", "-1"]
                continue
            pid += 1
            obs += [f"{x:.4f}", f"{y:.4f}", str(pid)]
            p = rng.normal(size=3) * 10
            pts_lines.append(f"{pid} " + " ".join(repr(float(v)) for v in p) + f" 1 2 3 0.5 {k} 0")
        img_lines.append(" ".join(obs))
    (path / "images.txt").write_text("\n".join(img_lines) + "\n")
    (path / "points3D.txt").write_text("\n".join(pts_lines) + "\n")


def test_colmap_model_and_pairsfile_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    _write_colmap_model(tmp_path, rng)
    assert_same(base_colmap.read_colmap_text_model(str(tmp_path)),
                jcolmap.read_colmap_text_model(str(tmp_path)))
    lines = [f"q{int(rng.integers(0, 4))} m{int(rng.integers(0, 20))}"
             + (f" {rng.uniform(0, 1):.6f}" if rng.uniform() < 0.8 else "") for _ in range(40)]
    (tmp_path / "pairs.txt").write_text("\n".join(lines + ["", "lonely"]) + "\n")
    pairs = base_colmap.get_ordered_pairs_from_file(str(tmp_path / "pairs.txt"))
    assert_same(pairs, jcolmap.get_ordered_pairs_from_file(str(tmp_path / "pairs.txt")))
    assert len(pairs) == 4


def _rotmat(x, y, z, w):
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _random_pose(rng):
    q = rng.normal(size=4)
    pose = np.eye(4)
    pose[:3, :3] = _rotmat(*q / np.linalg.norm(q))
    pose[:3, 3] = rng.normal(size=3) * 5
    return pose


def test_export_and_stats_match_jax_byte_for_byte(tmp_path):
    rng = np.random.default_rng(4)
    names = [f"seq{k % 3}/frame{k:05d}.png" for k in range(12)]
    poses = [None if k % 5 == 3 else _random_pose(rng) for k in range(12)]
    for pkg, out in ((evaluation, tmp_path / "port"), (jeval, tmp_path / "jax")):
        pkg.export_results(str(out), "tol_conf_3.0_reproj_err_5.0", names, poses)
    for suffix in ("_results.txt", "_ltvl.txt"):
        name = "tol_conf_3.0_reproj_err_5.0" + suffix
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    te = list(rng.uniform(0, 1, 12) ** 3) + [float("inf")]
    ae = list(rng.uniform(0, 12, 12)) + [float("inf")]
    assert evaluation.aggregate_stats("Scene()", te, ae) == jeval.aggregate_stats("Scene()", te, ae)
    for a, b in zip(poses[:3], poses[1:4]):
        if a is not None and b is not None:
            assert evaluation.get_pose_error(a, b) == jeval.get_pose_error(a, b)
    evaluation.export_results(None, "x", names, poses)  # no directory: nothing written
    assert evaluation.THRESHOLDS == jeval.THRESHOLDS


def test_intrinsics_and_reciprocal_matches_match_jax():
    rng = np.random.default_rng(5)
    K = rng.uniform(100, 900, (3, 3)).astype(np.float32)
    assert_same(geometry.colmap_to_opencv_intrinsics(K), jgeom.colmap_to_opencv_intrinsics(K))
    assert_same(geometry.opencv_to_colmap_intrinsics(K), jgeom.opencv_to_colmap_intrinsics(K))
    P1 = rng.normal(size=(3000, 3)).astype(np.float32)
    P2 = (P1[rng.permutation(3000)[:2000]] + rng.normal(size=(2000, 3)) * 0.05).astype(np.float32)
    got = geometry.find_reciprocal_matches(P1, P2)
    assert_same(got, jgeom.find_reciprocal_matches(P1, P2))
    assert 0 < got[2] < 2000


def test_imgnorm_matches_jax():
    """Every uint8 value and a seeded image: the numpy formula (the JAX
    package's fallback) bit for bit; the JAX ImgNorm (the native core where
    built) within one fp32 ulp at 1; PIL and float input as JAX takes them."""
    rng = np.random.default_rng(6)
    img = np.concatenate([np.arange(256, dtype=np.uint8).repeat(3).reshape(16, 16, 3),
                          rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)])
    got = ImgNorm(img)
    assert got.dtype == np.float32 and got.shape == img.shape
    assert_same(got, (img.astype(np.float32) / 255.0 - 0.5) / 0.5)
    want = jImgNorm(img)
    assert np.abs(got - want).max() <= 2.0 ** -23
    assert_same(ImgNorm(PIL.Image.fromarray(img)), got)
    f = rng.uniform(0, 255, (8, 8, 3)).astype(np.float32)
    assert_same(ImgNorm(f), jImgNorm(f))


def test_plot_matches_draws_with_pil(tmp_path):
    """The divergence from the JAX package's matplotlib figure (ROADMAP.md
    §C): the two images side by side (the shorter padded below), each match
    a line in its `jet` colour from a '+' in the query to one in the map."""
    rng = np.random.default_rng(7)
    q = rng.integers(0, 256, (40, 60, 3), dtype=np.uint8)
    m = rng.integers(0, 256, (50, 30, 3), dtype=np.uint8)
    m0 = np.array([[5.0, 5.0], [50.0, 30.0], [20.0, 35.0]])
    m1 = np.array([[25.0, 45.0], [3.0, 3.0], [10.0, 10.0]])
    path = utils.plot_matches(q, PIL.Image.fromarray(m), m0, m1, n_viz=2,
                              save_path=str(tmp_path / "viz.png"))
    out = np.asarray(PIL.Image.open(path))
    assert out.shape == (50, 90, 3)
    assert (out[:40, :60][out[:40, :60] != q].size > 0) and (out[40:, :60] == 0).sum() > 0
    first = np.round(utils.jet(np.array([0.0]))[0, :3] * 255).astype(np.uint8)
    last = np.round(utils.jet(np.array([1.0]))[0, :3] * 255).astype(np.uint8)
    assert (out[5, 5] == first).all() and (out[35, 20] == last).all()  # matches 0 and 2 drawn
    assert utils.plot_matches(q, m, m0[:0], m1[:0]) is None
    assert isinstance(utils.plot_matches(q, m, m0, m1), PIL.Image.Image)


# ------------------------------------------------------------------ RANSAC-PnP
def _pnp_scene(rng, n, planar, k1, noise=0.0, outliers=0.0):
    """Pixels (distorted by k1, with noise and a share of uniform outliers)
    of seeded world points, in general position (depths 3-8) or on the
    plane Z = 0; returns (pts2d fp32, pts3d fp32, K, distortion, cam2world)."""
    f, W, H = 800.0, 1024, 768
    K = np.float32([[f, 0, W / 2 - 0.5], [0, f, H / 2 - 0.5], [0, 0, 1]])
    w = rng.normal(size=3)
    w *= np.radians(20) / np.linalg.norm(w)
    theta = np.linalg.norm(w)
    k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / theta
    c2w = np.eye(4)
    c2w[:3, :3] = np.eye(3) + np.sin(theta) * k + (1 - np.cos(theta)) * k @ k
    uv = np.stack([rng.uniform(0, W, n), rng.uniform(0, H, n)], -1)
    xn = (uv - K[:2, 2]) / f
    rays = np.c_[xn, np.ones(n)] @ c2w[:3, :3].T
    if planar:
        c2w[:3, 3] = [rng.normal(), rng.normal(), -6]
        X = c2w[:3, 3] + (-c2w[2, 3] / rays[:, 2])[:, None] * rays
    else:
        c2w[:3, 3] = rng.normal(size=3)
        X = c2w[:3, 3] + rng.uniform(3, 8, n)[:, None] * rays
    px = xn * (1 + k1 * (xn ** 2).sum(-1, keepdims=True)) * f + K[:2, 2]
    px = px + rng.normal(size=px.shape) * noise
    n_out = int(outliers * n)
    px[:n_out] = np.stack([rng.uniform(0, W, n_out), rng.uniform(0, H, n_out)], -1)
    return px.astype(np.float32), X.astype(np.float32), K, [k1, 0, 0, 0], c2w


@pytest.mark.parametrize("planar", [False, True], ids=["general", "plane"])
@pytest.mark.parametrize("k1", [0.0, -0.1])
def test_run_pnp_matches_cv2_on_exact_correspondences(planar, k1):
    pytest.importorskip("cv2")
    pts2d, pts3d, K, dist, c2w = _pnp_scene(np.random.default_rng(10 + planar), 500, planar, k1)
    ok, pose = localization.run_pnp(pts2d, pts3d, K, dist)
    jok, jpose = jloc.run_pnp(pts2d, pts3d, K, dist)
    assert ok and jok
    assert np.abs(pose - jpose).max() < 1e-5
    te, ae = evaluation.get_pose_error(pose, c2w)
    assert te < 1e-4 and ae < 1e-3
    stats = localization.ransac_pnp.last_stats
    assert stats["inliers"] == 500 and 1 <= stats["iterations"] < localization.MAX_ITERATIONS


@pytest.mark.parametrize("planar", [False, True], ids=["general", "plane"])
def test_run_pnp_with_noise_and_outliers_against_cv2(planar):
    """1 px noise, 30 % outliers, k1 = -0.05, ten seeds (bounds: module
    docstring)."""
    pytest.importorskip("cv2")
    errs = []
    for seed in range(10):
        pts2d, pts3d, K, dist, c2w = _pnp_scene(np.random.default_rng(seed), 1000, planar,
                                                -0.05, noise=1.0, outliers=0.3)
        ok, pose = localization.run_pnp(pts2d, pts3d, K, dist)
        jok, jpose = jloc.run_pnp(pts2d, pts3d, K, dist)
        assert ok and jok, seed
        (te, ae), (jte, jae) = (evaluation.get_pose_error(pose, c2w),
                                evaluation.get_pose_error(jpose, c2w))
        assert te < NOISY_TE and ae < NOISY_AE, (seed, te, ae)
        assert te <= CV2_FACTOR * jte + CV2_TE and ae <= CV2_FACTOR * jae + CV2_AE, \
            (seed, te, jte, ae, jae)
        errs.append((te, ae, jte, jae))
    te, ae, jte, jae = np.mean(errs, axis=0)
    assert te <= MEAN_FACTOR * jte and ae <= MEAN_FACTOR * jae, (te, jte, ae, jae)


def test_run_pnp_below_five_points_and_bad_modes(capsys):
    rng = np.random.default_rng(11)
    K = np.float32([[500, 0, 320], [0, 500, 240], [0, 0, 1]])
    for n in range(5):
        args = (rng.uniform(0, 500, (n, 2)).astype(np.float32),
                rng.normal(size=(n, 3)).astype(np.float32), K, [0, 0, 0, 0])
        assert localization.run_pnp(*args) == (False, None) == jloc.run_pnp(*args)
    with pytest.raises(ValueError):
        localization.run_pnp(*args, mode="opencv")
    # a missing optional backend fails as the JAX package's does: printed
    pts = (rng.uniform(0, 500, (20, 2)), rng.normal(size=(20, 3)), K)
    for mode in ("poselib", "pycolmap"):
        assert localization.run_pnp(*pts, None, mode, img_size=[640, 480]) == (False, None)
    assert capsys.readouterr().out.count("error during pnp:") == 2


def test_undistortion_matches_cv2():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(12)
    K = np.array([[800.0, 0, 511.5], [0, 790.0, 383.5], [0, 0, 1]])
    uv = rng.uniform(-50, 1074, (2000, 2))
    for dist in ([-0.1, 0, 0, 0], [0.05, -0.02, 0.001, -0.002],
                 [0.05, -0.02, 0.001, -0.002, 0.01],
                 [0.05, -0.02, 0.001, -0.002, 0.01, 0.02, -0.01, 0.003],
                 [0.05, -0.02, 0.001, -0.002, 0.01, 0.02, -0.01, 0.003, 1e-3, -1e-3, 2e-3, 5e-4],
                 [-0.9, 0, 0, 0]):  # strong enough that icdist turns negative for some
        d = np.array(dist)
        want = cv2.undistortPoints(uv.reshape(-1, 1, 2), K, d, R=None, P=K).reshape(-1, 2)
        assert np.abs(localization.undistort_points(uv, K, d) - want).max() <= 1e-6, dist
        uv32, K32 = uv.astype(np.float32), K.astype(np.float32)
        want32 = cv2.undistortPoints(uv32.reshape(-1, 1, 2), K32, d, R=None, P=K32).reshape(-1, 2)
        got32 = localization.undistort_points(uv32, K32, d)
        assert got32.dtype == np.float32
        assert (np.abs(got32 - want32) <= np.spacing(np.abs(want32))).all(), dist
    with pytest.raises(ValueError):
        localization.undistort_points(uv, K, [0.1, 0.2, 0.3])


def test_p3p_recovers_poses_in_general_position_and_on_a_plane():
    """Grunert's solver alone: one of the four roots is the true pose, for
    seeded triangles in front of the camera (half of them on Z = 0)."""
    rng = np.random.default_rng(13)
    S = 400
    R = np.stack([_random_pose(rng)[:3, :3] for _ in range(S)])
    t = rng.normal(size=(S, 3))
    cam = rng.uniform(-1, 1, (S, 3, 3))
    cam[..., 2] += 4
    X = np.einsum("sji,snj->sni", R, cam - t[:, None])
    planar = np.arange(S) % 2 == 1
    X[planar, :, 2] = 0  # move the plane's points, then see them from the pose
    cam[planar] = np.einsum("sij,snj->sni", R[planar], X[planar]) + t[planar, None]
    keep = (cam[..., 2] > 0.5).all(-1)
    Rs, ts = localization.p3p(cam[keep] / np.linalg.norm(cam[keep], axis=-1, keepdims=True),
                              X[keep])
    err = np.maximum(np.abs(Rs - R[keep, None]).reshape(-1, 4, 9).max(-1),
                     np.abs(ts - t[keep, None]).max(-1))
    best = np.nanmin(err, axis=1)
    assert keep.sum() > 250 and (best < 1e-4).mean() > 0.97 and np.median(best) < 1e-9


# ---------------------------------------------------------- localize_query
class _FakeEngine:
    """tests/test_visloc.py:131-188's oracle: the query's own points for
    both views, in the query's frame."""

    def __init__(self, in_q):
        self.in_q = in_q

    def infer_pairs(self, pairs, verbose=False, to_cpu=True):
        H, W = self.in_q.shape[:2]
        conf = np.full((1, H, W), 5.0, np.float32)
        return dict(view1={}, view2={}, pred1=dict(pts3d=self.in_q[None], conf=conf),
                    pred2=dict(pts3d_in_other_view=self.in_q[None], conf=conf))


def _spy_pnp(monkeypatch, module, calls):
    real = module.run_pnp

    def spy(*args, **kw):
        calls.append((np.array(args[0]), np.array(args[1])))
        return real(*args, **kw)
    monkeypatch.setattr(module, "run_pnp", spy)


def test_localize_query_matches_jax(monkeypatch):
    rng = np.random.default_rng(1)
    f, W, H = 100.0, 64, 48
    K = np.float32([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])
    q_c2w = np.eye(4)
    q_c2w[:3, 3] = [0.3, -0.2, 0.1]
    depth = rng.uniform(2, 4, (H, W)).astype(np.float32)
    pts_world, _ = geometry.depthmap_to_absolute_camera_coordinates(depth, K, q_c2w)
    in_q = np.asarray(geometry.geotrf(np.linalg.inv(q_c2w), pts_world))
    map_view = dict(rgb_rescaled=np.zeros((H, W, 3), np.float32), pts3d_rescaled=pts_world,
                    valid_rescaled=np.ones((H, W), bool))
    query_view = dict(rgb_rescaled=np.zeros((H, W, 3), np.float32),
                      rgb=PIL.Image.new("RGB", (W, H)), intrinsics=K, distortion=None,
                      to_orig=np.eye(3), cam_to_world=q_c2w)
    calls, jcalls = [], []
    _spy_pnp(monkeypatch, cli, calls)
    _spy_pnp(monkeypatch, jvisloc, jcalls)
    args = (3.0, "cv2", 5.0, None, 100000)
    stats = {}
    ok, pose = cli.localize_query(_FakeEngine(in_q), [query_view, map_view], *args, stats=stats)
    jok, jpose = jvisloc.localize_query(_FakeEngine(in_q), [query_view, map_view], *args)
    assert ok and jok
    assert_same(calls, jcalls)  # the same matches, lifted to the same 3D points
    assert stats["matches"] == len(calls[0][0]) > 1000
    te, ae = evaluation.get_pose_error(pose, q_c2w)
    assert te < 0.01 and ae < 0.2
    assert np.abs(pose - jpose).max() < 1e-4


# ------------------------------------------------- the COLMAP dataset, end to end
def test_colmap_scene_through_main_matches_jax(scene_dir, monkeypatch, capsys):  # noqa: F811
    """tests/test_visloc_colmap_e2e.py's plane scene through the port's
    BaseVislocColmapDataset and `main` (the network an oracle of exact
    pointmaps, kapture stubbed), beside the root `visloc.py` on the same files:
    the same PnP inputs, each pose within 0.01 / 0.2 degrees of the truth
    and of JAX's, the same stats line but for the errors."""
    e2e._install_stubs(monkeypatch)
    registry = e2e._oracle_registry(scene_dir)  # keyed by the JAX ImgNorm's bytes
    for name, C in {**e2e.MAP_CENTERS, **e2e.QUERY_CENTERS}.items():  # and by the port's
        img = ImgNorm(PIL.Image.open(scene_dir / "images" / name).convert("RGB"))
        registry[hashlib.md5(img.tobytes()).hexdigest()] = C

    def oracle_inference(pairs, engine, verbose=False):
        (img_q, img_m), = pairs
        key = {n: registry[hashlib.md5(np.asarray(v["img"], np.float32)[0].tobytes())
                           .hexdigest()] for n, v in (("q", img_q), ("m", img_m))}
        dirs = e2e._cam_grid_dirs().astype(np.float32)
        conf = np.full((1, e2e.H, e2e.W), 10.0, np.float32)
        return dict(view1=img_q, view2=img_m,
                    pred1=dict(pts3d=(e2e.DEPTH * dirs)[None], conf=conf),
                    pred2=dict(pts3d_in_other_view=((key["m"] - key["q"])[None, None]
                                                    + e2e.DEPTH * dirs)[None], conf=conf))

    def colmap_dataset(pkg):
        return lambda: pkg.BaseVislocColmapDataset(
            image_path=str(scene_dir / "images"), map_path=str(scene_dir / "sfm"),
            query_path=str(scene_dir / "kapture_query"),
            pairsfile_path=str(scene_dir / "pairsfile.txt"), topk=2)

    fake_model = types.SimpleNamespace(img_size=(224, 224), patch_size=16)
    import dust3r_tpu_torch.checkpoint as ckpt
    import dust3r_tpu_torch.inference as tinf
    monkeypatch.setattr(ckpt, "from_pretrained", lambda *a, **kw: fake_model)
    monkeypatch.setattr(tinf, "InferenceEngine", lambda *a, **kw: None)
    monkeypatch.setattr(cli, "inference", oracle_inference)
    monkeypatch.setattr(cli, "TestColmapScene", colmap_dataset(base_colmap), raising=False)
    monkeypatch.setattr(jvisloc, "inference", oracle_inference)
    monkeypatch.setattr(jvisloc, "from_pretrained", lambda *a, **kw: (fake_model, {}))
    monkeypatch.setattr(jvisloc, "InferenceEngine", lambda *a, **kw: None)
    monkeypatch.setattr(jvisloc, "TestColmapScene", colmap_dataset(jcolmap), raising=False)
    calls, jcalls = [], []
    _spy_pnp(monkeypatch, cli, calls)
    _spy_pnp(monkeypatch, jvisloc, jcalls)

    lines = []
    for name, mod in (("port", cli), ("jax", jvisloc)):
        out_dir = scene_dir / f"out_{name}"
        mod.main(["--dataset", "TestColmapScene()", "--weights", "oracle",
                  "--output_dir", str(out_dir)] + (["--device", "cpu"] if mod is cli else []))
        lines.append(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(calls) == len(jcalls) == 2
    assert_same(calls, jcalls)
    assert NUMBER.sub("=#", lines[0]) == NUMBER.sub("=#", lines[1])
    assert "acc@0.1m,1deg=100.000" in lines[0] and "acc@0.1m,1deg=100.000" in lines[1]
    for name in ("port", "jax"):
        results = {ln.split()[0]: np.array(ln.split()[1:], float) for ln in
                   (scene_dir / f"out_{name}" / "tol_conf_3.0_reproj_err_5.0_results.txt")
                   .read_text().splitlines()}
        assert set(results) == set(e2e.QUERY_CENTERS)
        for q, C in e2e.QUERY_CENTERS.items():
            qw, qx, qy, qz, tx, ty, tz = results[q]
            w2c = np.eye(4)
            w2c[:3, :3] = _rotmat(qx, qy, qz, qw)
            w2c[:3, 3] = (tx, ty, tz)
            gt = np.eye(4)
            gt[:3, 3] = C
            te, ae = evaluation.get_pose_error(np.linalg.inv(w2c), gt)
            assert te < 0.01 and ae < 0.2, (name, q, te, ae)


@pytest.mark.parametrize("relief", [0.3, 0.0], ids=["relief", "plane"])
def test_synthetic_scene_tool_localizes_its_queries(tmp_path, relief):
    """The chip smoke's scene writer and oracle engine at a CPU size (the
    224 bucket, a SIMPLE_RADIAL query, a dense map): each query within 0.01
    units and 0.2 degrees, through the port's COLMAP dataset."""
    spec = SceneSpec("tiny", (400, 300), (400, 300), 330.0, 350.0, n_maps=2, n_queries=1,
                     query_model="SIMPLE_RADIAL", query_k1=-0.04, relief=relief, maxdim=224,
                     depth=4.0, spread=0.5)
    cams, surface, queries = write_scene(str(tmp_path), spec, seed=2)
    dataset = SyntheticColmapDataset(str(tmp_path), cams, queries, topk=2)
    dataset.set_resolution(types.SimpleNamespace(img_size=(224, 224), patch_size=16))
    engine = OracleEngine(cams, surface, maxdim=224)
    engine.register(dataset)
    views = dataset[0]
    assert [v["rgb_rescaled"].shape for v in views] == [(224, 224, 3)] * 3
    assert views[1]["valid_rescaled"].all()  # the map is dense at the bucket's grid
    seen = []
    names, poses, te, ae = cli.localize_dataset(engine, dataset,
                                                on_query=lambda *a: seen.append(a[3]))
    assert names == queries and all(p is not None for p in poses)
    assert max(te) < 0.01 and max(ae) < 0.2, (te, ae)
    assert seen[0]["matches"] > 10000 and seen[0]["inliers"] > 0.9 * seen[0]["matches"]


# -------------------------------------------------------------------- the CLI
TINY = dict(img_size=(64, 64), patch_size=16, enc_embed_dim=64, enc_depth=2, enc_num_heads=2,
            dec_embed_dim=48, dec_depth=2, dec_num_heads=2)
TINY_ARCH = ("AsymmetricCroCo3DStereo(pos_embed='RoPE100', img_size=(64, 64), "
             "head_type='linear', output_mode='pts3d', depth_mode=('exp', -inf, inf), "
             "conf_mode=('exp', 1, inf), enc_embed_dim=64, enc_depth=2, enc_num_heads=2, "
             "dec_embed_dim=48, dec_depth=2, dec_num_heads=2)")


@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    """tests/test_visloc.py's tiny linear model, its JAX params written once
    as a `.pth` by `dust3r_tpu.checkpoint.to_torch_state_dict`."""
    import argparse

    import jax
    import jax.numpy as jnp
    from dust3r_tpu.checkpoint import to_torch_state_dict
    from dust3r_tpu.models.model import AsymmetricCroCo3DStereo

    model = AsymmetricCroCo3DStereo(**TINY)
    img = jnp.zeros((1, 48, 64, 3), jnp.float32)
    variables = model.init(jax.random.PRNGKey(0), img, img)
    sd = to_torch_state_dict(variables, enc_depth=2, dec_depth=2, head_type="linear")
    path = tmp_path_factory.mktemp("visloc_ckpt") / "tiny.pth"
    torch.save({"model": {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
                "args": argparse.Namespace(model=TINY_ARCH)}, path)
    return path


class _SyntheticVislocDataset:
    """tests/test_visloc.py's one-query dataset: the map view knows the
    world points of a seeded depthmap seen from the identity."""

    def __init__(self):
        rng = np.random.default_rng(7)
        H, W, f = 48, 64, 80.0
        self.K = np.float32([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])
        depth = rng.uniform(2, 4, (H, W)).astype(np.float32)
        self.pts_world, _ = geometry.depthmap_to_absolute_camera_coordinates(
            depth, self.K, np.eye(4, dtype=np.float32))
        rgb = rng.uniform(0, 255, (H, W, 3)).astype(np.uint8)
        self.rgb_pil = PIL.Image.fromarray(rgb)
        self.rgb_rescaled = (rgb.astype(np.float32) / 255 - 0.5) / 0.5

    def set_resolution(self, model):
        pass

    def __len__(self):
        return 1

    def __getitem__(self, idx):
        H, W = self.rgb_rescaled.shape[:2]
        query = dict(image_name="seq/q0.png", rgb=self.rgb_pil, rgb_rescaled=self.rgb_rescaled,
                     intrinsics=self.K, distortion=None, to_orig=np.eye(3),
                     cam_to_world=np.eye(4, dtype=np.float32))
        mapv = dict(image_name="seq/m0.png", rgb=self.rgb_pil, rgb_rescaled=self.rgb_rescaled,
                    pts3d_rescaled=np.asarray(self.pts_world), valid_rescaled=np.ones((H, W), bool),
                    to_orig=np.eye(3), idx=1)
        return [query, mapv]


def _spy_inference(monkeypatch, module, outs):
    real = module.inference

    def spy(pairs, engine, **kw):
        out = real(pairs, engine, **kw)
        outs.append({f"{s}.{k}": np.array(out[s][k]) for s in ("pred1", "pred2") for k in out[s]})
        return out
    monkeypatch.setattr(module, "inference", spy)


def test_main_on_a_tiny_checkpoint_matches_jax(tiny_checkpoint, tmp_path, monkeypatch, capsys):
    """Both `main`s on the same `.pth` and dataset: pointmaps and
    confidences within 1e-5 relative, the same export files (names and
    fields) and stats line but for the numbers, the viz overlay written; the
    port's model on the CPU with --device cpu."""
    monkeypatch.setattr(cli, "SyntheticVislocDataset", _SyntheticVislocDataset, raising=False)
    monkeypatch.setattr(jvisloc, "SyntheticVislocDataset", _SyntheticVislocDataset,
                        raising=False)
    import dust3r_tpu_torch.checkpoint as ckpt
    real_load = ckpt.from_pretrained
    loaded = []
    monkeypatch.setattr(ckpt, "from_pretrained",
                        lambda *a, **kw: loaded.append(real_load(*a, **kw)) or loaded[-1])
    outs, jouts = [], []
    _spy_inference(monkeypatch, cli, outs)
    _spy_inference(monkeypatch, jvisloc, jouts)
    common = ["--dataset", "SyntheticVislocDataset()", "--weights", str(tiny_checkpoint),
              "--confidence_threshold", "1.0", "--viz_matches", "10"]
    lines = []
    for name, mod, extra in (("port", cli, ["--device", "cpu"]), ("jax", jvisloc, [])):
        mod.main(common + ["--output_dir", str(tmp_path / name)] + extra)
        lines.append(capsys.readouterr().out.strip().splitlines()[-1])
    assert next(loaded[0].parameters()).device == torch.device("cpu")
    assert len(outs) == len(jouts) == 1
    for k, want in jouts[0].items():
        got = outs[0][k]
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), k
    assert NUMBER.sub("=#", lines[0]) == NUMBER.sub("=#", lines[1])
    assert lines[0].startswith("SyntheticVislocDataset(): 1 images - median_pos_error=")
    for suffix in ("_results.txt", "_ltvl.txt"):
        fname = "tol_conf_1.0_reproj_err_5.0" + suffix
        port = (tmp_path / "port" / fname).read_text().split()
        jax_ = (tmp_path / "jax" / fname).read_text().split()
        assert len(port) == len(jax_) == 8 and port[0] == jax_[0]
        [float(v) for v in port[1:]]
    vizs = list((tmp_path / "port" / "viz").glob("*.png"))
    assert len(vizs) == 1 and vizs[0].stat().st_size > 1000


def test_main_device_and_unported_flags(tiny_checkpoint, monkeypatch):
    """No card and no --device: raises through default_device, naming the
    CPU; --mesh N with fewer than N cards visible is refused with the JAX
    CLI's message, whatever the other flags (--quantize and --serving are
    ported: tests/test_torch_port_serving.py drives them; the mesh engine:
    tests/test_torch_port_parallel.py)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = ["--dataset", "SyntheticVislocDataset()", "--weights", str(tiny_checkpoint)]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        cli.main(base)
    n = torch.cuda.device_count() + 1
    for extra in ([], ["--serving"], ["--quantize", "int8"]):
        with pytest.raises(ValueError, match=f"--mesh {n} requested but only {n - 1} devices"):
            cli.main(base + ["--device", "cpu", "--mesh", str(n)] + extra)


def test_dataset_registry_and_python_m_entry_point():
    """The four benchmark classes are the CLI's names, as in JAX; the
    package runs as `python -m dust3r_tpu_torch.visloc`."""
    import subprocess

    from dust3r_tpu.visloc.datasets import DATASET_REGISTRY as JAX_REGISTRY

    assert sorted(DATASET_REGISTRY) == sorted(JAX_REGISTRY)
    for name in DATASET_REGISTRY:
        assert getattr(cli, name) is DATASET_REGISTRY[name]
    out = subprocess.run([sys.executable, "-m", "dust3r_tpu_torch.visloc", "--help"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "--reprojection_error_diag_ratio" in out.stdout
    jparser_opts = {a.dest for a in jvisloc.get_args_parser()._actions}
    assert {a.dest for a in cli.get_args_parser()._actions} == jparser_opts
