"""The port's numpy reproductions of the preprocess scripts' cv2 calls
(`dust3r_tpu_torch/utils/cvops.py`) against cv2 itself, at small sizes.

Bit for bit: resize_area (an integer factor, 2x2's rounding, and the
weighted path at Co3d's 1920x1080 -> 683x384 ratio kind), resize_nearest_exact
(upsampling at ARKitScenes' 0.4 ratio and its transpose, and random
sizes), remap (uint8 and float32, nearest and linear, BORDER_CONSTANT with a
value, BORDER_REFLECT_101 and BORDER_WRAP, on maps that
leave the image on every side), rotate and the vertical flip. rodrigues within 1e-12; the
optimal camera matrices within 1e-6 relative; the undistortion maps within
1e-4 px. imwrite: PNG pixels equal cv2's (uint8 one and three channels,
uint16); the JPEG's decoded difference from cv2.imwrite's is printed and
held to its measured value (0: the two libjpeg encoders agree here).
"""
import itertools

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from dust3r_tpu_torch.utils import cvops  # noqa: E402

RNG_SEED = 0


def _img(rng, shape, dtype):
    if dtype == np.uint8:
        return rng.integers(0, 256, shape).astype(np.uint8)
    return rng.uniform(-5, 5, shape).astype(np.float32)


@pytest.mark.parametrize("src, dst", [((240, 135), (96, 54)), ((240, 135), (80, 45)),
                                      ((240, 136), (120, 68)), ((241, 135), (96, 54)),
                                      ((97, 63), (31, 17)), ((192, 108), (68, 38))])
@pytest.mark.parametrize("channels", [1, 3])
def test_resize_area(src, dst, channels):
    """240x135 -> 96x54 is Co3d's 1920x1080 -> 683x384 kind of ratio (the
    weighted path), 240x135 -> 80x45 an integer factor of 3 (the block
    mean in float32), 240x136 -> 120x68 the 2x2 rounding shift."""
    rng = np.random.default_rng(RNG_SEED)
    shape = (src[1], src[0]) + ((channels,) if channels > 1 else ())
    img = _img(rng, shape, np.uint8)
    ref = cv2.resize(img, dst, interpolation=cv2.INTER_AREA)
    got = cvops.resize_area(img, dst)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("src, dst", [((48, 64), (120, 160)), ((64, 48), (160, 120)),
                                      ((33, 17), (100, 51)), ((100, 37), (37, 100))])
@pytest.mark.parametrize("dtype", [np.uint16, np.uint8])
def test_resize_nearest_exact(src, dst, dtype):
    """ARKitScenes' upsampling of its lowres depth (0.4: pixel centres land
    on source edges) in both orientations, and other ratios."""
    rng = np.random.default_rng(RNG_SEED)
    shape = (src[1], src[0]) if dtype == np.uint16 else (src[1], src[0], 3)
    img = rng.integers(0, np.iinfo(dtype).max, shape).astype(dtype)
    ref = cv2.resize(img, dst, interpolation=cv2.INTER_NEAREST_EXACT)
    np.testing.assert_array_equal(cvops.resize_nearest_exact(img, dst), ref)


def test_resize_nearest_exact_random_sizes():
    rng = np.random.default_rng(RNG_SEED + 1)
    for sw, sh, dw, dh in rng.integers(1, 400, (60, 4)):
        img = rng.integers(0, 65535, (sh, sw)).astype(np.uint16)
        ref = cv2.resize(img, (int(dw), int(dh)), interpolation=cv2.INTER_NEAREST_EXACT)
        np.testing.assert_array_equal(cvops.resize_nearest_exact(img, (dw, dh)), ref)


def test_resize_nearest():
    rng = np.random.default_rng(RNG_SEED)
    img = rng.uniform(0, 9, (90, 160)).astype(np.float32)
    for size in ((85, 48), (320, 180), (61, 29)):
        np.testing.assert_array_equal(cvops.resize_nearest(img, size),
                                      cv2.resize(img, size, interpolation=cv2.INTER_NEAREST))


_BORDERS = {"constant": (cv2.BORDER_CONSTANT, cvops.BORDER_CONSTANT),
            "reflect101": (cv2.BORDER_REFLECT_101, cvops.BORDER_REFLECT_101),
            "wrap": (cv2.BORDER_WRAP, cvops.BORDER_WRAP)}


@pytest.mark.parametrize("dtype, channels, interp, border", list(itertools.product(
    (np.uint8, np.float32), (1, 3), ("nearest", "linear"), sorted(_BORDERS))))
def test_remap(dtype, channels, interp, border):
    """Maps over the whole image and 8 px past every side, with exact
    integers, halves and the last row / column among them."""
    rng = np.random.default_rng(RNG_SEED)
    H, W = 23, 37
    src = _img(rng, (H, W) + ((channels,) if channels > 1 else ()), dtype)
    mx = rng.uniform(-8, W + 8, (31, 45)).astype(np.float32)
    my = rng.uniform(-8, H + 8, (31, 45)).astype(np.float32)
    mx[0, :10], my[0, :10] = np.arange(10) + 0.5, 3.5
    mx[1, :10] = np.arange(10) - 0.5
    mx[2, :5], mx[2, 5:10], my[2, :10] = -1, W - 1, H - 1
    value = (7, 100, 200) if channels == 3 else 255
    flag = dict(nearest=(cv2.INTER_NEAREST, cvops.INTER_NEAREST),
                linear=(cv2.INTER_LINEAR, cvops.INTER_LINEAR))[interp]
    ref = cv2.remap(src, mx, my, flag[0], borderMode=_BORDERS[border][0], borderValue=value)
    got = cvops.remap(src, mx, my, flag[1], _BORDERS[border][1], value)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_remap_float64_nearest_and_fma_ties():
    """The Habitat pointmap's dtype (float64, nearest), and float32 linear
    values whose float64 sums land on float32 ties."""
    rng = np.random.default_rng(RNG_SEED)
    src = rng.uniform(-3, 3, (20, 30, 3))
    mx = rng.uniform(-2, 32, (16, 16)).astype(np.float32)
    my = rng.uniform(-2, 22, (16, 16)).astype(np.float32)
    np.testing.assert_array_equal(
        cvops.remap(src, mx, my, cvops.INTER_NEAREST, cvops.BORDER_WRAP),
        cv2.remap(src, mx, my, cv2.INTER_NEAREST, borderMode=cv2.BORDER_WRAP))
    # a b = ±2^-24 (1 + 2^-36) exactly: its 2^-60 part is lost in the float64
    # sum, which lands on a float32 tie that the exact sum passes
    a = np.float32([2.0 ** -24 * (1 + 2.0 ** -12), -(2.0 ** -24) * (1 + 2.0 ** -12)])
    b = np.float32([1 - 2.0 ** -12 + 2.0 ** -24] * 2)
    c = np.float32([1.0, 1 + 2.0 ** -22])
    got = cvops._fma32(a, b, c)
    np.testing.assert_array_equal(got, np.float32([1 + 2.0 ** -23, 1 + 2.0 ** -23]))


def test_rotate_flip_rodrigues():
    rng = np.random.default_rng(RNG_SEED)
    img = rng.integers(0, 65535, (12, 17)).astype(np.uint16)
    for code in (cv2.ROTATE_90_CLOCKWISE, cv2.ROTATE_90_COUNTERCLOCKWISE, cv2.ROTATE_180):
        np.testing.assert_array_equal(cvops.rotate(img, code), cv2.rotate(img, code))
    np.testing.assert_array_equal(cvops.flip(img, 0), cv2.flip(img, 0))
    for rv in ([0.3, -1.2, 2.1], [0.0, 0.0, np.pi / 2], [1e-9, 0, 0], [0.0, 0.0, 0.0]):
        np.testing.assert_allclose(cvops.rodrigues(rv), cv2.Rodrigues(np.array(rv))[0],
                                   rtol=0, atol=1e-12)


K_MEGADEPTH = np.array([[120.0, 0, 80.3], [0, 120.0, 59.7], [0, 0, 1]])


@pytest.mark.parametrize("dist", [(-0.05, 0, 0, 0), (0.03, 0, 0, 0),
                                  (-0.2, 0.05, 0.001, -0.0015)])
@pytest.mark.parametrize("alpha", [0, 1, 0.3])
def test_get_optimal_new_camera_matrix(dist, alpha):
    """MegaDepth's call (alpha 0, centred principal point) and ScanNet++'s
    (alpha 1, centred)."""
    for new_size in ((160, 120), (80, 60)):
        ref = cv2.getOptimalNewCameraMatrix(K_MEGADEPTH, np.array(dist), (160, 120), alpha,
                                            new_size, True)[0]
        got = cvops.get_optimal_new_camera_matrix(K_MEGADEPTH, dist, (160, 120), alpha,
                                                  new_size)
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


def test_undistortion_maps():
    """ScanNet++'s pinhole and fisheye undistortion, as its script chains
    them: the new camera matrix, then the maps (within 1e-4 px)."""
    W, H = 175, 117
    K = np.array([[160.0, 0, 88.2], [0, 158.0, 57.9], [0, 0, 1]])
    d = np.array([-0.2, 0.05, 0.001, -0.0015])
    newK = cv2.getOptimalNewCameraMatrix(K, d, (W, H), 1, (W, H), True)[0]
    ref = cv2.initUndistortRectifyMap(K, d, np.eye(3), newK, (W, H), cv2.CV_32FC1)
    got = cvops.init_undistort_rectify_map(K, d, newK, (W, H))
    for g, r in zip(got, ref):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4)

    Kf = np.array([[130.0, 0, 87.6], [0, 131.0, 58.4], [0, 0, 1]])
    df = np.array([0.05, -0.02, 0.004, -0.001])
    for balance in (0.0, 0.5, 1.0):
        ref_K = cv2.fisheye.estimateNewCameraMatrixForUndistortRectify(Kf, df, (W, H), np.eye(3),
                                                                       balance=balance)
        got_K = cvops.fisheye_estimate_new_camera_matrix(Kf, df, (W, H), balance=balance)
        np.testing.assert_allclose(got_K, ref_K, rtol=1e-6, atol=1e-6 * np.abs(ref_K).max())
    ref_K[0, 2], ref_K[1, 2] = W / 2, H / 2
    ref = cv2.fisheye.initUndistortRectifyMap(Kf, df, np.eye(3), ref_K, (W, H), cv2.CV_32FC1)
    got = cvops.fisheye_init_undistort_rectify_map(Kf, df, ref_K, (W, H))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4)


def test_imwrite_png_and_jpeg(tmp_path):
    rng = np.random.default_rng(RNG_SEED)
    cases = dict(gray=rng.integers(0, 256, (30, 41)).astype(np.uint8),
                 bgr=rng.integers(0, 256, (30, 41, 3)).astype(np.uint8),
                 depth=rng.integers(0, 65535, (30, 41)).astype(np.uint16))
    for name, img in cases.items():
        ours, theirs = str(tmp_path / f"{name}_ours.png"), str(tmp_path / f"{name}_cv2.png")
        assert cvops.imwrite(ours, img)
        cv2.imwrite(theirs, img)
        a = cv2.imread(ours, cv2.IMREAD_UNCHANGED)
        b = cv2.imread(theirs, cv2.IMREAD_UNCHANGED)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # a photo-like JPEG: smooth gradients and edges
    y, x = np.mgrid[0:96, 0:128]
    photo = np.stack([x * 2, y * 2, (x + y) % 64 * 4], -1).astype(np.uint8)
    ours, theirs = str(tmp_path / "ours.jpg"), str(tmp_path / "cv2.jpg")
    cvops.imwrite(ours, photo)
    cv2.imwrite(theirs, photo)
    diff = np.abs(cv2.imread(ours).astype(int) - cv2.imread(theirs).astype(int))
    print(f"JPEG q95, PIL vs cv2.imwrite decoded: max {diff.max()}, mean {diff.mean():.4f}")
    assert diff.max() == 0
