"""The port's display helpers against the JAX package's, which run on cv2
and matplotlib here.

`bgr_to_hsv` is held to `cv2.cvtColor(..., COLOR_BGR2HSV)` on all 2^24
uint8 colours; `segment_sky` to `dust3r_tpu.viz.segment_sky` bit for bit on
seeded images (random, sky-banded, several equal components, float, dark);
`jet` to `matplotlib.pyplot.get_cmap("jet")` bit for bit on 10^5 seeded
values in [0, 1] with 0, 1 and every bin edge, out-of-range values and NaN;
`rgb`, `uint8` and the mesh builders of the export to their JAX versions
exactly.
"""
import cv2
import matplotlib.pyplot as pl
import numpy as np
import PIL.Image
import pytest

from dust3r_tpu import viz as jviz
from dust3r_tpu.utils import image as jimage
from dust3r_tpu_torch import viz
from dust3r_tpu_torch.utils import image


def test_hsv_is_cv2s_on_every_colour():
    code = np.arange(2 ** 24, dtype=np.uint32)
    img = np.stack([code >> 16, (code >> 8) & 255, code & 255], -1).astype(np.uint8)
    img = img.reshape(4096, 4096, 3)
    want = cv2.cvtColor(img, cv2.COLOR_BGR2HSV)
    got = viz.bgr_to_hsv(img)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    assert int(got[..., 0].max()) < 180


def _sky_image(rng, h=96, w=128):
    """Seeded clutter under a bright, low-saturation band, with a smaller
    bright patch below it."""
    img = rng.integers(0, 120, (h, w, 3), dtype=np.uint8)
    img[:h // 3] = np.clip(rng.normal((200, 210, 235), 6, (h // 3, w, 3)), 0, 255)
    img[h // 2:h // 2 + 12, 10:40] = 240
    return img


def _equal_blobs(h=64, w=96):
    """Two bright blocks of the same area and one of half it: the
    selection does not depend on label order."""
    img = np.zeros((h, w, 3), np.uint8)
    img[4:20, 4:28] = 230
    img[30:46, 60:84] = 230
    img[50:58, 8:32] = 230
    return img


IMAGES = {
    "random": lambda rng: rng.integers(0, 256, (96, 128, 3), dtype=np.uint8),
    "sky_band": _sky_image,
    "equal_blobs": lambda rng: _equal_blobs(),
    "float": lambda rng: _sky_image(rng).astype(np.float32) / 255 * 1.1 - 0.05,
    "dark": lambda rng: rng.integers(0, 60, (48, 64, 3), dtype=np.uint8),
}


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_segment_sky_is_the_jax_packages(name):
    rng = np.random.default_rng(sorted(IMAGES).index(name))
    img = IMAGES[name](rng)
    want = jviz.segment_sky(img)
    got = viz.segment_sky(img)
    assert got.dtype == bool and got.shape == img.shape[:2]
    np.testing.assert_array_equal(got, want)
    if name in ("sky_band", "float"):
        assert got[:10].mean() > 0.9 and not got[-10:].any()
    if name == "dark":
        assert not got.any()


def test_jet_is_matplotlibs():
    cmap = pl.get_cmap("jet")
    rng = np.random.default_rng(0)
    edges = np.arange(257) / 256
    for dtype in (np.float32, np.float64):
        x = np.concatenate([rng.random(10 ** 5), [0.0, 1.0], edges,
                            np.nextafter(edges, 2), np.nextafter(edges, -1)]).astype(dtype)
        assert np.array_equal(image.jet(x), cmap(x))
        two_d = x[:10 ** 4].reshape(100, 100)  # the demo's (H, W) maps
        assert np.array_equal(image.jet(two_d), cmap(two_d))
    odd = np.array([-0.5, 1.5, np.nan, -np.inf, np.inf])
    assert np.array_equal(image.jet(odd), cmap(odd), equal_nan=True)


def test_rgb_and_uint8_are_the_jax_packages(tmp_path):
    rng = np.random.default_rng(1)
    for arr in (rng.uniform(-1.2, 1.2, (5, 7, 3)).astype(np.float32),
                rng.uniform(-1, 1, (2, 5, 7, 3)),
                rng.uniform(-1, 1, (3, 5, 7)).astype(np.float32),
                rng.uniform(-1, 1, (2, 3, 5, 7)).astype(np.float32),
                rng.integers(0, 256, (5, 7, 3), dtype=np.uint8),
                rng.uniform(0, 1, (5, 7, 4))):
        got, want = image.rgb(arr), jimage.rgb(arr)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    pair = [rng.uniform(-1, 1, (4, 6, 3)).astype(np.float32) for _ in range(2)]
    for got, want in zip(image.rgb(pair, true_shape=(3, 5)), jimage.rgb(pair, true_shape=(3, 5))):
        assert np.array_equal(got, want)
    for colors in (rng.uniform(0, 1, (9, 3)), rng.integers(0, 256, (9, 3))):
        assert np.array_equal(viz.uint8(colors), jviz.uint8(colors))
    assert viz.CAM_COLORS == jviz.CAM_COLORS and np.array_equal(viz.OPENGL, jviz.OPENGL)
    path = str(tmp_path / "photo.png")
    PIL.Image.fromarray(rng.integers(0, 256, (5, 7, 3), dtype=np.uint8)).save(path)
    assert np.array_equal(image.img_to_arr(path), jimage.img_to_arr(path))
    assert image.img_to_arr(pair[0]) is pair[0]


def test_mesh_builders_are_the_jax_packages():
    rng = np.random.default_rng(2)
    meshes = []
    for k in range(2):
        img = rng.uniform(0, 1, (6, 8, 3))
        pts = rng.standard_normal((6, 8, 3))
        valid = rng.random((6, 8)) > 0.3
        got, want = viz.pts3d_to_trimesh(img, pts, valid), jviz.pts3d_to_trimesh(img, pts, valid)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
        meshes.append(want)
    got, want = viz.cat_meshes(meshes), jviz.cat_meshes(meshes)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
