"""Scene export helpers and the sky mask, on the host (numpy and scipy).

Counterpart of the parts of `dust3r_tpu/viz.py` that the demo reaches:
`segment_sky` (the reference's HSV heuristic, dust3r/viz.py:345-381, with
OpenCV's uint8 colour conversion reproduced in integer arithmetic, since
the card's machine has no cv2), `uint8`, the camera colours and the OpenGL
flip, and the mesh and frustum builders of the GLB export
(`pts3d_to_trimesh`, `cat_meshes`, `add_scene_cam`; the last needs
`trimesh`, imported when it is called).
"""
from __future__ import annotations

import numpy as np

from .utils.geometry import geotrf

OPENGL = np.array([[1, 0, 0, 0],
                   [0, -1, 0, 0],
                   [0, 0, -1, 0],
                   [0, 0, 0, 1]])

CAM_COLORS = [(255, 0, 0), (0, 0, 255), (0, 255, 0), (255, 0, 255),
              (255, 204, 0), (0, 204, 204), (128, 255, 255), (255, 128, 255),
              (255, 255, 128), (0, 0, 0), (128, 128, 128)]

# OpenCV's fixed-point colour conversion (imgproc/src/color_hsv: RGB2HSV_b)
HSV_SHIFT = 12
_I = np.arange(1, 256, dtype=np.float64)
SDIV = np.concatenate([[0], np.rint((255 << HSV_SHIFT) / _I)]).astype(np.int32)
HDIV180 = np.concatenate([[0], np.rint((180 << HSV_SHIFT) / (6.0 * _I))]).astype(np.int32)


def uint8(colors):
    colors = np.asarray(colors)
    if np.issubdtype(colors.dtype, np.floating):
        colors = colors * 255
    assert 0 <= colors.min() and colors.max() < 256
    return np.uint8(colors)


def bgr_to_hsv(image):
    """`cv2.cvtColor(image, cv2.COLOR_BGR2HSV)` on a uint8 (..., 3) array,
    bit for bit: V = max, S = round(255 (V - min) / V) and H in [0, 180)
    through OpenCV's tables of 2^12-scaled reciprocals (`sdiv`,
    `hdiv180`), with its rounding shifts."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.shape[-1] != 3:
        raise ValueError(f"expected uint8 (..., 3), got {image.dtype} {image.shape}")
    b, g, r = (image[..., c].astype(np.int32) for c in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (HSV_SHIFT - 1)
    s = (diff * SDIV[v] + half) >> HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * HDIV180[diff] + half) >> HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


# HSV2RGB's sectors: the (b, g, r) entries of (v, p, q, t) for each sixth
_HSV_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])
# cv2's uint8 HSV2RGB runs blocks of 2 vectors of fp32 lanes a row and a
# scalar loop over the rest; the blocks truncate, the loop rounds. Its lanes
# are its CPU dispatch's: 16 with AVX-512 (blocks of 32 pixels), 8 with AVX2
CV2_HSV_BLOCK = 32


def hsv_to_bgr(hsv):
    """`cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)` on a uint8 (H, W, 3) image
    (hue in [0, 180)), bit for bit: OpenCV's float path (s and v scaled by
    1/255 in fp32, h by 6/180, the sector by truncation, its fused
    multiply-adds 1 - s·h and 1 - s·(1 - h) rounded once, here from an
    exact fp64 product), then ×255 and saturated to uint8: truncated in the
    first W - W mod CV2_HSV_BLOCK pixels of each row (cv2's vector blocks),
    rounded half to even in the rest (its scalar loop)."""
    hsv = np.asarray(hsv)
    if hsv.dtype != np.uint8 or hsv.ndim < 2 or hsv.shape[-1] != 3:
        raise ValueError(f"expected uint8 (..., W, 3), got {hsv.dtype} {hsv.shape}")
    f32 = np.float32
    h = hsv[..., 0].astype(f32) * f32(6.0 / 180.0)
    s = hsv[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = hsv[..., 2].astype(f32) * f32(1.0 / 255.0)
    pre = np.trunc(h)
    h = h - pre
    sector = (pre - np.trunc(pre * f32(1.0 / 6.0)) * f32(6.0)).astype(np.int64)

    def fms(a, b):  # fma(-a, b, 1): one rounding of the exact 1 - a*b
        return (1.0 - a.astype(np.float64) * b.astype(np.float64)).astype(f32)

    tab = np.stack([v, v * (f32(1.0) - s), v * fms(s, h), v * fms(s, f32(1.0) - h)], -1)
    bgr = np.take_along_axis(tab, _HSV_SECTORS[sector], -1) * f32(255.0)
    width = hsv.shape[-2]
    blocked = (np.arange(width) < width - width % CV2_HSV_BLOCK)[:, None]
    return np.clip(np.where(blocked, np.trunc(bgr), np.rint(bgr)), 0, 255).astype(np.uint8)


def segment_sky(image):
    """Heuristic HSV sky mask (reference viz.py:345-381): an RGB image fed
    to the BGR conversion (the reference's quirk), bright low-saturation or
    low-hue pixels, a 5x5 opening, then every 8-connected component larger
    than half the largest."""
    from scipy import ndimage

    image = np.asarray(image)
    if np.issubdtype(image.dtype, np.floating):
        image = np.uint8(255 * image.clip(0, 1))
    hsv = bgr_to_hsv(image)
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    mask = (h <= 30) & (v >= 100)  # cv2.inRange(hsv, (0, 0, 100), (30, 255, 255))
    mask |= (s < 10) & (v > 150)
    mask |= (s < 30) & (v > 180)
    mask |= (s < 50) & (v > 220)

    mask2 = ndimage.binary_opening(mask, structure=np.ones((5, 5), np.uint8))
    labels, n = ndimage.label(mask2, structure=np.ones((3, 3), int))
    sizes = np.bincount(labels.ravel(), minlength=n + 1)[1:]
    if n == 0:
        return np.zeros(labels.shape, bool)
    selection = 1 + np.flatnonzero(sizes > sizes.max() / 2)
    return np.isin(labels, selection)


def pts3d_to_trimesh(img, pts3d, valid=None):
    """Pointmap -> per-pixel-quad mesh dict (2 double-sided triangles a
    pixel)."""
    H, W, THREE = img.shape
    assert THREE == 3 and img.shape == pts3d.shape
    vertices = np.asarray(pts3d).reshape(-1, 3)
    idx = np.arange(len(vertices)).reshape(H, W)
    tl, tr = idx[:-1, :-1].ravel(), idx[:-1, 1:].ravel()
    bl, br = idx[1:, :-1].ravel(), idx[1:, 1:].ravel()
    faces = np.concatenate([np.c_[tl, tr, bl], np.c_[bl, tr, tl],
                            np.c_[tr, bl, br], np.c_[br, bl, tr]], axis=0)
    face_colors = np.concatenate([img[:-1, :-1].reshape(-1, 3), img[:-1, :-1].reshape(-1, 3),
                                  img[1:, 1:].reshape(-1, 3), img[1:, 1:].reshape(-1, 3)],
                                 axis=0)
    if valid is not None:
        assert valid.shape == (H, W)
        ok = valid.ravel()[faces].all(axis=-1)
        faces, face_colors = faces[ok], face_colors[ok]
    return dict(vertices=vertices, face_colors=face_colors, faces=faces)


def cat_meshes(meshes):
    vertices, faces, colors = zip(*[(m["vertices"], m["faces"], m["face_colors"])
                                    for m in meshes])
    offsets = np.cumsum([0] + [len(v) for v in vertices])
    return dict(vertices=np.concatenate(vertices), face_colors=np.concatenate(colors),
                faces=np.concatenate([f + off for f, off in zip(faces, offsets)]))


def _rotz(deg):
    c, s = np.cos(np.deg2rad(deg)), np.sin(np.deg2rad(deg))
    m = np.eye(4)
    m[:2, :2] = [[c, -s], [s, c]]
    return m


def add_scene_cam(scene, pose_c2w, edge_color, image=None, focal=None, imsize=None,
                  screen_width=0.03):
    """Add a camera frustum (and its image, when given) to a trimesh
    scene."""
    import trimesh
    import PIL.Image

    if image is not None:
        image = np.asarray(image)
        H, W, THREE = image.shape
        if image.dtype != np.uint8:
            image = np.uint8(255 * image)
    elif imsize is not None:
        W, H = imsize
    elif focal is not None:
        H = W = focal / 1.1
    else:
        H = W = 1
    if isinstance(focal, np.ndarray):
        focal = float(focal.reshape(-1)[0])
    if not focal:
        focal = min(H, W) * 1.1

    height = max(screen_width / 10, focal * screen_width / H)
    width = screen_width * 0.5 ** 0.5
    rot45 = _rotz(45)
    rot45[2, 3] = -height  # cone tip at the optical centre
    aspect_ratio = np.eye(4)
    aspect_ratio[0, 0] = W / H
    transform = np.asarray(pose_c2w) @ OPENGL @ aspect_ratio @ rot45
    cam = trimesh.creation.cone(width, height, sections=4)

    if image is not None:
        vertices = geotrf(transform, cam.vertices[[4, 5, 1, 3]])
        faces = np.array([[0, 1, 2], [0, 2, 3], [2, 1, 0], [3, 2, 0]])
        img_mesh = trimesh.Trimesh(vertices=vertices, faces=faces)
        uv = np.float32([[0, 0], [1, 0], [1, 1], [0, 1]])
        img_mesh.visual = trimesh.visual.TextureVisuals(uv, image=PIL.Image.fromarray(image))
        scene.add_geometry(img_mesh)

    # a wireframe-like frustum from three slightly offset cones
    vertices = np.r_[cam.vertices, 0.95 * cam.vertices, geotrf(_rotz(2), cam.vertices)]
    vertices = geotrf(transform, vertices)
    faces = []
    n = len(cam.vertices)
    for face in cam.faces:
        if 0 in face:
            continue
        a, b, c = face
        a2, b2, c2 = face + n
        a3, b3, c3 = face + 2 * n
        faces += [(a, b, b2), (a, a2, c), (c2, b, c), (a, b, b3), (a, a3, c), (c3, b, c)]
    faces += [(c, b, a) for a, b, c in faces]  # no culling
    frustum = trimesh.Trimesh(vertices=vertices, faces=faces)
    frustum.visual.face_colors[:, :3] = edge_color
    scene.add_geometry(frustum)
