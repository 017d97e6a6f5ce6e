"""Synthetic visual-localization scenes with a known answer, written as a
COLMAP text map, images and a pairsfile, and an oracle engine that returns
each pair's exact pointmaps.

The world is a textured height field Z = h(X, Y) (sinusoidal relief, or an
exact plane), seen from cameras at Z ~ -depth looking along +Z with small
seeded rotations. A scene is written to a directory:

    images/map/m<k>.jpg, images/query/q<k>.jpg   renders of the texture
    sfm/cameras.txt, images.txt, points3D.txt    the map: one observation
                                                 and one 3D point at each
                                                 pixel of each map image's
                                                 bucket grid, so that the
                                                 map is dense at the
                                                 network's resolution
    pairsfile.txt                                every query against every
                                                 map image (topk picks)

`SyntheticColmapDataset` reads it through the port's
`BaseVislocColmapDataset` (COLMAP parsing, pairsfile, map views) and
builds its query views through the same `_query_view` the kapture path
uses, from the cameras the scene holds. `OracleEngine` stands in for the
network: for a (query, map) pair it ray-casts the surface at the rescaled
pixels of both views (through the query's distortion) and returns the two
pointmaps in the query's camera frame, as `tests/test_visloc_colmap_e2e.py`
builds them for its plane.
"""
from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass

import numpy as np

from ..visloc.datasets.base_colmap import BaseVislocColmapDataset, get_ordered_pairs_from_file
from ..visloc.utils import get_HW_resolution, get_resize_function

TILT_DEG = 5.0  # camera rotations up to this angle
RENDER_SCALE = 4  # images: the texture rendered at 1/RENDER_SCALE, then resized up


@dataclass
class SceneSpec:
    """A scene's cameras and surface. `query_model` is SIMPLE_RADIAL
    (k1 = query_k1) or SIMPLE_PINHOLE; map cameras are PINHOLE. Sizes are
    (W, H); focals in pixels; relief in scene units (0: the plane Z = 0)."""
    name: str
    map_size: tuple
    query_size: tuple
    map_focal: float
    query_focal: float
    n_maps: int = 2
    n_queries: int = 1
    query_model: str = "SIMPLE_PINHOLE"
    query_k1: float = 0.0
    relief: float = 0.3
    depth: float = 8.0
    spread: float = 1.0  # camera centres within +-spread in X and Y
    maxdim: int = 512


@dataclass
class Camera:
    name: str
    size: tuple  # (W, H)
    focal: float
    k1: float
    c2w: np.ndarray  # 4x4 float64
    model: str = "PINHOLE"

    def colmap_params(self):
        W, H = self.size
        if self.model == "PINHOLE":
            return (W, H, self.focal, self.focal, W / 2, H / 2)
        if self.model == "SIMPLE_RADIAL":
            return (W, H, self.focal, W / 2, H / 2, self.k1)
        return (W, H, self.focal, W / 2, H / 2)

    def rays(self, px):
        """World-frame ray directions (n, 3) through OpenCV-convention
        pixels px (n, 2) of the (distorted) image, the radial model
        inverted to convergence."""
        W, H = self.size
        xd = (px - (np.array([W / 2, H / 2]) - 0.5)) / self.focal
        xn = xd.copy()
        for _ in range(50 if self.k1 else 0):
            xn = xd / (1 + self.k1 * (xn ** 2).sum(-1, keepdims=True))
        return np.concatenate([xn, np.ones((len(xn), 1))], -1) @ self.c2w[:3, :3].T


def _rotation(rng, max_deg):
    w = rng.normal(size=3)
    w *= np.radians(rng.uniform(0, max_deg)) / np.linalg.norm(w)
    theta = np.linalg.norm(w)
    k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / max(theta, 1e-12)
    return np.eye(3) + np.sin(theta) * k + (1 - np.cos(theta)) * k @ k


class Surface:
    """Z = relief * (sin(a X + p) cos(b Y + q) + 0.5 sin(c X + d Y)), with a
    texture of seeded sinusoids in X and Y."""

    def __init__(self, relief, rng):
        self.relief = relief
        self.freq = rng.uniform(0.8, 1.3, 4)
        self.phase = rng.uniform(0, 2 * np.pi, 2)
        self.tex = rng.uniform(1, 9, (3, 4, 2)), rng.uniform(0, 2 * np.pi, (3, 4))

    def height(self, X, Y):
        a, b, c, d = self.freq
        p, q = self.phase
        h = np.sin(a * X + p) * np.cos(b * Y + q) + 0.5 * np.sin(c * X + d * Y)
        hx = a * np.cos(a * X + p) * np.cos(b * Y + q) + 0.5 * c * np.cos(c * X + d * Y)
        hy = -b * np.sin(a * X + p) * np.sin(b * Y + q) + 0.5 * d * np.cos(c * X + d * Y)
        return self.relief * h, self.relief * hx, self.relief * hy

    def cast(self, C, d):
        """World points where rays C + s d (d (n, 3)) meet the surface:
        Newton on s from the plane Z = 0 (the rays' slopes and the relief's
        keep the root unique)."""
        s = -C[2] / d[:, 2]
        for _ in range(8 if self.relief else 0):
            P = C + s[:, None] * d
            h, hx, hy = self.height(P[:, 0], P[:, 1])
            s = s - (P[:, 2] - h) / (d[:, 2] - hx * d[:, 0] - hy * d[:, 1])
        return C + s[:, None] * d

    def colour(self, P):
        freq, phase = self.tex
        out = 128 + sum(30 * np.sin(freq[:, k, :1] * P[:, 0] + freq[:, k, 1:] * P[:, 1]
                                    + phase[:, k:k + 1]) for k in range(4))
        return np.clip(out.T, 0, 255).astype(np.uint8)


def _rescaled_pixels(cam, maxdim):
    """OpenCV-convention pixels of the original image at the centres of
    its bucket grid's pixels, (HR * WR, 2) in row-major order, and (HR, WR)."""
    W, H = cam.size
    _, to_resize, to_orig = get_resize_function(maxdim, 16, H, W)
    HR, WR = (H, W) if (to_resize == np.eye(3)).all() else get_HW_resolution(H, W, maxdim)
    jj, ii = np.meshgrid(np.arange(WR, dtype=np.float64), np.arange(HR, dtype=np.float64))
    colmap = np.stack([jj.ravel() + 0.5, ii.ravel() + 0.5, np.ones(HR * WR)], -1) @ to_orig.T
    return colmap[:, :2] / colmap[:, 2:] - 0.5, (HR, WR)


def write_scene(root, spec, seed=0):
    """Write `spec`'s scene under `root`; returns {camera name: Camera}
    (the queries' and the map's), the surface, and the query names."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    surface = Surface(spec.relief, rng)
    cams = {}
    for kind, n, size, focal in (("map", spec.n_maps, spec.map_size, spec.map_focal),
                                 ("query", spec.n_queries, spec.query_size, spec.query_focal)):
        for k in range(n):
            c2w = np.eye(4)
            c2w[:3, :3] = _rotation(rng, TILT_DEG)
            c2w[:3, 3] = [*rng.uniform(-spec.spread, spec.spread, 2),
                          -spec.depth * rng.uniform(0.9, 1.1)]
            model = "PINHOLE" if kind == "map" else spec.query_model
            cams[f"{kind}/{kind[0]}{k}.jpg"] = Camera(
                f"{kind}/{kind[0]}{k}.jpg", size, focal, spec.query_k1 if kind == "query" else 0.0,
                c2w, model)
    os.makedirs(os.path.join(root, "images", "map"), exist_ok=True)
    os.makedirs(os.path.join(root, "images", "query"), exist_ok=True)
    os.makedirs(os.path.join(root, "sfm"), exist_ok=True)
    for cam in cams.values():  # the texture at 1/RENDER_SCALE, resized up
        W, H = cam.size
        w, h = W // RENDER_SCALE, H // RENDER_SCALE
        v, u = np.mgrid[:h, :w].astype(np.float64)
        px = np.stack([(u.ravel() + 0.5) * W / w - 0.5, (v.ravel() + 0.5) * H / h - 0.5], -1)
        P = surface.cast(cam.c2w[:3, 3], cam.rays(px))
        img = Image.fromarray(surface.colour(P).reshape(h, w, 3)).resize((W, H), Image.BILINEAR)
        img.save(os.path.join(root, "images", cam.name), quality=95)

    maps = [c for n, c in cams.items() if n.startswith("map/")]
    queries = [c for n, c in cams.items() if n.startswith("query/")]
    with open(os.path.join(root, "sfm", "cameras.txt"), "w") as f:
        f.write("# CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for k, cam in enumerate(maps, 1):
            f.write(f"{k} PINHOLE " + " ".join(f"{p:.17g}" for p in cam.colmap_params()) + "\n")
    pid = 0
    with open(os.path.join(root, "sfm", "images.txt"), "w") as fi, \
            open(os.path.join(root, "sfm", "points3D.txt"), "w") as fp:
        fi.write("# IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        fp.write("# POINT3D_ID, X, Y, Z, R, G, B, ERROR\n")
        for k, cam in enumerate(maps, 1):
            px, _ = _rescaled_pixels(cam, spec.maxdim)
            P = surface.cast(cam.c2w[:3, 3], cam.rays(px))
            w2c = np.linalg.inv(cam.c2w)
            qw, qx, qy, qz = _rotmat_to_wxyz(w2c[:3, :3])
            fi.write(f"{k} {qw:.17g} {qx:.17g} {qy:.17g} {qz:.17g} "
                     + " ".join(f"{v:.17g}" for v in w2c[:3, 3]) + f" {k} {cam.name}\n")
            ids = np.arange(pid + 1, pid + 1 + len(px))
            pid += len(px)
            obs = np.empty((len(px), 3), object)
            obs[:, 0] = [f"{v:.6f}" for v in px[:, 0] + 0.5]  # colmap = cv2 + 0.5
            obs[:, 1] = [f"{v:.6f}" for v in px[:, 1] + 0.5]
            obs[:, 2] = ids.astype(str)
            fi.write(" ".join(obs.ravel().tolist()) + "\n")
            fp.write("".join(f"{i} {x:.9g} {y:.9g} {z:.9g} 128 128 128 0\n"
                             for i, (x, y, z) in zip(ids.tolist(), P.tolist())))
    with open(os.path.join(root, "pairsfile.txt"), "w") as f:
        for q in queries:
            # the map images nearest the query first
            dist = [np.linalg.norm(m.c2w[:3, 3] - q.c2w[:3, 3]) for m in maps]
            for rank, m in enumerate(np.argsort(dist)):
                f.write(f"{q.name} {maps[m].name} {len(maps) - rank}\n")
    return cams, surface, [q.name for q in queries]


def _rotmat_to_wxyz(R):
    """Unit quaternion (w, x, y, z) of a rotation matrix, float64."""
    from ..utils.pose import rotmat_to_quat

    x, y, z, w = rotmat_to_quat(R)
    return w, x, y, z


class SyntheticColmapDataset(BaseVislocColmapDataset):
    """A written scene through the port's COLMAP dataset, its queries taken
    from `cams` (no kapture)."""

    def __init__(self, root, cams, queries, topk=2):
        self.maxdim = None
        self.patch_size = None
        self.topk = topk
        self.num_views = topk + 1
        self.image_path = os.path.join(root, "images")
        self.cache_sfm = False
        self._load_sfm(os.path.join(root, "sfm"))
        self.pairs = get_ordered_pairs_from_file(os.path.join(root, "pairsfile.txt"))
        self.scenes = list(queries)
        self.cams = cams

    def _get_view_query(self, imgname):
        cam = self.cams[imgname]
        return self._query_view(imgname, cam.model, cam.colmap_params(), cam.c2w)


def _key(img):
    return hashlib.md5(np.ascontiguousarray(img, np.float32).tobytes()).hexdigest()


class OracleEngine:
    """Stands in for the network in `inference([pair], engine)`: the exact
    pointmaps of the pair's (query, map) views, confidence 10, both in the
    query's camera frame, at the views' rescaled size. Views are known by
    the hash of their rescaled image; `register(dataset)` hashes each
    camera's rescaled image as the dataset makes it."""

    def __init__(self, cams, surface, maxdim=512):
        self.cams = cams
        self.surface = surface
        self.maxdim = maxdim
        self.by_key = {}
        self.world = {}  # camera name -> its rescaled pixels' world points, (HR, WR)

    def register(self, dataset):
        from PIL import Image

        from ..datasets.utils.transforms import ImgNorm

        for name, cam in self.cams.items():
            W, H = cam.size
            rgb = Image.open(os.path.join(dataset.image_path, name)).convert("RGB")
            resize = get_resize_function(self.maxdim, 16, H, W)[0]
            self.by_key[_key(resize(ImgNorm(rgb)))] = cam

    def points(self, cam, ref):
        """(HR, WR, 3) points of `cam`'s rescaled pixels in `ref`'s frame."""
        if cam.name not in self.world:
            px, hw = _rescaled_pixels(cam, self.maxdim)
            self.world[cam.name] = self.surface.cast(cam.c2w[:3, 3], cam.rays(px)), hw
        P, (HR, WR) = self.world[cam.name]
        w2c = np.linalg.inv(ref.c2w)
        return (P @ w2c[:3, :3].T + w2c[:3, 3]).reshape(HR, WR, 3).astype(np.float32)

    def infer_pairs(self, pairs, verbose=False):
        (v1, v2), = pairs
        q = self.by_key[_key(np.asarray(v1["img"])[0])]
        m = self.by_key[_key(np.asarray(v2["img"])[0])]
        p1, p2 = self.points(q, q), self.points(m, q)
        return dict(view1=v1, view2=v2,
                    pred1=dict(pts3d=p1[None], conf=np.full((1,) + p1.shape[:2], 10, np.float32)),
                    pred2=dict(pts3d_in_other_view=p2[None],
                               conf=np.full((1,) + p2.shape[:2], 10, np.float32)))


# the chip smoke's scenes: Cambridge Landmarks' 1920x1080 frames (the
# 512x288 bucket) with SIMPLE_RADIAL queries, InLoc's portrait queries
# against landscape maps (the 384x512 and 512x384 grids), and an exact plane
SCENES = (
    SceneSpec("cambridge", (1920, 1080), (1920, 1080), 1600.0, 1650.0, n_maps=2, n_queries=2,
              query_model="SIMPLE_RADIAL", query_k1=-0.04),
    SceneSpec("inloc", (1600, 1200), (1200, 1600), 1300.0, 1400.0, n_maps=2, n_queries=2),
    SceneSpec("plane", (1920, 1080), (1920, 1080), 1600.0, 1650.0, n_maps=2, n_queries=1,
              query_model="SIMPLE_RADIAL", query_k1=-0.04, relief=0.0),
)


def synthetic_dataset(root, name="plane", seed=0, topk=2):
    """Write the scene `name` of `SCENES` under `root` and return its
    `SyntheticColmapDataset`: a `--dataset` for the visloc CLI,
    `python -m dust3r_tpu_torch.visloc --dataset "__import__('dust3r_tpu_torch.tools.
    visloc_scenes', fromlist=['_']).synthetic_dataset('<dir>')" --weights ...`."""
    spec = next(s for s in SCENES if s.name == name)
    cams, _, queries = write_scene(root, spec, seed=seed)
    return SyntheticColmapDataset(root, cams, queries, topk=topk)
