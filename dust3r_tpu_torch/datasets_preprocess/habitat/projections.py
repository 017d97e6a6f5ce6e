"""Pixel <-> ray conversions for sampling virtual cameras from envmaps.

Counterpart of `datasets_preprocess/habitat/projections.py`. Axis
convention throughout: +X right, +Y down, +Z forward (OpenCV), with the
TOP-LEFT CORNER of the image at pixel coordinate (0, 0), i.e. pixel
centres at half-integers (OpenCV itself centres pixel (0, 0) at the
origin; `colmap_to_opencv_intrinsics` moves between the two).

The math lives in standalone ray/angle helpers; the three projection
objects share the `project(rays) -> (u, v)` / `unproject(u, v) -> rays`
protocol. The jittered maps draw their noise from an explicit generator
(anything with numpy's `uniform(low, high, size)`): a seeded
`numpy.random.Generator` by default, or a `numpy.random.RandomState` to
make the draws of the JAX script's global RNG. Resampling is
`utils/cvops.remap`.
"""
import numpy as np

from ...utils import cvops


def _unit(rays):
    return rays / np.linalg.norm(rays, axis=-1, keepdims=True)


def _spherical_to_rays(lon, lat_down):
    """Longitude (0 at +Z, increasing toward +X) and downward latitude
    (0 at the horizon, +pi/2 toward +Y) -> unit rays."""
    r = np.cos(lat_down)
    return np.stack([r * np.sin(lon), np.sin(lat_down), r * np.cos(lon)],
                    axis=-1)


def _rays_to_spherical(rays):
    rays = _unit(np.asarray(rays))
    lon = np.arctan2(rays[..., 0], rays[..., 2])
    lat_down = np.arcsin(rays[..., 1])
    return lon, lat_down


class EquirectangularProjection:
    """Full-sphere latitude/longitude map: u spans 360 deg of longitude,
    v spans 180 deg of latitude, both linearly."""

    def __init__(self, height, width):
        self.height = height
        self.width = width

    def unproject(self, u, v):
        lon = (np.asarray(u) / self.width - 0.5) * (2 * np.pi)
        lat_down = (np.asarray(v) / self.height - 0.5) * np.pi
        return _spherical_to_rays(lon, lat_down)

    def project(self, rays):
        lon, lat_down = _rays_to_spherical(rays)
        u = (lon / (2 * np.pi) + 0.5) * self.width
        v = (lat_down / np.pi + 0.5) * self.height
        return u, v


class PerspectiveProjection:
    """Pinhole camera with intrinsics K (COLMAP-style half-integer pixel
    centres, see the module docstring)."""

    def __init__(self, K, height, width):
        self.height = height
        self.width = width
        self.K = K
        self.Kinv = np.linalg.inv(K)

    def project(self, rays):
        pix = np.asarray(rays) @ self.K.T
        return pix[..., 0] / pix[..., 2], pix[..., 1] / pix[..., 2]

    def unproject(self, u, v):
        pix = np.stack((u, v, np.ones_like(u)), axis=-1)
        return pix @ self.Kinv.T


class RotatedProjection:
    """A base projection observed through a rotation: world rays are
    rotated into the base projection's frame before projecting (and back
    after unprojecting)."""

    def __init__(self, base_projection, R_to_base_projection):
        self.base_projection = base_projection
        self.R_to_base_projection = R_to_base_projection

    width = property(lambda self: self.base_projection.width)
    height = property(lambda self: self.base_projection.height)

    def project(self, rays):
        R = self.R_to_base_projection
        if R is not None:
            rays = np.asarray(rays) @ R.T
        return self.base_projection.project(rays)

    def unproject(self, u, v):
        rays = self.base_projection.unproject(u, v)
        R = self.R_to_base_projection
        if R is not None:
            rays = rays @ R  # == (R.T @ ray) row-wise
        return rays


def get_projection_rays(projection, noise_level=0, rng=None):
    """2D map of 3D rays through every pixel centre, with optional jitter
    drawn from `rng` (u's draw, then v's).

    The jitter expression keeps the reference's np.clip(0, noise, size)
    argument order (0 clamped elementwise into [noise, size], so a
    negative draw contributes exactly 0), for output parity."""
    grid_u, grid_v = np.meshgrid(0.5 + np.arange(projection.width),
                                 0.5 + np.arange(projection.height))
    if noise_level > 0:
        grid_u += np.clip(0, noise_level * rng.uniform(
            -0.5, 0.5, size=grid_u.shape), projection.width)
        grid_v += np.clip(0, noise_level * rng.uniform(
            -0.5, 0.5, size=grid_v.shape), projection.height)
    return projection.unproject(grid_u, grid_v)


def compute_camera_intrinsics(height, width, hfov):
    focal = width / (2 * np.tan(np.radians(hfov) / 2))
    return focal, width / 2, height / 2


def colmap_to_opencv_intrinsics(K):
    """Half-integer-centred pp (COLMAP) -> integer-centred (OpenCV)."""
    K = K.copy()
    K[:2, 2] -= 0.5
    return K


def opencv_to_colmap_intrinsics(K):
    K = K.copy()
    K[:2, 2] += 0.5
    return K


class RemapProjection:
    """Resampling from one projection to another (`cvops.remap`), with
    optional multi-tap pixel jittering for anti-aliasing (the jittered
    maps are averaged); the jitter draws from `rng` (a seeded Generator
    where None)."""

    def __init__(self, input_projection, output_projection,
                 pixel_jittering_iterations=0, jittering_noise_level=0, rng=None):
        assert jittering_noise_level >= 0
        assert pixel_jittering_iterations >= 0
        rng = np.random.default_rng(0) if rng is None else rng
        self.output_rays = get_projection_rays(output_projection)
        taps = [self.output_rays]
        taps += [get_projection_rays(output_projection, jittering_noise_level, rng)
                 for _ in range(pixel_jittering_iterations)]
        self.maps = []
        for rays in taps:
            map_u, map_v = input_projection.project(rays)
            self.maps.append((np.float32(map_u), np.float32(map_v)))

    def convert(self, img, interpolation=None, borderMode=None,
                single_map=False):
        if interpolation is None:
            interpolation = cvops.INTER_LINEAR
        if borderMode is None:
            borderMode = cvops.BORDER_WRAP
        maps = self.maps[:1] if single_map else self.maps
        taps = [cvops.remap(img, mu, mv, interpolation, borderMode) for mu, mv in maps]
        if len(taps) == 1:
            return taps[0]
        return np.asarray(np.mean(taps, axis=0), dtype=img.dtype)
