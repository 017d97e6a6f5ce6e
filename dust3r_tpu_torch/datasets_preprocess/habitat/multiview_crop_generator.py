"""Perspective crops out of habitat equirectangular environment maps.

Counterpart of `datasets_preprocess/habitat/multiview_crop_generator.py`:
render one envmap per viewpoint, then cut arbitrarily oriented pinhole
views out of it by remapping (`utils/cvops.remap`, with subpixel jitter
averaging). The envmaps come from a renderer object: habitat-sim's
(`HabitatEnvironmentMapRenderer`, an optional package, imported when it is
built) unless another with the same methods is given, so
`extract_cropped_camera` runs on any colour and distance map.
"""
import collections

import numpy as np

from . import projections

ViewpointData = collections.namedtuple(
    "ViewpointData", ["colormap", "distancemap", "pointmap", "position"])


def _remap(remapper, image, nearest, single_map):
    return remapper.convert(
        image,
        interpolation=projections.cvops.INTER_NEAREST if nearest
        else projections.cvops.INTER_LINEAR,
        borderMode=projections.cvops.BORDER_WRAP, single_map=single_map)


class HabitatMultiviewCrops:
    """One habitat scene -> low-res envmaps at sampled positions -> cropped
    pinhole (color, depth, pointmap) tuples.

    renderer: an envmap renderer (equirectangular_resolution,
    R_cam_to_world(), up_direction(), render_viewpoint(position)); None
    builds habitat-sim's. rng: the jitter's draws (anything with numpy's
    uniform(low, high, size)); None: numpy.random.default_rng(seed)."""

    def __init__(self, scene, navmesh, scene_dataset_config_file,
                 equirectangular_resolution=(400, 800),
                 crop_resolution=(240, 320), pixel_jittering_iterations=5,
                 jittering_noise_level=1.0, renderer=None, rng=None, seed=0):
        self.crop_resolution = crop_resolution
        self.jitter_iters = pixel_jittering_iterations
        self.jitter_noise = jittering_noise_level
        self.rng = np.random.default_rng(seed) if rng is None else rng

        if renderer is None:
            from .habitat_sim_envmaps_renderer import \
                HabitatEnvironmentMapRenderer  # optional dep (habitat-sim)

            renderer = HabitatEnvironmentMapRenderer(
                scene=scene, navmesh=navmesh,
                scene_dataset_config_file=scene_dataset_config_file,
                equirectangular_resolution=equirectangular_resolution,
                render_depth=True, render_equirectangular=True)
        self.lowres_envmap_renderer = renderer
        self.R_cam_to_world = np.asarray(renderer.R_cam_to_world())
        self.up_direction = np.asarray(renderer.up_direction())

        h, w = renderer.equirectangular_resolution
        self.envmap_height, self.envmap_width = h, w
        self.envmap_projection = projections.RotatedProjection(
            projections.EquirectangularProjection(h, w),
            self.R_cam_to_world.T)
        # world-frame unit rays per envmap pixel, reused for every viewpoint:
        # pointmap = position + ray * distance
        self.envmap_rays = projections.get_projection_rays(
            self.envmap_projection)

    def render_viewpoint_data(self, position):
        obs = self.lowres_envmap_renderer.render_viewpoint(
            np.asarray(position))["observations"]
        distancemap = obs["depth_equirectangular"]
        return ViewpointData(
            colormap=obs["color_equirectangular"][..., :3],
            distancemap=distancemap,
            pointmap=self.envmap_rays * distancemap[:, :, None] + position,
            position=position)

    def extract_cropped_camera(self, projection, color_image, distancemap,
                               pointmap, voxelmap=None):
        remapper = projections.RemapProjection(
            input_projection=self.envmap_projection,
            output_projection=projection,
            pixel_jittering_iterations=self.jitter_iters,
            jittering_noise_level=self.jitter_noise, rng=self.rng)
        color = _remap(remapper, color_image, nearest=False,
                       single_map=False)
        dist = _remap(remapper, distancemap, nearest=True, single_map=True)
        pts = _remap(remapper, pointmap, nearest=True, single_map=True)
        vox = None if voxelmap is None else _remap(
            remapper, voxelmap, nearest=True, single_map=True)
        # habitat returns distance along the ray; convert to planar z-depth
        ray_len = np.linalg.norm(remapper.output_rays, axis=-1)
        return color, np.asarray(dist / ray_len, dtype=dist.dtype), pts, vox


# (de)serialization of a rotated pinhole camera for the metadata json

def perspective_projection_to_dict(persp_projection, position):
    base = persp_projection.base_projection
    return dict(
        camera_intrinsics=projections.colmap_to_opencv_intrinsics(
            base.K).tolist(),
        size=(base.width, base.height),
        R_cam2world=persp_projection.R_to_base_projection.T.tolist(),
        t_cam2world=position)


def dict_to_perspective_projection(camera_params):
    K = projections.opencv_to_colmap_intrinsics(
        np.asarray(camera_params["camera_intrinsics"]))
    w, h = camera_params["size"]
    R = np.asarray(camera_params["R_cam2world"])
    projection = projections.RotatedProjection(
        projections.PerspectiveProjection(K, height=h, width=w),
        R_to_base_projection=R.T)
    return projection, camera_params["t_cam2world"]
