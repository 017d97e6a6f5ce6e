"""Render equirectangular environment maps with habitat-sim (optional dep).

Counterpart of `datasets_preprocess/habitat/habitat_sim_envmaps_renderer.py`
(numpy, habitat_sim imported where the simulator is built): equirectangular color
(+ optional depth) sensors, optional 6-face cubemap sensors, habitat's
cubemap-derived "depth" rescaled from axis distance to true ray distance,
navmesh load-or-recompute, and lazy per-process simulator construction
(habitat-sim cannot be forked after init).
"""
import math

import numpy as np

from . import projections

# (label, rotation-vector) for the six 90-degree cubemap faces
CUBEMAP_FACES = [
    ("left", [0, math.pi / 2, 0]),
    ("front", [0, 0, 0]),
    ("right", [0, -math.pi / 2, 0]),
    ("back", [0, math.pi, 0]),
    ("up", [math.pi / 2, 0, 0]),
    ("down", [-math.pi / 2, 0, 0]),
]

CUBEMAP_FACE_LABELS = [label for label, _ in CUBEMAP_FACES]


class NoNaviguableSpaceError(RuntimeError):
    pass


def _camera_spec(hs, uuid, kind, resolution, orientation=(0.0, 0.0, 0.0)):
    spec = hs.CameraSensorSpec()
    spec.uuid = uuid
    spec.sensor_type = (hs.SensorType.DEPTH if kind == "depth"
                        else hs.SensorType.COLOR)
    spec.resolution = resolution
    spec.hfov = 90
    spec.position = [0.0, 0.0, 0.0]
    spec.orientation = list(orientation)
    return spec


def _equirect_spec(hs, uuid, kind, resolution):
    spec = hs.bindings.EquirectangularSensorSpec()
    spec.uuid = uuid
    if kind == "depth":
        spec.sensor_type = hs.SensorType.DEPTH
    spec.resolution = resolution
    spec.position = [0.0, 0.0, 0.0]
    return spec


def _ray_distance_scale(equirect_resolution):
    """habitat equirect depth comes from internal cubemap warping and
    holds per-axis distance; multiplying by 1/max|ray component| converts
    it to true distance along the ray."""
    proj = projections.EquirectangularProjection(*equirect_resolution)
    rays = projections.get_projection_rays(proj)
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    return 1.0 / np.max(np.abs(rays), axis=-1)


class HabitatEnvironmentMapRenderer:
    def __init__(self, scene, navmesh, scene_dataset_config_file,
                 render_equirectangular=False,
                 equirectangular_resolution=(512, 1024),
                 render_cubemap=False, cubemap_resolution=(512, 512),
                 render_depth=False, gpu_id=0):
        self.scene = scene
        self.navmesh = navmesh
        self.scene_dataset_config_file = scene_dataset_config_file
        self.gpu_id = gpu_id
        self.render_equirectangular = render_equirectangular
        self.equirectangular_resolution = equirectangular_resolution
        self.equirectangular_projection = \
            projections.EquirectangularProjection(*equirectangular_resolution)
        self.equirectangular_depth_scale_factors = \
            _ray_distance_scale(equirectangular_resolution)
        self.render_cubemap = render_cubemap
        self.cubemap_resolution = cubemap_resolution
        self.render_depth = render_depth
        self.seed = None
        self._lazy_initialization()

    def _sensor_specs(self, hs):
        kinds = ["color"] + (["depth"] if self.render_depth else [])
        specs = []
        if self.render_cubemap:
            for label, orientation in CUBEMAP_FACES:
                for kind in kinds:
                    specs.append(_camera_spec(
                        hs, f"{kind}_cubemap_{label}", kind,
                        self.cubemap_resolution, orientation))
        if self.render_equirectangular:
            for kind in kinds:
                specs.append(_equirect_spec(
                    hs, f"{kind}_equirectangular", kind,
                    self.equirectangular_resolution))
        return specs

    def _lazy_initialization(self):
        import habitat_sim  # optional host dependency

        if self.seed is not None:
            return
        np.random.seed()
        self.seed = np.random.randint(2 ** 32 - 1)

        sim_cfg = habitat_sim.SimulatorConfiguration()
        sim_cfg.scene_id = self.scene
        if self.scene_dataset_config_file:
            sim_cfg.scene_dataset_config_file = \
                self.scene_dataset_config_file
        sim_cfg.random_seed = self.seed
        sim_cfg.load_semantic_mesh = False
        sim_cfg.gpu_device_id = self.gpu_id

        agent_cfg = habitat_sim.agent.AgentConfiguration(
            sensor_specifications=self._sensor_specs(habitat_sim))
        self.sim = habitat_sim.Simulator(
            habitat_sim.Configuration(sim_cfg, [agent_cfg]))

        if self.navmesh:
            self.sim.pathfinder.load_nav_mesh(self.navmesh)
        if not self.sim.pathfinder.is_loaded:
            settings = habitat_sim.NavMeshSettings()
            settings.set_defaults()
            self.sim.recompute_navmesh(self.sim.pathfinder, settings, True)
        if not self.sim.pathfinder.is_loaded:
            raise NoNaviguableSpaceError(
                f"No naviguable location (scene: {self.scene})")
        self.agent = self.sim.initialize_agent(agent_id=0)

    def close(self):
        if hasattr(self, "sim"):
            self.sim.close()

    def __del__(self):
        self.close()

    def render_viewpoint(self, viewpoint_position):
        import habitat_sim

        agent_state = habitat_sim.AgentState()
        agent_state.position = viewpoint_position
        self.agent.set_state(agent_state)
        observations = self.sim.get_sensor_observations(agent_ids=0)
        if "depth_equirectangular" in observations:
            observations["depth_equirectangular"] *= \
                self.equirectangular_depth_scale_factors
        return dict(observations=observations,
                    position=viewpoint_position)

    def up_direction(self):
        import habitat_sim

        return np.asarray(habitat_sim.geo.UP).tolist()

    def R_cam_to_world(self):
        import habitat_sim

        return np.stack((habitat_sim.geo.RIGHT, -habitat_sim.geo.UP,
                         habitat_sim.geo.FRONT), axis=0).tolist()
