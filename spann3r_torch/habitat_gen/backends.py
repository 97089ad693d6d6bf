"""Scene rendering backends for the multiview generator.

`SceneBackend` is the rendering/navigation contract the reference obtains
from habitat_sim (multiview_habitat_sim_generator.py:173-239):
random navigable points, point snapping, and (color, z-depth) rendering at
a (position, WXYZ-quaternion) habitat-convention camera.

`HabitatSimBackend` reproduces the reference simulator setup when
habitat-sim is installed (it is not in this image).  `BoxRoomBackend`
ray-casts a textured axis-aligned room in numpy — exact planar depths and
checkerboard walls — so the sampling/covisibility/packing pipeline runs
and is testable without the simulator.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from . import quat
from .geometry import R_OPENCV2HABITAT, UP, compute_camera_intrinsics


class SceneBackend:
    def random_navigable_point(self) -> np.ndarray:
        raise NotImplementedError

    def snap_point(self, p) -> np.ndarray:
        """May return nan on failure (habitat pathfinder contract)."""
        raise NotImplementedError

    def render(self, position, orientation) -> Dict[str, np.ndarray]:
        """{'color': (H, W, 3|4) uint8, 'depth': (H, W) float32 z-depth}"""
        raise NotImplementedError

    def close(self):
        pass


class HabitatSimBackend(SceneBackend):
    """The reference's simulator configuration, verbatim
    (ref multiview_habitat_sim_generator.py:173-226): RGB + DEPTH camera
    sensors, pre-computed navmesh if given else recomputed.

    UNTESTED-BY-CONSTRUCTION: habitat-sim is not installed in this image,
    so this class has never executed here — only its import gate is
    exercised.  `BoxRoomBackend` below is the CI-tested backend; treat
    this one as a port that needs a smoke run the first time habitat-sim
    is actually available."""

    def __init__(self, scene: str, navmesh: str,
                 scene_dataset_config_file: str, resolution, hfov: float,
                 gpu_id: int = 0, seed: Optional[int] = None):
        import habitat_sim  # gated: not installed in this image

        sim_cfg = habitat_sim.SimulatorConfiguration()
        sim_cfg.scene_id = scene
        if scene_dataset_config_file:
            sim_cfg.scene_dataset_config_file = scene_dataset_config_file
        if seed is not None:
            sim_cfg.random_seed = seed
        sim_cfg.load_semantic_mesh = False
        sim_cfg.gpu_device_id = gpu_id

        specs = []
        for uuid, stype in (("color", habitat_sim.SensorType.COLOR),
                            ("depth", habitat_sim.SensorType.DEPTH)):
            s = habitat_sim.CameraSensorSpec()
            s.uuid = uuid
            s.sensor_type = stype
            s.resolution = resolution
            s.hfov = hfov
            s.position = [0.0, 0.0, 0.0]
            specs.append(s)
        agent_cfg = habitat_sim.agent.AgentConfiguration(
            sensor_specifications=specs)
        self.sim = habitat_sim.Simulator(
            habitat_sim.Configuration(sim_cfg, [agent_cfg]))
        if navmesh:
            self.sim.pathfinder.load_nav_mesh(navmesh)
        if not self.sim.pathfinder.is_loaded:
            settings = habitat_sim.NavMeshSettings()
            settings.set_defaults()
            self.sim.recompute_navmesh(self.sim.pathfinder, settings, True)
        if not self.sim.pathfinder.is_loaded:
            from .generator import NoNavigableSpaceError
            raise NoNavigableSpaceError(
                f"No navigable location (scene: {scene} "
                f"-- navmesh: {navmesh})")
        self.agent = self.sim.initialize_agent(agent_id=0)
        self._habitat_sim = habitat_sim

    def random_navigable_point(self):
        return np.asarray(self.sim.pathfinder.get_random_navigable_point())

    def snap_point(self, p):
        return np.asarray(self.sim.pathfinder.snap_point(p))

    def render(self, position, orientation):
        hs = self._habitat_sim
        state = hs.AgentState()
        state.position = np.asarray(position, np.float32)
        state.rotation = orientation
        self.agent.set_state(state)
        obs = self.sim.get_sensor_observations(agent_ids=0)
        return {"color": np.asarray(obs["color"]),
                "depth": np.asarray(obs["depth"], np.float32)}

    def close(self):
        self.sim.close()


class BoxRoomBackend(SceneBackend):
    """Axis-aligned room [0,sx] x [0,sy] x [-sz,0] (y up, habitat axes)
    with checkerboard walls, rendered by exact per-pixel ray casting.
    Planar z-depth matches the habitat depth sensor semantics the
    unprojection math assumes (multiview_habitat_sim_generator.py:27-37)."""

    def __init__(self, resolution=(64, 64), hfov: float = 60.0,
                 size=(6.0, 3.0, 8.0), checker: float = 0.5,
                 seed: int = 0):
        self.resolution = tuple(resolution)
        self.hfov = hfov
        self.size = np.asarray(size, np.float64)
        self.checker = checker
        self.rng = np.random.default_rng(seed)
        # per-wall base colors (2 per axis), fixed by seed
        self._wall_colors = self.rng.integers(60, 220, (6, 3))

    # navigation: the floor rectangle with a small margin
    def random_navigable_point(self):
        sx, _, sz = self.size
        m = 0.5
        x = self.rng.uniform(m, sx - m)
        z = self.rng.uniform(-sz + m, -m)
        return np.array([x, 0.0, z])

    def snap_point(self, p):
        sx, _, sz = self.size
        m = 0.5
        return np.array([np.clip(p[0], m, sx - m), 0.0,
                         np.clip(p[2], -sz + m, -m)])

    def render(self, position, orientation):
        h, w = self.resolution
        f, cu, cv = compute_camera_intrinsics(h, w, self.hfov)
        u, v = np.meshgrid(np.arange(w), np.arange(h))
        # OpenCV-frame ray dirs with unit z, rotated to world
        d_cam = np.stack([(u - cu) / f, (v - cv) / f, np.ones_like(u, float)],
                         axis=-1)
        R = quat.as_rotation_matrix(orientation) @ R_OPENCV2HABITAT
        d = d_cam @ R.T  # (h, w, 3) world directions
        o = np.asarray(position, np.float64)

        lo = np.array([0.0, 0.0, -self.size[2]])
        hi = np.array([self.size[0], self.size[1], 0.0])
        # from inside the box: per axis, distance to the wall faced by d
        with np.errstate(divide="ignore", invalid="ignore"):
            t_axis = np.where(d > 0, (hi - o) / d,
                              np.where(d < 0, (lo - o) / d, np.inf))
        hit_axis = np.argmin(t_axis, axis=-1)
        t = np.take_along_axis(t_axis, hit_axis[..., None], -1)[..., 0]
        t = np.maximum(t, 1e-6)
        p_hit = o + t[..., None] * d

        # wall id: axis*2 + (positive face); checker from in-plane coords
        positive = np.take_along_axis(d, hit_axis[..., None], -1)[..., 0] > 0
        wall = hit_axis * 2 + positive.astype(int)
        ax1 = (hit_axis + 1) % 3
        ax2 = (hit_axis + 2) % 3
        c1 = np.take_along_axis(p_hit, ax1[..., None], -1)[..., 0]
        c2 = np.take_along_axis(p_hit, ax2[..., None], -1)[..., 0]
        check = ((np.floor(c1 / self.checker)
                  + np.floor(c2 / self.checker)) % 2).astype(int)
        color = self._wall_colors[wall]
        color = np.where(check[..., None] == 0, color, 255 - color)
        # depth: distance along camera z — with unit-z camera rays, t IS it
        return {"color": color.astype(np.uint8),
                "depth": t.astype(np.float32)}
