"""Multiview overlapping-tuple generator.

Reference: croco/datasets/habitat_sim/multiview_habitat_sim_generator.py:
125-360 (MultiviewHabitatSimGenerator).  Same sampling procedure —
reference viewpoint on the navmesh, random-walk secondary viewpoints
looking at the reference cloud's centroid with pose noise, covisibility
acceptance via symmetric KD-tree overlap — over a pluggable SceneBackend
and an explicit np.random.Generator (the reference reseeds global numpy).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from . import quat
from .backends import BoxRoomBackend, HabitatSimBackend, SceneBackend
from .geometry import (UP, append_camera_parameters, compute_pointcloud,
                       compute_pointcloud_overlaps,
                       generate_orientation_noise, look_at_for_habitat)


class NoNavigableSpaceError(RuntimeError):
    pass


class MultiviewSceneGenerator:
    """ref :125-355.  Backend selection: an explicit `backend` instance, or
    the reference's habitat_sim construction from (scene, navmesh,
    scene_dataset_config_file)."""

    def __init__(self, scene: str = "", navmesh: str = "",
                 scene_dataset_config_file: str = "",
                 resolution=(240, 320), views_count: int = 2,
                 hfov: float = 60, gpu_id: int = 0, size: int = 10000,
                 minimum_covisibility: float = 0.5, transform=None,
                 backend: Optional[SceneBackend] = None,
                 seed: Optional[int] = None):
        self.scene = scene
        self.navmesh = navmesh
        self.scene_dataset_config_file = scene_dataset_config_file
        self.resolution = tuple(resolution)
        self.views_count = views_count
        assert self.views_count >= 1
        self.hfov = hfov
        self.gpu_id = gpu_id
        self.size = size
        self.transform = transform

        # ref :147-168 sampling hyperparameters
        self.pan_range = (-3, 3)
        self.tilt_range = (-10, 10)
        self.roll_range = (-5, 5)
        self.height_range = (1.2, 1.8)
        self.random_steps_count = 5
        self.random_step_variance = 2.0
        self.minimum_valid_fraction = 0.7
        self.distance_threshold = 0.05
        self.minimum_covisibility = minimum_covisibility
        self.max_attempts_count = 100
        self.max_resample_count = 100  # bounds the reference's recursion

        self.seed = seed if seed is not None else \
            int(np.random.default_rng().integers(2 ** 32 - 1))
        self.rng = np.random.default_rng(self.seed)
        if backend is not None:
            self.backend = backend
        elif scene == "__boxroom__":  # synthetic scene, no simulator needed
            self.backend = BoxRoomBackend(resolution=self.resolution,
                                          hfov=hfov, seed=self.seed)
        else:
            self.backend = HabitatSimBackend(
                scene, navmesh, scene_dataset_config_file, self.resolution,
                hfov, gpu_id=gpu_id, seed=self.seed)

    def close(self):
        self.backend.close()

    def __len__(self):
        return self.size

    def sample_random_viewpoint(self):
        """ref :230-239."""
        nav_point = self.backend.random_navigable_point()
        height = self.rng.uniform(*self.height_range)
        position = nav_point + height * UP
        orientation = quat.multiply(
            quat.from_rotation_vector(self.rng.uniform(0, 2 * np.pi) * UP),
            generate_orientation_noise(self.rng, self.pan_range,
                                       self.tilt_range, self.roll_range))
        return position, orientation, nav_point

    def sample_other_random_viewpoint(self, observed_point, nav_point):
        """Random walk + look-at-the-centroid with pose noise
        (ref :241-258)."""
        other_nav_point = nav_point
        walk_directions = self.random_step_variance * np.asarray([1, 0, 1])
        for _ in range(self.random_steps_count):
            temp = self.backend.snap_point(
                other_nav_point
                + walk_directions * self.rng.normal(size=3))
            if not np.isnan(temp[0]):
                other_nav_point = temp
        height = self.rng.uniform(*self.height_range)
        position = other_nav_point + height * UP
        rotation, position = look_at_for_habitat(
            eye=position, center=observed_point, up=UP,
            return_cam2world=True)
        rotation = quat.multiply(
            rotation, generate_orientation_noise(
                self.rng, self.pan_range, self.tilt_range, self.roll_range))
        return position, rotation, other_nav_point

    def is_other_pointcloud_overlapping(self, ref_pointcloud,
                                        other_pointcloud):
        """ref :260-269."""
        pixels_count = self.resolution[0] * self.resolution[1]
        valid_fraction = len(other_pointcloud) / pixels_count
        assert 0.0 <= valid_fraction <= 1.0
        overlap = compute_pointcloud_overlaps(
            ref_pointcloud, other_pointcloud, self.distance_threshold,
            compute_symmetric=True)
        covisibility = min(overlap["intersection1"] / pixels_count,
                           overlap["intersection2"] / pixels_count)
        is_valid = (valid_fraction >= self.minimum_valid_fraction
                    and covisibility >= self.minimum_covisibility)
        return is_valid, valid_fraction, covisibility

    def render_viewpoint(self, position, orientation):
        """ref :277-284: render + attach OpenCV camera parameters."""
        obs = self.backend.render(position, orientation)
        append_camera_parameters(obs, self.hfov, position, orientation)
        return obs

    def __getitem__(self, useless_idx):
        """ref :286-355.  The reference recurses (`return self[0]`) on bad
        reference views / exhausted attempts; an explicit resample loop
        bounds that."""
        pixels_count = self.resolution[0] * self.resolution[1]
        for _ in range(self.max_resample_count):
            ref_position, ref_orientation, nav_point = \
                self.sample_random_viewpoint()
            ref_observations = self.render_viewpoint(ref_position,
                                                     ref_orientation)
            ref_pointcloud = compute_pointcloud(
                ref_observations["depth"], self.hfov, ref_position,
                ref_orientation)
            ref_valid_fraction = len(ref_pointcloud) / pixels_count
            if ref_valid_fraction < self.minimum_valid_fraction:
                continue  # resample the reference view
            observed_point = np.mean(ref_pointcloud, axis=0)

            observations = [ref_observations]
            covisibilities = [ref_valid_fraction]
            positions = [ref_position]
            orientations = [quat.as_float_array(ref_orientation)]
            clouds = [ref_pointcloud]
            valid_fractions = [ref_valid_fraction]

            exhausted = False
            for _ in range(self.views_count - 1):
                ok = False
                for _attempt in range(self.max_attempts_count):
                    position, rotation, _ = self.sample_other_random_viewpoint(
                        observed_point, nav_point)
                    other_obs = self.render_viewpoint(position, rotation)
                    other_cloud = compute_pointcloud(
                        other_obs["depth"], self.hfov, position, rotation)
                    is_valid, valid_fraction, covisibility = \
                        self.is_other_pointcloud_overlapping(
                            ref_pointcloud, other_cloud)
                    if is_valid:
                        ok = True
                        break
                if not ok:
                    exhausted = True
                    break
                observations.append(other_obs)
                covisibilities.append(covisibility)
                positions.append(position)
                orientations.append(quat.as_float_array(rotation))
                clouds.append(other_cloud)
                valid_fractions.append(valid_fraction)
            if exhausted:
                continue  # novel reference viewpoint (ref :324-327)

            # pairwise visibility matrix (ref :336-343)
            n = len(observations)
            pairwise = np.ones((n, n))
            for i in range(n):
                pairwise[i, i] = valid_fractions[i]
                for j in range(i + 1, n):
                    overlap = compute_pointcloud_overlaps(
                        clouds[i], clouds[j], self.distance_threshold,
                        compute_symmetric=True)
                    pairwise[i, j] = overlap["intersection1"] / pixels_count
                    pairwise[j, i] = overlap["intersection2"] / pixels_count

            data = {
                "observations": observations,
                "positions": np.asarray(positions),
                "orientations": np.asarray(orientations),
                "covisibility_ratios": np.asarray(covisibilities),
                "valid_fractions": np.asarray(valid_fractions, dtype=float),
                "pairwise_visibility_ratios": np.asarray(pairwise,
                                                         dtype=float),
            }
            if self.transform is not None:
                data = self.transform(data)
            return data
        raise RuntimeError(
            "unable to sample a valid multiview tuple "
            f"after {self.max_resample_count} attempts")

    def generate_random_spiral_trajectory(self, images_count=100,
                                          max_radius=0.5, half_turns=5,
                                          use_constant_orientation=False):
        """Visualization helper (ref :357-394)."""
        from .geometry import compute_camera_pose_opencv_convention
        pixels_count = self.resolution[0] * self.resolution[1]
        for _ in range(self.max_resample_count):
            ref_position, ref_orientation, _ = self.sample_random_viewpoint()
            ref_observations = self.render_viewpoint(ref_position,
                                                     ref_orientation)
            ref_pointcloud = compute_pointcloud(
                ref_observations["depth"], self.hfov, ref_position,
                ref_orientation)
            if len(ref_pointcloud) / pixels_count >= \
                    self.minimum_valid_fraction:
                break
        else:
            raise RuntimeError("no valid reference view for the trajectory")
        observed_point = np.mean(ref_pointcloud, axis=0)
        ref_R, _ = compute_camera_pose_opencv_convention(ref_position,
                                                         ref_orientation)
        images, is_valid = [], []
        for alpha in np.linspace(0, 1, images_count):
            r = max_radius * np.abs(np.sin(alpha * np.pi))
            theta = alpha * half_turns * np.pi
            offset = np.asarray([r * np.cos(theta), r * np.sin(theta), 0.0])
            position = ref_position + (ref_R @ offset.reshape(3, 1)).flatten()
            if use_constant_orientation:
                orientation = ref_orientation
            else:
                orientation, position = look_at_for_habitat(
                    eye=position, center=observed_point, up=UP)
            obs = self.render_viewpoint(position, orientation)
            images.append(obs["color"][..., :3])
            cloud = compute_pointcloud(obs["depth"], self.hfov, position,
                                       orientation)
            valid, _, _ = self.is_other_pointcloud_overlapping(
                ref_pointcloud, cloud)
            is_valid.append(valid)
        return images, is_valid
