"""Renderer-independent camera/pointcloud math for the multiview generator.

Reference: croco/datasets/habitat_sim/multiview_habitat_sim_generator.py:
12-118.  Habitat's world axes are RIGHT=+x, UP=+y, FRONT=-z; cameras are
stored as (position, WXYZ quaternion) in habitat convention and converted
to OpenCV (x right, y down, z forward) via R_OPENCV2HABITAT.
"""
from __future__ import annotations

import numpy as np

from . import quat

# habitat_sim.geo constants (the package is not required for the math)
RIGHT = np.array([1.0, 0.0, 0.0])
UP = np.array([0.0, 1.0, 0.0])
FRONT = np.array([0.0, 0.0, -1.0])

# ref multiview_habitat_sim_generator.py:13-14
R_OPENCV2HABITAT = np.stack((RIGHT, -UP, FRONT), axis=0)
R_HABITAT2OPENCV = R_OPENCV2HABITAT.T
DEG2RAD = np.pi / 180


def compute_camera_intrinsics(height, width, hfov):
    """ref :17-20."""
    f = width / 2 / np.tan(hfov / 2 * np.pi / 180)
    return f, width / 2, height / 2


def compute_camera_pose_opencv_convention(camera_position,
                                          camera_orientation):
    """(R_cam2world, t_cam2world) in OpenCV convention (ref :22-25)."""
    R_cam2world = quat.as_rotation_matrix(camera_orientation) \
        @ R_OPENCV2HABITAT
    return R_cam2world, np.asarray(camera_position)


def compute_pointmap(depthmap, hfov):
    """HxWx3 camera-frame pointmap from a planar z-depth map (ref :27-37)."""
    height, width = depthmap.shape
    f, cu, cv = compute_camera_intrinsics(height, width, hfov)
    u, v = np.meshgrid(range(width), range(height))
    x_cam = (u - cu) / f * depthmap
    y_cam = (v - cv) / f * depthmap
    return np.stack((x_cam, y_cam, depthmap), axis=-1)


def compute_pointcloud(depthmap, hfov, camera_position, camera_rotation):
    """World-frame (N, 3) cloud of valid (nonzero-depth) pixels
    (ref :39-48)."""
    R_cam2world, t_cam2world = compute_camera_pose_opencv_convention(
        camera_position, camera_rotation)
    X_cam = compute_pointmap(depthmap, hfov)
    valid = X_cam[:, :, 2] != 0.0
    X_cam = X_cam.reshape(-1, 3)[valid.flatten()]
    return X_cam @ R_cam2world.T + t_cam2world.reshape(1, 3)


def _nn_distances(ref_points, queries):
    """1-NN distances of queries against ref_points — native KD-tree when
    built, scipy otherwise (the reference uses sklearn)."""
    from ..native import NativeKDTree, available
    if available():
        d, _ = NativeKDTree(ref_points).query(queries, k=1)
        return np.asarray(d).reshape(-1)
    from scipy.spatial import cKDTree
    d, _ = cKDTree(ref_points).query(queries, k=1)
    return np.asarray(d).reshape(-1)


def compute_pointcloud_overlaps(pointcloud1, pointcloud2, distance_threshold,
                                compute_symmetric=False,
                                adaptive_threshold=False):
    """Overlap counts under a distance threshold (ref :50-73,
    compute_pointcloud_overlaps_scikit)."""
    if adaptive_threshold:
        # self-queries return distance 0 to self; the reference takes the
        # 2nd neighbour — scipy's k=2 gives exactly that
        from scipy.spatial import cKDTree
        d1 = cKDTree(pointcloud1).query(pointcloud1, k=2)[0][:, 1]
        d2 = cKDTree(pointcloud2).query(pointcloud2, k=2)[0][:, 1]
        distance_threshold = (np.mean(d1) + np.mean(d2)) / 2
    data = {"intersection1": int(np.count_nonzero(
        _nn_distances(pointcloud2, pointcloud1) < distance_threshold)),
        "size1": len(pointcloud1)}
    if compute_symmetric:
        data["intersection2"] = int(np.count_nonzero(
            _nn_distances(pointcloud1, pointcloud2) < distance_threshold))
        data["size2"] = len(pointcloud2)
    return data


def append_camera_parameters(observation, hfov, camera_location,
                             camera_rotation):
    """Attach K / R_cam2world / t_cam2world to a rendered observation
    in-place (ref :75-89)."""
    R_cam2world, t_cam2world = compute_camera_pose_opencv_convention(
        camera_location, camera_rotation)
    height, width = observation["depth"].shape
    f, cu, cv = compute_camera_intrinsics(height, width, hfov)
    observation["camera_intrinsics"] = np.asarray(
        [[f, 0, cu], [0, f, cv], [0, 0, 1.0]])
    observation["t_cam2world"] = t_cam2world
    observation["R_cam2world"] = R_cam2world


def look_at(eye, center, up, return_cam2world=True):
    """gluLookAt in OpenCV convention (ref :91-111)."""
    z = center - eye
    z = z / np.linalg.norm(z, axis=-1, keepdims=True)
    y = -up
    y = y - np.sum(y * z, axis=-1, keepdims=True) * z
    y = y / np.linalg.norm(y, axis=-1, keepdims=True)
    x = np.cross(y, z, axis=-1)
    if return_cam2world:
        return np.stack((x, y, z), axis=-1), eye
    R = np.stack((x, y, z), axis=-2)
    return R, -np.einsum("...ij, ...j", R, eye)


def look_at_for_habitat(eye, center, up, return_cam2world=True):
    """ref :113-116: cam2world look-at expressed as a habitat-convention
    quaternion."""
    R, t = look_at(eye, center, up)
    orientation = quat.from_rotation_matrix(R @ R_OPENCV2HABITAT.T)
    return orientation, t


def generate_orientation_noise(rng, pan_range, tilt_range, roll_range):
    """Random pan/tilt/roll jitter quaternion (ref :118-121)."""
    return quat.multiply(
        quat.multiply(
            quat.from_rotation_vector(rng.uniform(*pan_range) * DEG2RAD * UP),
            quat.from_rotation_vector(
                rng.uniform(*tilt_range) * DEG2RAD * RIGHT)),
        quat.from_rotation_vector(
            rng.uniform(*roll_range) * DEG2RAD * FRONT))
