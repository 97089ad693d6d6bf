"""Minimal WXYZ quaternion helpers (the `quaternion` package the reference
uses is not in this image; these reproduce the operations
multiview_habitat_sim_generator.py calls, same WXYZ storage convention)."""
from __future__ import annotations

import numpy as np


def from_rotation_vector(v) -> np.ndarray:
    """Axis-angle vector -> (w, x, y, z)."""
    v = np.asarray(v, np.float64)
    angle = np.linalg.norm(v)
    if angle < 1e-12:
        return np.array([1.0, 0.0, 0.0, 0.0])
    axis = v / angle
    s = np.sin(angle / 2)
    return np.concatenate([[np.cos(angle / 2)], s * axis])


def multiply(q1, q2) -> np.ndarray:
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def as_rotation_matrix(q) -> np.ndarray:
    w, x, y, z = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def from_rotation_matrix(R) -> np.ndarray:
    """Shepperd's method (stable for all traces)."""
    R = np.asarray(R, np.float64)
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                         (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 0.0)) * 2
    q = np.empty(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def as_float_array(q) -> np.ndarray:
    """Identity here — quaternions are already plain WXYZ arrays
    (the reference calls quaternion.as_float_array at the same spots)."""
    return np.asarray(q, np.float64)


def from_float_array(a) -> np.ndarray:
    return np.asarray(a, np.float64)
