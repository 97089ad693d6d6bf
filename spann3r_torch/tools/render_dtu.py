"""DTU GT depth rendering (offline preprocessing; ref spann3r/tools/render_dtu.py).

The reference renders depth maps of GT meshes via pyrender/OpenGL.  Neither
pyrender nor a GL context exists in this environment, so `render_depth_maps`
is a numpy z-buffer triangle rasterizer — slower, but dependency-free and
adequate for offline dataset preparation. The MVSNet cam parser is shared
with datasets/dtu.py.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..datasets.dtu import load_cam_mvsnet  # noqa: F401 (re-export, ref parity)


def render_depth_map(vertices: np.ndarray, faces: np.ndarray,
                     pose_c2w: np.ndarray, k: np.ndarray, h: int, w: int,
                     near: float = 0.01, far: float = 5.0,
                     opengl_pose: bool = True) -> np.ndarray:
    """Rasterize one depth map of a triangle mesh.

    pose_c2w: camera-to-world; OpenGL convention when opengl_pose (the
    reference feeds GL poses to pyrender, ref render_dtu.py:54-81).
    Returns (H, W) float32 depth; 0 where no geometry.
    """
    w2c = np.linalg.inv(pose_c2w)
    pts = vertices @ w2c[:3, :3].T + w2c[:3, 3]
    if opengl_pose:  # GL camera looks down -z with +y up -> OpenCV
        pts = pts * np.array([1.0, -1.0, -1.0])

    z = pts[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        u = k[0, 0] * pts[:, 0] / z + k[0, 2]
        v = k[1, 1] * pts[:, 1] / z + k[1, 2]

    depth = np.full((h, w), np.inf, np.float32)
    tri = faces.astype(np.int64)
    # backface/clip filter
    zf = z[tri]
    keep = (zf > near).all(axis=1) & (zf < far).all(axis=1)
    tri = tri[keep]

    for f in tri:
        us, vs, zs = u[f], v[f], z[f]
        x0, x1 = int(max(np.floor(us.min()), 0)), int(min(np.ceil(us.max()), w - 1))
        y0, y1 = int(max(np.floor(vs.min()), 0)), int(min(np.ceil(vs.max()), h - 1))
        if x1 < x0 or y1 < y0:
            continue
        xs, ys = np.meshgrid(np.arange(x0, x1 + 1), np.arange(y0, y1 + 1))
        # barycentric coordinates
        d = ((vs[1] - vs[2]) * (us[0] - us[2]) +
             (us[2] - us[1]) * (vs[0] - vs[2]))
        if abs(d) < 1e-12:
            continue
        l0 = ((vs[1] - vs[2]) * (xs - us[2]) + (us[2] - us[1]) * (ys - vs[2])) / d
        l1 = ((vs[2] - vs[0]) * (xs - us[2]) + (us[0] - us[2]) * (ys - vs[2])) / d
        l2 = 1.0 - l0 - l1
        inside = (l0 >= 0) & (l1 >= 0) & (l2 >= 0)
        if not inside.any():
            continue
        # perspective-correct depth interpolation
        zi = 1.0 / (l0 / zs[0] + l1 / zs[1] + l2 / zs[2])
        sub = depth[y0:y1 + 1, x0:x1 + 1]
        upd = inside & (zi < sub)
        sub[upd] = zi[upd]

    depth[~np.isfinite(depth)] = 0.0
    return depth


def render_depth_maps(vertices: np.ndarray, faces: np.ndarray,
                      poses: Sequence[np.ndarray], k: np.ndarray,
                      h: int, w: int, near: float = 0.01,
                      far: float = 5.0) -> List[np.ndarray]:
    """Batch variant matching the reference signature
    (ref render_dtu.py:54-81)."""
    return [render_depth_map(vertices, faces, p, k, h, w, near, far)
            for p in poses]
