"""Geometry utilities: torch versions for the eval alignment and the demo
(on the model's device), numpy versions for the host-side dataset
pipeline. Independent reimplementation of the contracts in reference
dust3r/utils/geometry.py; the numpy part is the JAX package's, unchanged.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# torch (device) versions
# ---------------------------------------------------------------------------

def inv_se3(mat: torch.Tensor) -> torch.Tensor:
    """Invert (..., 4, 4) rigid/affine transforms via linalg.inv."""
    return torch.linalg.inv(mat)


def geotrf(trf: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (B, 4, 4) (or (B, 3, 3)) transforms to (B, ..., 3) points
    (ref dust3r/utils/geometry.py:40-101, batched fast path)."""
    d = pts.shape[-1]
    batch = trf.shape[0]
    flat = pts.reshape(batch, -1, d)
    if trf.shape[-1] == d:
        out = torch.einsum("bij,bnj->bni", trf, flat)
    else:
        out = (torch.einsum("bij,bnj->bni", trf[:, :d, :d], flat)
               + trf[:, None, :d, d])
    return out.reshape(pts.shape)


def xy_grid(w: int, h: int, device=None) -> torch.Tensor:
    """(H, W, 2) int32 grid with out[j, i] = (i, j)."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.int32, device=device),
                            torch.arange(w, dtype=torch.int32, device=device),
                            indexing="ij")
    return torch.stack([xs, ys], dim=-1)


def estimate_focal_weiszfeld(pts3d: torch.Tensor, pp: torch.Tensor,
                             iters: int = 10,
                             min_focal: float = 0.0,
                             max_focal: float = np.inf) -> torch.Tensor:
    """Robust focal from a pointmap (ref dust3r/post_process.py:36-60).

    pts3d: (B, H, W, 3); pp: (B, 2) principal point, both on one device.
    IRLS on pixel-ray votes in fp32, clipped around the 60-deg-FoV base
    focal.
    """
    b, h, w, _ = pts3d.shape
    pts3d, pp = pts3d.float(), pp.float()
    pixels = (xy_grid(w, h, pts3d.device).reshape(1, -1, 2).float()
              - pp[:, None, :])
    pts = pts3d.reshape(b, -1, 3)

    z = pts[..., 2:3]
    xy_over_z = torch.where(z.abs() > 0, pts[..., :2] / z,
                            torch.zeros_like(pts[..., :2]))
    xy_over_z = torch.nan_to_num(xy_over_z, nan=0.0, posinf=0.0, neginf=0.0)

    dot_xy_px = (xy_over_z * pixels).sum(dim=-1)
    dot_xy_xy = xy_over_z.square().sum(dim=-1)
    focal = dot_xy_px.mean(dim=1) / dot_xy_xy.mean(dim=1).clamp(min=1e-12)

    for _ in range(iters):
        dis = torch.linalg.norm(pixels - focal[:, None, None] * xy_over_z,
                                dim=-1)
        w_ = 1.0 / dis.clamp(min=1e-8)
        focal = ((w_ * dot_xy_px).mean(dim=1)
                 / (w_ * dot_xy_xy).mean(dim=1).clamp(min=1e-12))

    focal_base = max(h, w) / (2 * np.tan(np.deg2rad(60) / 2))
    return focal.clamp(min=min_focal * focal_base, max=max_focal * focal_base)


# ---------------------------------------------------------------------------
# numpy (host / dataset) versions
# ---------------------------------------------------------------------------

def depthmap_to_camera_coordinates(depthmap: np.ndarray, intrinsics: np.ndarray
                                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Pinhole unprojection (ref geometry.py:165-197). Returns (X_cam, valid)."""
    intrinsics = np.float32(intrinsics)
    h, w = depthmap.shape
    assert intrinsics[0, 1] == 0.0 and intrinsics[1, 0] == 0.0
    fu, fv = intrinsics[0, 0], intrinsics[1, 1]
    cu, cv = intrinsics[0, 2], intrinsics[1, 2]
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    z = depthmap
    x = (u - cu) * z / fu
    y = (v - cv) * z / fv
    x_cam = np.stack((x, y, z), axis=-1).astype(np.float32)
    return x_cam, depthmap > 0.0


def depthmap_to_absolute_camera_coordinates(depthmap: np.ndarray,
                                            intrinsics: np.ndarray,
                                            camera_pose: np.ndarray
                                            ) -> Tuple[np.ndarray, np.ndarray]:
    """World-frame pointmap from depth + intrinsics + cam2world pose."""
    x_cam, valid = depthmap_to_camera_coordinates(depthmap, intrinsics)
    r, t = camera_pose[:3, :3], camera_pose[:3, 3]
    x_world = np.einsum("ik,vuk->vui", r, x_cam) + t[None, None, :]
    return x_world.astype(np.float32), valid


def colmap_to_opencv_intrinsics(k: np.ndarray) -> np.ndarray:
    k = k.copy()
    k[0, 2] -= 0.5
    k[1, 2] -= 0.5
    return k


def opencv_to_colmap_intrinsics(k: np.ndarray) -> np.ndarray:
    k = k.copy()
    k[0, 2] += 0.5
    k[1, 2] += 0.5
    return k


def np_xy_grid(w: int, h: int) -> np.ndarray:
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    return np.stack([xs, ys], axis=-1)


def find_reciprocal_matches(p1: np.ndarray, p2: np.ndarray):
    """Mutual nearest-neighbour matches between two point sets
    (ref dust3r/utils/geometry.py:340-356).

    Returns (reciprocal_in_p2 bool (len(p2),), nn2_in_p1 int (len(p2),),
    num_matches) — p2[i] matches p1[nn2_in_p1[i]] iff reciprocal_in_p2[i].
    Host-side; uses the native C++ KD-tree (spann3r_tpu/native) when built,
    scipy otherwise.
    """
    from .. import native

    p1 = np.ascontiguousarray(p1, np.float32)
    p2 = np.ascontiguousarray(p2, np.float32)
    if native.available() and p1.shape[1] == 3:
        tree1, tree2 = native.NativeKDTree(p1), native.NativeKDTree(p2)
        _, nn1_in_p2 = tree2.query(p1)
        _, nn2_in_p1 = tree1.query(p2)
    else:
        from scipy.spatial import cKDTree

        _, nn1_in_p2 = cKDTree(p2).query(p1, workers=-1)
        _, nn2_in_p1 = cKDTree(p1).query(p2, workers=-1)

    reciprocal_in_p2 = nn1_in_p2[nn2_in_p1] == np.arange(len(p2))
    return reciprocal_in_p2, nn2_in_p1, int(reciprocal_in_p2.sum())
