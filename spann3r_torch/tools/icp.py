"""Point-to-point ICP + normal estimation (numpy/scipy).

Native replacement for the open3d calls in the reference eval
(eval.py:203-212): `registration_icp(..., TransformationEstimationPointToPoint)`
and `estimate_normals`.  Same contract: correspondences within
`threshold`, closed-form SE3 (Umeyama, no scale), iterate to convergence.
"""
from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree as KDTree


def _best_fit_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares SE3 aligning src -> dst (Kabsch/Umeyama, no scale)."""
    c_src = src.mean(axis=0)
    c_dst = dst.mean(axis=0)
    h = (src - c_src).T @ (dst - c_dst)
    u, _, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    s = np.diag([1.0, 1.0, d])
    r = vt.T @ s @ u.T
    t = c_dst - r @ c_src
    m = np.eye(4)
    m[:3, :3] = r
    m[:3, 3] = t
    return m


def registration_icp(src_points: np.ndarray, dst_points: np.ndarray,
                     threshold: float, init: np.ndarray | None = None,
                     max_iterations: int = 30, tol: float = 1e-7,
                     max_points: int = 200_000) -> np.ndarray:
    """ICP aligning src -> dst; returns the 4x4 transformation.

    Uses the native C++ runtime (spann3r_tpu/native) when built, falling
    back to this scipy implementation.  Subsamples very large clouds for the
    correspondence search (the transform is still applied to everything by
    the caller)."""
    rng = np.random.default_rng(0)
    from .. import native
    if native.available():
        src = np.asarray(src_points, dtype=np.float32).reshape(-1, 3)
        dst = np.asarray(dst_points, dtype=np.float32).reshape(-1, 3)
        if len(src) > max_points:
            src = src[rng.choice(len(src), max_points, replace=False)]
        if len(dst) > max_points:
            dst = dst[rng.choice(len(dst), max_points, replace=False)]
        return native.icp_p2p(src, dst, threshold, init, max_iterations)
    src = np.asarray(src_points, dtype=np.float64)
    dst = np.asarray(dst_points, dtype=np.float64)
    if len(src) > max_points:
        src = src[rng.choice(len(src), max_points, replace=False)]
    if len(dst) > max_points:
        dst = dst[rng.choice(len(dst), max_points, replace=False)]

    transform = np.eye(4) if init is None else np.asarray(init, dtype=np.float64)
    tree = KDTree(dst)
    cur = src @ transform[:3, :3].T + transform[:3, 3]
    prev_rmse = np.inf
    for _ in range(max_iterations):
        dist, idx = tree.query(cur, workers=-1)
        keep = dist < threshold
        if keep.sum() < 3:
            break
        step = _best_fit_transform(cur[keep], dst[idx[keep]])
        transform = step @ transform
        cur = src @ transform[:3, :3].T + transform[:3, 3]
        rmse = float(np.sqrt(np.mean(dist[keep] ** 2)))
        if abs(prev_rmse - rmse) < tol:
            break
        prev_rmse = rmse
    return transform


def estimate_normals(points: np.ndarray, k: int = 30,
                     max_points: int | None = None) -> np.ndarray:
    """Per-point normals from local PCA over k nearest neighbours
    (open3d estimate_normals equivalent; orientation is arbitrary, which is
    fine — the metrics take |dot| (ref eval_recon.py:19-21))."""
    from .. import native
    if native.available():
        return native.estimate_normals(points, k)
    pts = np.asarray(points, dtype=np.float64)
    tree = KDTree(pts)
    k = min(k, len(pts))
    _, idx = tree.query(pts, k=k, workers=-1)
    neigh = pts[idx]                       # (N, k, 3)
    centered = neigh - neigh.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", centered, centered) / k
    # smallest eigenvector of each 3x3 covariance
    w, v = np.linalg.eigh(cov)
    return v[:, :, 0]
