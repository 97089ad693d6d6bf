"""Camera pose recovery from pointmaps via PnP-RANSAC
(ref demo.py:169-185)."""
from __future__ import annotations

from typing import Optional

import numpy as np


def pose_from_pointmap(pts3d: np.ndarray, intrinsic: np.ndarray,
                       mask: Optional[np.ndarray] = None
                       ) -> Optional[np.ndarray]:
    """pts3d: (H, W, 3) pointmap in a global frame -> cam2world 4x4.

    Solves PnP-RANSAC between the dense pixel grid and the regressed 3D
    points (optionally restricted to a boolean (H, W) confidence mask, ref
    cloud_opt/init_im_poses.py:260-280 fast_pnp), then inverts the
    extrinsic."""
    import cv2

    h, w, _ = pts3d.shape
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    points_2d = np.stack((u, v), axis=-1).reshape(-1, 2).astype(np.float32)
    points_3d = pts3d.reshape(-1, 3).astype(np.float32)
    if mask is not None:
        keep = np.asarray(mask, bool).reshape(-1)
        if keep.sum() < 8:
            return None
        points_2d, points_3d = points_2d[keep], points_3d[keep]
    dist = np.zeros(4, dtype=np.float32)
    ok, rvec, tvec, _ = cv2.solvePnPRansac(points_3d, points_2d,
                                           intrinsic.astype(np.float32), dist)
    if not ok:
        return None
    rmat, _ = cv2.Rodrigues(rvec)
    extrinsic = np.eye(4)
    extrinsic[:3, :3] = rmat
    extrinsic[:3, 3] = tvec.reshape(-1)
    return np.linalg.inv(extrinsic)
