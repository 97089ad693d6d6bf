"""3D scene visualization: sky segmentation, camera frusta, scene assembly.

Dependency-free rebuild of the reference viz toolkit (dust3r/viz.py:118-330):
trimesh isn't available in this image, so SceneViz assembles pointclouds +
camera meshes into a single GLB via utils/export (one TRIANGLES + one POINTS
primitive).  `show()` writes the GLB and opens an open3d viewer when that
library exists; headless it just reports the file path.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

CAM_COLORS = [(255, 0, 0), (0, 0, 255), (0, 255, 0), (255, 0, 255),
              (255, 204, 0), (0, 204, 204), (128, 255, 255), (255, 128, 255),
              (255, 255, 128), (0, 0, 0), (128, 128, 128)]


def auto_cam_size(im_poses) -> float:
    """10% of the median pairwise camera-center distance
    (ref dust3r/viz.py:114-115, utils/geometry.py:359-361) — robust to a
    single far-outlier camera, unlike a bbox diagonal."""
    centers = np.asarray(im_poses)[:, :3, 3]
    if len(centers) < 2:
        return 0.1
    diffs = centers[:, None, :] - centers[None, :, :]
    dists = np.linalg.norm(diffs, axis=-1)
    iu = np.triu_indices(len(centers), k=1)
    return float(0.1 * np.median(dists[iu]))


def segment_sky(image: np.ndarray) -> np.ndarray:
    """Heuristic sky mask (ref dust3r/viz.py:284-321): blue-hue + luminous
    low-saturation thresholds in HSV, morphological opening, then keep the
    family of largest connected components (every CC at least half the size
    of the biggest).

    The reference converts with COLOR_BGR2HSV while feeding RGB images —
    effectively computing hue on channel-swapped pixels; reproduced here
    (the blue sky lands in the 0-30 hue band).  image: (H, W, 3) float [0,1]
    or uint8 RGB.  Returns (H, W) bool.
    """
    import cv2
    from scipy import ndimage

    img = np.asarray(image)
    if np.issubdtype(img.dtype, np.floating):
        img = np.uint8(255 * img.clip(0, 1))
    hsv = cv2.cvtColor(img[..., ::-1], cv2.COLOR_RGB2HSV)  # ref quirk: BGR

    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    mask = (h <= 30) & (v >= 100)              # inRange((0,0,100),(30,255,255))
    mask |= (s < 10) & (v > 150)
    mask |= (s < 30) & (v > 180)
    mask |= (s < 50) & (v > 220)

    mask = ndimage.binary_opening(mask, structure=np.ones((5, 5), bool))
    labels, n = ndimage.label(mask, structure=np.ones((3, 3), int))
    if n == 0:
        return np.zeros(mask.shape, bool)
    sizes = ndimage.sum_labels(np.ones_like(labels), labels,
                               index=np.arange(1, n + 1))
    order = np.argsort(sizes)[::-1]
    keep = [1 + int(i) for i in order if sizes[i] > sizes[order[0]] / 2]
    return np.isin(labels, keep)


def camera_frustum_mesh(pose_c2w: np.ndarray, focal: Optional[float] = None,
                        imsize: Optional[Tuple[int, int]] = None,
                        color: Tuple[int, int, int] = (0, 0, 0),
                        cam_size: float = 0.03) -> dict:
    """Wireframe camera pyramid as a triangle mesh (ref add_scene_cam,
    dust3r/viz.py:192-258, which weaves three offset cone copies; here each
    of the 8 frustum edges becomes a thin triangular prism — same visual,
    no trimesh).

    pose_c2w: (4,4) OpenCV camera-to-world (+z forward).  Returns the mesh
    dict contract of export.pts3d_to_mesh.
    """
    pose = np.asarray(pose_c2w, np.float64)
    if imsize is not None:
        w, h = imsize
    else:
        w = h = 1.0
    if focal is None:
        focal = min(h, w) * 1.1
    focal = float(np.asarray(focal).ravel()[0])

    depth = focal * cam_size / h            # ref: height = focal*sw/H
    hx = cam_size / 2 * (w / h)             # ref: aspect-scaled half-extent
    hy = cam_size / 2
    apex = np.zeros(3)
    corners = np.array([[-hx, -hy, depth], [hx, -hy, depth],
                        [hx, hy, depth], [-hx, hy, depth]])
    edges = [(apex, c) for c in corners] + \
        [(corners[i], corners[(i + 1) % 4]) for i in range(4)]

    t = cam_size * 0.04                     # edge thickness
    verts: List[np.ndarray] = []
    faces: List[List[int]] = []
    for a, b in edges:
        d = b - a
        n1 = np.cross(d, [0.0, 0.0, 1.0])
        if np.linalg.norm(n1) < 1e-9:
            n1 = np.cross(d, [1.0, 0.0, 0.0])
        n1 = n1 / np.linalg.norm(n1) * t
        n2 = np.cross(d, n1)
        n2 = n2 / np.linalg.norm(n2) * t
        base = len(verts)
        verts += [a + n1, a - n1 + n2, a - n1 - n2,
                  b + n1, b - n1 + n2, b - n1 - n2]
        quads = [(0, 1, 4, 3), (1, 2, 5, 4), (2, 0, 3, 5)]
        for p, q, r, s in quads:
            faces.append([base + p, base + q, base + r])
            faces.append([base + p, base + r, base + s])

    v = np.asarray(verts, np.float64)
    v_world = v @ pose[:3, :3].T + pose[:3, 3]
    f = np.asarray(faces, np.uint32)
    col = np.tile(np.asarray(color, np.float32) / 255.0, (len(v), 1))
    tri_col = col[f[:, 0]]
    return dict(vertices=v_world.astype(np.float32), faces=f,
                face_colors=tri_col, vertex_colors=col)


class SceneViz:
    """Scene assembly: pointclouds + cameras -> one GLB
    (ref dust3r/viz.py:118-155)."""

    def __init__(self):
        self._pts: List[np.ndarray] = []
        self._cols: List[np.ndarray] = []
        self._meshes: List[dict] = []

    def add_pointcloud(self, pts3d, color=(128, 128, 128), mask=None):
        """pts3d: (..., 3) or list of arrays; color: one RGB or per-point
        array matching pts3d; mask selects valid points."""
        pts = np.concatenate([np.asarray(p).reshape(-1, 3) for p in pts3d]) \
            if isinstance(pts3d, (list, tuple)) else \
            np.asarray(pts3d).reshape(-1, 3)
        if mask is not None:
            m = (np.concatenate([np.asarray(x).ravel() for x in mask])
                 if isinstance(mask, (list, tuple))
                 else np.asarray(mask).ravel()).astype(bool)
            sel = pts[m]
        else:
            m = None
            sel = pts
        col_in = np.asarray(color)
        # uint8-vs-float is decided by DTYPE, not value range: (0, 0, 1)
        # uint8 is near-black, not full blue
        int_scale = 255.0 if np.issubdtype(col_in.dtype, np.integer) else 1.0
        col = col_in.astype(np.float32)
        if col.size <= 4:  # single color
            cols = np.tile(col.reshape(-1)[:3] / int_scale, (len(sel), 1))
        else:
            if isinstance(color, (list, tuple)):
                col = np.concatenate([np.asarray(c, np.float32).reshape(-1, 3)
                                      for c in color])
            cols = col.reshape(-1, 3) / int_scale
            if cols.max() > 1:  # float arrays in 0-255 convention
                cols = cols / 255.0
            if m is not None:
                cols = cols[m]
        self._pts.append(sel.astype(np.float32))
        self._cols.append(cols.astype(np.float32))
        return self

    def add_camera(self, pose_c2w, focal=None, color=(0, 0, 0), image=None,
                   imsize=None, cam_size=0.03):
        if imsize is None and image is not None:
            imsize = (image.shape[1], image.shape[0])
        self._meshes.append(camera_frustum_mesh(pose_c2w, focal, imsize,
                                                tuple(color), cam_size))
        return self

    def add_cameras(self, poses, focals=None, images=None, imsizes=None,
                    colors=None, **kw):
        def get(arr, i):
            return None if arr is None else arr[i]
        for i, pose in enumerate(poses):
            color = get(colors, i)  # may be an array row — no `or` truthiness
            if color is None:
                color = CAM_COLORS[i % len(CAM_COLORS)]
            self.add_camera(pose, get(focals, i), color=color,
                            image=get(images, i), imsize=get(imsizes, i), **kw)
        return self

    def add_mesh(self, mesh: dict):
        self._meshes.append(mesh)
        return self

    def save_glb(self, path: str) -> str:
        from .export import cat_meshes, write_glb_scene
        mesh = cat_meshes(self._meshes) if self._meshes else None
        pts = np.concatenate(self._pts) if self._pts else None
        cols = np.concatenate(self._cols) if self._pts else None
        write_glb_scene(path, mesh=mesh, points=pts, point_colors=cols)
        return path

    def show(self, path: Optional[str] = None, **kw) -> str:
        """Write the GLB; open an open3d viewer when available (the
        reference pops a trimesh window, dust3r/viz.py:154-155)."""
        import tempfile
        if path is None:
            fd = tempfile.NamedTemporaryFile(suffix=".glb", delete=False)
            path = fd.name
            fd.close()
        self.save_glb(path)
        try:
            import open3d as o3d  # pragma: no cover - not in this image
            geoms = []
            if self._pts:
                pc = o3d.geometry.PointCloud()
                pc.points = o3d.utility.Vector3dVector(
                    np.concatenate(self._pts).astype(np.float64))
                pc.colors = o3d.utility.Vector3dVector(
                    np.concatenate(self._cols).astype(np.float64))
                geoms.append(pc)
            o3d.visualization.draw_geometries(geoms)
        except ImportError:
            print(f"scene written to {path} (open3d not installed; "
                  f"open the GLB in any glTF viewer)")
        return path
