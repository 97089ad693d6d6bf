"""Visualization utilities (ref spann3r/tools/vis.py).

Open3D is optional in this environment; pointmap/confidence image dumps and
turntable renders are implemented with numpy/matplotlib, and the interactive
Open3D viewers activate only when open3d is importable.
"""
from __future__ import annotations

import os
import os.path as osp
from typing import Optional

import numpy as np


def _colormap(x: np.ndarray, cmap: str = "jet") -> np.ndarray:
    import matplotlib
    return matplotlib.colormaps[cmap](np.clip(x, 0, 1))[..., :3]


def pts_to_hsv_image(pts: np.ndarray) -> np.ndarray:
    """Pointmap XYZ -> HSV-ish color image in [0,1] (ref vis.py:135-201)."""
    lo = np.nanpercentile(pts, 2, axis=(0, 1))
    hi = np.nanpercentile(pts, 98, axis=(0, 1))
    return np.clip((pts - lo) / np.maximum(hi - lo, 1e-8), 0, 1)


def vis_pred_and_imgs(pts_all: np.ndarray, save_path: str,
                      images_all: Optional[np.ndarray] = None,
                      conf_all: Optional[np.ndarray] = None,
                      save_video: bool = True) -> None:
    """Save per-frame pointmap/conf/image PNGs (+ mp4 when imageio has
    ffmpeg), mirroring reference vis.py:135-201."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    for sub in ("pts", "imgs", "confs"):
        os.makedirs(osp.join(save_path, sub), exist_ok=True)

    frames = {"pts": [], "imgs": [], "confs": []}
    for i in range(len(pts_all)):
        pts_img = pts_to_hsv_image(pts_all[i])
        plt.imsave(osp.join(save_path, "pts", f"pts_{i:04d}.png"), pts_img)
        frames["pts"].append((pts_img * 255).astype(np.uint8))
        if images_all is not None:
            img = np.clip(images_all[i], 0, 1)
            plt.imsave(osp.join(save_path, "imgs", f"img_{i:04d}.png"), img)
            frames["imgs"].append((img * 255).astype(np.uint8))
        if conf_all is not None:
            cimg = _colormap(conf_all[i])
            plt.imsave(osp.join(save_path, "confs", f"conf_{i:04d}.png"), cimg)
            frames["confs"].append((cimg * 255).astype(np.uint8))

    if save_video:
        try:
            import imageio.v2 as imageio
            for name, fs in frames.items():
                if fs:
                    imageio.mimwrite(osp.join(save_path, f"{name}.mp4"), fs,
                                     fps=10)
        except Exception:
            pass  # video export is best-effort


def render_turntable(pts: np.ndarray, colors: np.ndarray, save_path: str,
                     n_views: int = 24, image_size: int = 512) -> None:
    """Matplotlib scatter turntable render — numpy fallback for the Open3D
    offscreen renderer (ref vis.py:17-76)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(save_path, exist_ok=True)
    p = pts.reshape(-1, 3)
    c = colors.reshape(-1, 3)
    if len(p) > 200_000:
        sel = np.random.default_rng(0).choice(len(p), 200_000, replace=False)
        p, c = p[sel], c[sel]
    center = p.mean(axis=0)
    p = p - center
    for k in range(n_views):
        ang = 2 * np.pi * k / n_views
        rot = np.array([[np.cos(ang), 0, np.sin(ang)],
                        [0, 1, 0],
                        [-np.sin(ang), 0, np.cos(ang)]])
        q = p @ rot.T
        order = np.argsort(q[:, 2])[::-1]
        fig, ax = plt.subplots(figsize=(image_size / 100, image_size / 100),
                               dpi=100)
        ax.scatter(q[order, 0], -q[order, 1], c=np.clip(c[order], 0, 1),
                   s=0.3, linewidths=0)
        ax.set_aspect("equal")
        ax.axis("off")
        fig.savefig(osp.join(save_path, f"render_{k:04d}.png"),
                    bbox_inches="tight")
        plt.close(fig)


def have_open3d() -> bool:
    try:
        import open3d  # noqa: F401
        return True
    except ImportError:
        return False


def render_frames(pts_all, images_all, camera_parameters, save_path,
                  mask=None, dynamic=False):
    """Open3D incremental render when available, else turntable fallback."""
    if not have_open3d():
        m = mask if mask is not None else np.ones(pts_all.shape[:-1], bool)
        render_turntable(pts_all[m], images_all[m], osp.join(save_path, "render"))
        return
    # Open3D path mirrors reference vis.py:17-76
    import open3d as o3d
    os.makedirs(osp.join(save_path, "render"), exist_ok=True)
    vis = o3d.visualization.Visualizer()
    vis.create_window(width=1024, height=576, visible=False)
    pcd = o3d.geometry.PointCloud()
    for i in range(len(pts_all)):
        m = mask[i] if mask is not None else np.ones(pts_all[i].shape[:-1], bool)
        pts = pts_all[i][m].reshape(-1, 3)
        col = images_all[i][m].reshape(-1, 3)
        if dynamic:
            pcd.points = o3d.utility.Vector3dVector(pts)
            pcd.colors = o3d.utility.Vector3dVector(col)
        else:
            pcd.points.extend(o3d.utility.Vector3dVector(pts))
            pcd.colors.extend(o3d.utility.Vector3dVector(col))
        vis.clear_geometries()
        vis.add_geometry(pcd)
        if camera_parameters is not None:
            vis.get_view_control().convert_from_pinhole_camera_parameters(
                camera_parameters)
        vis.poll_events()
        vis.update_renderer()
        vis.capture_screen_image(osp.join(save_path, "render",
                                          f"render_{i:04d}.png"))
    vis.destroy_window()


def find_render_cam(pcd, poses_all=None):
    """Interactive viewpoint picker — requires open3d + display
    (ref vis.py:98-133)."""
    if not have_open3d():
        return None
    import open3d as o3d
    vis = o3d.visualization.VisualizerWithKeyCallback()
    vis.create_window()
    vis.add_geometry(pcd)
    picked = {}

    def on_space(v):
        picked["cam"] = v.get_view_control(
        ).convert_to_pinhole_camera_parameters()
        v.close()
        return False

    vis.register_key_callback(ord(" "), on_space)
    vis.run()
    vis.destroy_window()
    return picked.get("cam")
