"""Web demo on the port: video -> incremental reconstruction -> GLB (ref
app.py).

    python -m spann3r_torch.app --video FRAMES_OR_VIDEO [--device cpu]

Uses gradio when installed; otherwise `reconstruct()` serves programmatic
use (a plain HTTP fallback is out of scope). A video file needs ffmpeg; a
directory of frames is read as it is.
"""
import argparse
import os
import os.path as osp
import subprocess
import tempfile


def extract_frames(video_path: str, fps: int = 1) -> str:
    """ffmpeg video -> frames dir (ref app.py:26-36).

    A directory input is passed through untouched (frames already
    extracted), so the app also works where ffmpeg is unavailable."""
    if osp.isdir(video_path):
        return video_path
    import shutil
    if shutil.which("ffmpeg") is None:
        raise SystemExit("ffmpeg is not installed; pass a directory of "
                         "frames instead of a video file")
    temp_dir = tempfile.mkdtemp()
    output_path = osp.join(temp_dir, "%03d.jpg")
    subprocess.run(["ffmpeg", "-i", video_path, "-vf", f"fps={fps}",
                    output_path], check=True, capture_output=True)
    return temp_dir


def reconstruct(video_path: str, conf_thresh: float = 1e-3, kf_every: int = 1,
                as_pointcloud: bool = False,
                ckpt_path: str = "./checkpoints/spann3r.pth",
                resolution: int = 224, out_dir: str = "./output/app",
                device: str = "cuda"):
    """video -> conf-masked colored GLB: per-pixel triangle mesh by default,
    pointcloud with as_pointcloud=True (ref app.py:110-171, same default).
    Returns the GLB's path."""
    import numpy as np

    from . import demo as demo_cli
    from .api import reconstruct_video
    from .config import set_tf32_policy
    from .datasets import Demo
    from .datasets.loader import collate_views
    from .utils.export import (cat_meshes, pts3d_to_mesh, write_glb_mesh,
                               write_glb_pointcloud)

    set_tf32_policy()
    args = demo_cli.get_args_parser().parse_args([])
    args.ckpt_path = ckpt_path
    args.resolution = resolution
    args.device = device
    model, cfg, prec = demo_cli.load_model(args)

    frames_dir = extract_frames(video_path)
    dataset = Demo(ROOT=frames_dir, resolution=resolution, full_video=True,
                   kf_every=kf_every)
    batch = collate_views([dataset[0]])
    preds, _, _ = reconstruct_video(model, cfg, batch["img"], prec)

    # viewer orientation: ref app.py:166-168 applies inv(OPENGL @ roty180)
    # to the trimesh scene; for diagonal factors that is diag(-1,-1,1)
    view_tf = np.diag([-1.0, -1.0, 1.0]).astype(np.float32)

    pts_f, cols_f, masks_f = [], [], []
    for j, pr in enumerate(preds):
        key = "pts3d" if j == 0 else "pts3d_in_other_view"
        p = np.asarray(pr[key], np.float32)[0] * 10.0  # ref app.py:143 scale
        c = np.asarray(pr["conf"], np.float32)[0]
        pts_f.append(p @ view_tf.T)
        cols_f.append((np.asarray(batch["img"][j, 0]) + 1.0) / 2.0)
        masks_f.append((c - 1.0) / c > conf_thresh)

    os.makedirs(out_dir, exist_ok=True)
    glb_path = osp.join(out_dir, "recon.glb")
    if as_pointcloud:
        pts = np.concatenate([p[m] for p, m in zip(pts_f, masks_f)])
        cols = np.concatenate([c[m] for c, m in zip(cols_f, masks_f)])
        write_glb_pointcloud(glb_path, pts, cols)
    else:
        meshes = [pts3d_to_mesh(img, p, valid=m)
                  for img, p, m in zip(cols_f, pts_f, masks_f)]
        mesh = cat_meshes(meshes)
        write_glb_mesh(glb_path, mesh["vertices"], mesh["faces"],
                       mesh["vertex_colors"])
    return glb_path


def launch_ui(device: str = "cuda"):
    try:
        import gradio as gr
    except ImportError:
        raise SystemExit("gradio is not installed in this environment; use "
                         "`python -m spann3r_torch.app --video <path>` or "
                         "call spann3r_torch.app.reconstruct() directly")

    demo_ui = gr.Interface(
        fn=lambda video, conf, kf, aspc: reconstruct(
            video, conf, int(kf), as_pointcloud=aspc, device=device),
        inputs=[gr.Video(), gr.Slider(0, 0.1, value=1e-3, label="conf"),
                gr.Slider(1, 30, value=1, step=1, label="keyframe every"),
                gr.Checkbox(value=False, label="As pointcloud")],
        outputs=gr.Model3D(),
        title="Spann3R: streaming 3D reconstruction")
    demo_ui.launch()


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--video", type=str, default=None,
                    help="run headless on a video file (or a directory of "
                         "frames) instead of the UI")
    ap.add_argument("--conf_thresh", type=float, default=1e-3)
    ap.add_argument("--kf_every", type=int, default=1)
    ap.add_argument("--as_pointcloud", action="store_true")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    a = ap.parse_args()
    if a.video:
        print(reconstruct(a.video, a.conf_thresh, a.kf_every,
                          as_pointcloud=a.as_pointcloud, device=a.device))
    else:
        launch_ui(a.device)
