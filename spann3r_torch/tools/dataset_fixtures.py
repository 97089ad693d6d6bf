"""Small trees in the on-disk layout of each training dataset, from a seed.

    write_tree(kind, root, seed=0, scenes=1, frames=20, shrink=1) -> kwargs

writes `scenes` scenes of `frames` frames under `root` in the layout that
`datasets.<kind>` reads (the reference's files: images, depth maps in each
dataset's encoding, poses and intrinsics in each one's convention), and
returns the keyword arguments that build the dataset on it (ROOT and, where
the dataset needs them, the split, the scene list or the sampler's
thresholds). Image and depth sizes are each dataset's raw capture sizes
(`RAW_SIZES`), divided by `shrink` for tests. Every scene is a camera
moving along a short arc in front of a textured wall: valid positive depth
everywhere, finite poses. The CPU tests hold the port's dataset copies to
the JAX package's on these trees, and chip_smoke.py trains on them.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np
import PIL.Image

# (width, height) of the raw color image and of the raw depth map
RAW_SIZES: Dict[str, Tuple[Tuple[int, int], Tuple[int, int]]] = {
    "Scannet": ((1296, 968), (640, 480)),       # color resized to depth
    "Scannetpp": ((1752, 1168), (1752, 1168)),  # undistorted DSLR
    "ArkitScene": ((256, 192), (256, 192)),     # lowres_wide / lowres_depth
    "BlendMVS": ((768, 576), (768, 576)),
    "Co3d": ((1000, 750), (1000, 750)),
    "habitat": ((256, 256), (256, 256)),        # habitat_gen's default
}
KINDS = ("Scannet", "Scannetpp", "ArkitScene", "BlendMVS", "Co3d", "habitat")


def _size(kind, shrink, depth=False):
    w, h = RAW_SIZES[kind][1 if depth else 0]
    return max(w // shrink, 16), max(h // shrink, 12)


def _intrinsics(w, h):
    return np.array([[0.8 * w, 0, w / 2], [0, 0.8 * w, h / 2], [0, 0, 1]],
                    np.float32)


def _pose(i, frames):
    """cam2world (OpenCV axes): a slow yaw and a sideways drift."""
    a = 0.3 * (i / max(frames - 1, 1) - 0.5)
    c, s = np.cos(a), np.sin(a)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    pose[:3, 3] = [0.4 * a, 0.05 * np.sin(3 * a), -0.2 * a]
    return pose


def _frame(rng, cw, ch, dw, dh):
    """A color image (uint8 HWC) and a depth map in metres (float32)."""
    base = rng.integers(0, 256, (max(ch // 8, 2), max(cw // 8, 2), 3),
                        dtype=np.uint8)
    color = np.asarray(PIL.Image.fromarray(base).resize((cw, ch),
                                                        PIL.Image.NEAREST))
    y, x = np.mgrid[0:dh, 0:dw].astype(np.float32)
    depth = (2.0 + 0.3 * np.sin(x / dw * 6.0 + rng.random())
             + 0.2 * y / dh).astype(np.float32)
    return color, depth


def _jpg(path, color):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    PIL.Image.fromarray(color).save(path, quality=95)


def _png16(path, depth, scale):
    import cv2
    os.makedirs(os.path.dirname(path), exist_ok=True)
    cv2.imwrite(path, np.round(depth * scale).clip(0, 65535).astype(np.uint16))


def _scannet(root, rng, scenes, frames, shrink):
    cw, ch = _size("Scannet", shrink)
    dw, dh = _size("Scannet", shrink, depth=True)
    names = [f"scene{i:04d}_00" for i in range(scenes)]
    os.makedirs(os.path.join(root, "splits"), exist_ok=True)
    with open(os.path.join(root, "splits", "scannetv2_train.txt"), "w") as f:
        f.write("\n".join(names))
    for name in names:
        d = os.path.join(root, "scans", name)
        k = np.eye(4)
        k[:3, :3] = _intrinsics(dw, dh)
        os.makedirs(os.path.join(d, "intrinsic"), exist_ok=True)
        np.savetxt(os.path.join(d, "intrinsic", "intrinsic_depth.txt"), k)
        for i in range(frames):
            color, depth = _frame(rng, cw, ch, dw, dh)
            stem = os.path.join(d, "sensor_data", f"frame-{i:06d}")
            _jpg(stem + ".color.jpg", color)
            _png16(stem + ".depth.png", depth, 1000.0)
            np.savetxt(stem + ".pose.txt", _pose(i, frames))
    return {"split": "train"}


def _scannetpp(root, rng, scenes, frames, shrink):
    w, h = _size("Scannetpp", shrink)
    names = [f"{i:010x}" for i in range(1, scenes + 1)]
    os.makedirs(os.path.join(root, "splits"), exist_ok=True)
    with open(os.path.join(root, "splits", "nvs_sem_train.txt"), "w") as f:
        f.write("\n".join(names))
    k = _intrinsics(w, h)
    for name in names:
        d = os.path.join(root, "data", name, "dslr")
        meta = {"fl_x": float(k[0, 0]), "fl_y": float(k[1, 1]),
                "cx": float(k[0, 2]), "cy": float(k[1, 2]), "frames": []}
        files = []
        for i in range(frames):
            fname = f"DSC{i:05d}.JPG"
            color, depth = _frame(rng, w, h, w, h)
            _jpg(os.path.join(d, "undistorted_images", fname), color)
            _png16(os.path.join(d, "undistorted_depths",
                                fname.replace(".JPG", ".png")), depth, 1000.0)
            pose = _pose(i, frames)
            pose[:, 1:3] *= -1.0   # stored as OpenGL cam2world
            meta["frames"].append({"file_path": fname,
                                   "transform_matrix": pose.tolist()})
            files.append(fname)
        os.makedirs(os.path.join(d, "nerfstudio"), exist_ok=True)
        with open(os.path.join(d, "nerfstudio",
                               "transforms_undistorted.json"), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(d, "train_test_lists.json"), "w") as f:
            json.dump({"train": files, "test": []}, f)
    return {"split": "train"}


def _arkit(root, rng, scenes, frames, shrink):
    import cv2
    w, h = _size("ArkitScene", shrink)
    k = _intrinsics(w, h)
    for v in range(scenes):
        video = f"{41000000 + v}"
        d = os.path.join(root, "raw", "Training", video)
        lines = []
        for i in range(frames):
            stamp = f"{100.0 + 0.1 * i:.3f}"
            color, depth = _frame(rng, w, h, w, h)
            _jpg(os.path.join(d, "lowres_wide", f"{video}_{stamp}.png"), color)
            _png16(os.path.join(d, "lowres_depth", f"{video}_{stamp}.png"),
                   depth, 1000.0)
            os.makedirs(os.path.join(d, "lowres_wide_intrinsics"),
                        exist_ok=True)
            with open(os.path.join(d, "lowres_wide_intrinsics",
                                   f"{video}_{stamp}.pincam"), "w") as f:
                f.write(f"{w} {h} {k[0, 0]} {k[1, 1]} {k[0, 2]} {k[1, 2]}")
            ext = np.linalg.inv(_pose(i, frames).astype(np.float64))
            rvec = cv2.Rodrigues(ext[:3, :3])[0].ravel()
            lines.append(" ".join([stamp] + [f"{x:.9f}" for x in rvec]
                                  + [f"{x:.9f}" for x in ext[:3, 3]]))
        with open(os.path.join(d, "lowres_wide.traj"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return {"split": "train"}


def _blendmvs(root, rng, scenes, frames, shrink):
    import cv2
    w, h = _size("BlendMVS", shrink)
    k = _intrinsics(w, h)
    names = [f"5a{i:022x}" for i in range(scenes)]
    with open(os.path.join(root, "train_list.txt"), "w") as f:
        f.write("\n".join(names))
    for name in names:
        d = os.path.join(root, name)
        for sub in ("blended_images", "rendered_depth_maps", "cams"):
            os.makedirs(os.path.join(d, sub), exist_ok=True)
        for i in range(frames):
            color, depth = _frame(rng, w, h, w, h)
            _jpg(os.path.join(d, "blended_images", f"{i:08d}.jpg"), color)
            cv2.imwrite(os.path.join(d, "rendered_depth_maps", f"{i:08d}.pfm"),
                        depth)
            ext = np.linalg.inv(_pose(i, frames).astype(np.float64))
            with open(os.path.join(d, "cams", f"{i:08d}_cam.txt"), "w") as f:
                f.write("extrinsic\n")
                f.write("\n".join(" ".join(f"{x:.9f}" for x in r) for r in ext))
                f.write("\n\nintrinsic\n")
                f.write("\n".join(" ".join(f"{x:.6f}" for x in r) for r in k))
                f.write("\n\n1.0 0.01 192 3.0\n")
        # each image's cluster: its 10 nearest frames, with scores
        with open(os.path.join(d, "cams", "pair.txt"), "w") as f:
            f.write(f"{frames}\n")
            for i in range(frames):
                near = sorted((j for j in range(frames) if j != i),
                              key=lambda j: abs(j - i))[:10]
                f.write(f"{i}\n{len(near)} "
                        + " ".join(f"{j} {100.0 / (1 + abs(j - i)):.2f}"
                                   for j in near) + "\n")
    return {"split": "train"}


def _co3d(root, rng, scenes, frames, shrink):
    import cv2
    w, h = _size("Co3d", shrink)
    k = _intrinsics(w, h)
    index = {"teddybear": {}}
    for s in range(scenes):
        inst = f"{100 + s}_{11000 + s}_{22000 + s}"
        d = os.path.join(root, "teddybear", inst)
        fids = list(range(1, frames + 1))
        index["teddybear"][inst] = fids
        for i, fid in enumerate(fids):
            color, depth = _frame(rng, w, h, w, h)
            max_depth = float(depth.max()) * 1.05
            _jpg(os.path.join(d, "images", f"frame{fid:06d}.jpg"), color)
            np.savez(os.path.join(d, "images", f"frame{fid:06d}.npz"),
                     camera_pose=_pose(i, frames), camera_intrinsics=k,
                     maximum_depth=np.float32(max_depth))
            _png16(os.path.join(d, "depths",
                                f"frame{fid:06d}.jpg.geometric.png"),
                   depth / max_depth, 65535.0)
            mask = np.full((h, w), 255, np.uint8)
            mask[: h // 10] = 0   # background rows
            os.makedirs(os.path.join(d, "masks"), exist_ok=True)
            cv2.imwrite(os.path.join(d, "masks", f"frame{fid:06d}.png"), mask)
    with open(os.path.join(root, "selected_seqs_train.json"), "w") as f:
        json.dump(index, f)
    return {"split": "train", "use_comb": False}


def _habitat(root, rng, scenes, frames, shrink):
    """Clips of 5 views rendered by habitat_gen's box-room backend (the
    generator's own seeded sampling), `frames` clips a scene."""
    from ..habitat_gen.scripts import generate_multiview_images_for_scene
    res = _size("habitat", shrink)
    for s in range(scenes):
        generate_multiview_images_for_scene(
            scene_dataset_config_file="", scene="__boxroom__", navmesh="",
            output_dir=os.path.join(root, "boxroom", f"scene{s}"),
            views_count=5, size=frames, generate_depth=True, resolution=res,
            hfov=60, minimum_covisibility=0.2, seed=int(rng.integers(1 << 30)))
    return {"num_seq": frames}


_WRITERS = {"Scannet": _scannet, "Scannetpp": _scannetpp,
            "ArkitScene": _arkit, "BlendMVS": _blendmvs, "Co3d": _co3d,
            "habitat": _habitat}


def write_tree(kind: str, root: str, seed: int = 0, scenes: int = 1,
               frames: int = 20, shrink: int = 1) -> Dict:
    """Write the tree of `kind` (one of KINDS) under `root`; return the
    keyword arguments (ROOT included) that build the dataset on it."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    kw = _WRITERS[kind](root, rng, scenes, frames, shrink)
    return {"ROOT": root, **kw}


def expression(kind: str, kw: Dict, n: int, resolution, num_frames: int = 5,
               seed: int = 777) -> str:
    """`n @ Kind(...)` in the registry's expression form, with the sampler's
    thresholds cut to a short fixture video."""
    args = dict(kw, resolution=resolution, num_frames=num_frames, seed=seed)
    if kind != "habitat":
        args.update(num_seq=4, min_thresh=1, max_thresh=3)
    body = ", ".join(f"{k}={v!r}" for k, v in args.items())
    return f"{n} @ {kind}({body})"
