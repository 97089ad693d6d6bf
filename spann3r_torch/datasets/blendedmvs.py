"""BlendedMVS dataset (format contract from spann3r/datasets/blendedmvs.py).

Layout: <ROOT>/<scene>/{blended_images/NNNNNNNN.jpg,
rendered_depth_maps/*.pfm, cams/*_cam.txt + pair.txt}; split lists at
<ROOT>/<split>_list.txt.  Clip sampling draws a pair.txt cluster; scenes
with extreme depth-range ratios are resampled.
"""
from __future__ import annotations

import os
import os.path as osp

import numpy as np

from ..utils.image import imread_cv2
from .base import BaseManyViewDataset


class BlendMVS(BaseManyViewDataset):
    def __init__(self, num_seq=100, num_frames=5, min_thresh=10, max_thresh=30,
                 test_id=None, full_video=False, kf_every=1, *args, ROOT, **kwargs):
        self.ROOT = ROOT
        super().__init__(*args, **kwargs)
        self.num_seq = num_seq
        self.num_frames = num_frames
        self.max_thresh = max_thresh
        self.min_thresh = min_thresh
        self.full_video = full_video
        self.kf_every = kf_every
        self.scene_list = self.resolve_scene_list(test_id, self._discover)

    def _discover(self):
        meta = osp.join(self.ROOT, f"{self.split}_list.txt")
        if not osp.exists(meta):
            raise FileNotFoundError(f"Split file {meta} not found")
        return open(meta).read().splitlines()

    def __len__(self):
        return len(self.scene_list) * self.num_seq

    def _sample_cluster(self, pairs_path, rng, max_trials=10):
        """Random pair.txt cluster with enough neighbours
        (ref blendedmvs.py:35-63); None after max_trials."""
        lines = open(pairs_path).read().splitlines()
        image_num = int(lines[0])
        for _ in range(max_trials):
            si = int(rng.choice(image_num))
            ref_idx = int(lines[2 * si + 1])
            cluster = lines[2 * si + 2].split()
            total = int(cluster[0])
            if total <= self.num_frames - 1:
                continue
            chosen = rng.choice(total, self.num_frames - 1, replace=False)
            ids = ["{:08d}.jpg".format(ref_idx)] + \
                ["{:08d}.jpg".format(int(cluster[2 * c + 1])) for c in chosen]
            if rng.choice([True, False]):
                ids.reverse()
            return ids
        return None

    def _get_views(self, idx, resolution, rng, attempts=0):
        import cv2

        scene_id = self.scene_list[idx // self.num_seq]
        root = osp.join(self.ROOT, scene_id)

        if self.full_video:
            names = sorted(os.listdir(osp.join(root, "blended_images")))
            frame_ids = names[::self.kf_every]
        else:
            frame_ids = self._sample_cluster(osp.join(root, "cams", "pair.txt"),
                                             rng)
            if frame_ids is None:
                return self.resample(resolution, rng)

        depth_maxes = []

        def load_frame(name):
            rgb = imread_cv2(osp.join(root, "blended_images", name))
            depth = imread_cv2(osp.join(root, "rendered_depth_maps",
                                        name.replace(".jpg", ".pfm")),
                               cv2.IMREAD_UNCHANGED)
            depth = np.nan_to_num(depth.astype(np.float32), 0.0)

            campath = osp.join(root, "cams", name.replace(".jpg", "_cam.txt"))
            with open(campath) as f:
                rt = np.loadtxt(f, skiprows=1, max_rows=4, dtype=np.float32)
                k = np.loadtxt(f, skiprows=2, max_rows=3, dtype=np.float32)
            pose = np.linalg.inv(rt)

            # principal-point margin check (ref blendedmvs.py:143-150)
            h, w = rgb.shape[:2]
            cx, cy = k[:2, 2].round().astype(int)
            if min(cx, w - cx) <= w / 5 or min(cy, h - cy) <= h / 5:
                return None
            depth_maxes.append(float(depth.max()))
            return rgb, depth, pose, k[:3, :3], osp.join(scene_id, name), name

        views = self.load_views(frame_ids, load_frame, resolution, rng,
                                "blendmvs", idx, attempts)
        # depth-range rejection (ref blendedmvs.py:186-189)
        if depth_maxes:
            d_max, d_min, d_first = (max(depth_maxes), min(depth_maxes),
                                     depth_maxes[0])
            if d_max / max(d_min, 1e-8) > 100.0 \
                    or d_max / max(d_first, 1e-8) > 10.0:
                return self.resample(resolution, rng)
        return views
