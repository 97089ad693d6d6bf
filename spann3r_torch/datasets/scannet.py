"""ScanNet training dataset (format contract from spann3r/datasets/scannet.py).

Layout: <ROOT>/<scans|scans_test>/<scene>/sensor_data/frame-XXXXXX.{color.jpg,
depth.png,pose.txt} + intrinsic/intrinsic_depth.txt; split lists under
<ROOT>/splits/scannetv2_<split>.txt.  Depth in millimetres.
"""
from __future__ import annotations

import os
import os.path as osp

import numpy as np

from ..utils.image import imread_cv2
from .base import BaseManyViewDataset


class Scannet(BaseManyViewDataset):
    def __init__(self, num_seq=100, num_frames=5, min_thresh=10, max_thresh=100,
                 test_id=None, full_video=False, kf_every=1, *args, ROOT, **kwargs):
        self.ROOT = ROOT
        super().__init__(*args, **kwargs)
        self.num_seq = num_seq
        self.num_frames = num_frames
        self.max_thresh = max_thresh
        self.min_thresh = min_thresh
        self.full_video = full_video
        self.kf_every = kf_every
        self.folder = {"train": "scans", "val": "scans",
                       "test": "scans_test"}[self.split]
        self.scene_list = self.resolve_scene_list(test_id, self._discover)

    def _discover(self):
        meta = osp.join(self.ROOT, "splits", f"scannetv2_{self.split}.txt")
        if not osp.exists(meta):
            raise FileNotFoundError(f"Split file {meta} not found")
        return open(meta).read().splitlines()

    def __len__(self):
        return len(self.scene_list) * self.num_seq

    def _get_views(self, idx, resolution, rng, attempts=0):
        import cv2

        scene_id = self.scene_list[idx // self.num_seq]
        scene_dir = osp.join(self.ROOT, self.folder, scene_id)
        intrinsics = np.loadtxt(
            osp.join(scene_dir, "intrinsic/intrinsic_depth.txt")
        ).astype(np.float32)[:3, :3]
        data_path = osp.join(scene_dir, "sensor_data")
        n = sum("color" in f for f in os.listdir(data_path))
        frame_ids = self.sample_frame_idx([f"{i:06d}" for i in range(n)], rng,
                                          full_video=self.full_video)

        def load_frame(fid):
            stem = osp.join(data_path, f"frame-{fid}")
            rgb = imread_cv2(stem + ".color.jpg")
            depth = imread_cv2(stem + ".depth.png", cv2.IMREAD_UNCHANGED)
            rgb = cv2.resize(rgb, (depth.shape[1], depth.shape[0]))
            depth = np.nan_to_num(depth.astype(np.float32), 0.0) / 1000.0
            pose = np.loadtxt(stem + ".pose.txt").astype(np.float32)
            return (rgb, depth, pose, intrinsics,
                    osp.join(scene_id, fid), f"frame-{fid}.color.jpg")

        return self.load_views(frame_ids, load_frame, resolution, rng,
                               "scannet", idx, attempts)
