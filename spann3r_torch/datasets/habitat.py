"""Habitat pre-rendered 5-frame clips (format from spann3r/datasets/habitat.py).

Layout: <ROOT>/<dataset>/<scene>/<seq:08d>_<i>.jpeg + _depth.exr +
_camera_params.json (R_cam2world / t_cam2world / camera_intrinsics).
Frames within a clip are shuffled each draw.
"""
from __future__ import annotations

import json
import os
import os.path as osp

import numpy as np

from ..utils.image import imread_cv2
from .base import BaseManyViewDataset


class habitat(BaseManyViewDataset):  # noqa: N801 — name kept for config parity
    def __init__(self, num_seq=200, num_frames=5, *args, ROOT, **kwargs):
        self.ROOT = ROOT
        super().__init__(*args, **kwargs)
        self.num_seq = num_seq
        self.num_frames = num_frames
        self.full_video = False
        self.scene_list = [(d, s) for d in os.listdir(ROOT)
                           for s in os.listdir(osp.join(ROOT, d))]

    def __len__(self):
        return len(self.scene_list) * self.num_seq

    def _get_views(self, idx, resolution, rng, attempts=0):
        import cv2

        data, scene = self.scene_list[idx // self.num_seq]
        seq_id = idx % self.num_seq
        root = osp.join(self.ROOT, data, scene)

        order = list(range(1, self.num_frames + 1))
        rng.shuffle(order)

        def load_frame(i):
            stem = osp.join(root, f"{seq_id:08}_{i}")
            if not osp.exists(stem + ".jpeg"):
                return None  # missing clip -> resample another item
            rgb = imread_cv2(stem + ".jpeg")
            if osp.exists(stem + "_depth.exr"):
                depth = imread_cv2(stem + "_depth.exr", cv2.IMREAD_UNCHANGED)
            else:
                # habitat_gen fallback when cv2 lacks an EXR codec
                depth = np.load(stem + "_depth.npy").astype(np.float32)
            cam = json.load(open(stem + "_camera_params.json"))
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = np.array(cam["R_cam2world"], dtype=np.float32)
            pose[:3, 3] = np.array(cam["t_cam2world"], dtype=np.float32)
            k = np.array(cam["camera_intrinsics"], dtype=np.float32)
            return rgb, depth, pose, k, osp.join(data, scene), f"{seq_id:08}_{i}.jpeg"

        return self.load_views(order, load_frame, resolution, rng,
                               "habitat", idx, attempts, allow_skip=False)
