"""Neural-RGBD eval dataset (ref spann3r/datasets/nrgbd.py)."""
from __future__ import annotations

import os
import os.path as osp
from collections import deque

import numpy as np

from ..utils.image import imread_cv2
from .base import BaseManyViewDataset


class NRGBD(BaseManyViewDataset):
    """Also serves Replica (BASELINE.md): the nice-slam-format Replica
    release uses the same on-disk layout (images/ depth/ poses.txt, gl
    poses, mm depth) — instantiate with ROOT pointing at the Replica dir
    (see the `Replica` alias below)."""

    def __init__(self, num_seq=1, num_frames=5, min_thresh=10, max_thresh=100,
                 test_id=None, full_video=False, tuple_path=None, seq_id=None,
                 kf_every=1, *args, ROOT, **kwargs):
        self.ROOT = ROOT
        super().__init__(*args, **kwargs)
        self.num_seq = num_seq
        self.num_frames = num_frames
        self.max_thresh = max_thresh
        self.min_thresh = min_thresh
        self.test_id = test_id
        self.full_video = full_video
        self.kf_every = kf_every
        self.seq_id = seq_id
        self.load_all_tuples(tuple_path)
        self.load_all_scenes(ROOT)

    def __len__(self):
        if self.tuple_list is not None:
            return len(self.tuple_list)
        return len(self.scene_list) * self.num_seq

    def load_all_tuples(self, tuple_path):
        if tuple_path is not None:
            with open(tuple_path) as f:
                self.tuple_list = f.read().splitlines()
        else:
            self.tuple_list = None

    def load_all_scenes(self, base_dir):
        if self.test_id is not None:
            self.scene_list = [self.test_id]
        else:
            self.scene_list = os.listdir(base_dir)

    @staticmethod
    def load_poses(path):
        """poses.txt: 4 lines per matrix; NaN rows marked invalid
        (ref nrgbd.py:59-75)."""
        with open(path) as f:
            lines = f.readlines()
        poses, valid = [], []
        for i in range(0, len(lines), 4):
            if "nan" in lines[i]:
                valid.append(False)
                poses.append(np.eye(4, dtype=np.float32).tolist())
            else:
                valid.append(True)
                poses.append([[float(x) for x in line.split()]
                              for line in lines[i:i + 4]])
        return np.array(poses, dtype=np.float32), valid

    def _get_views(self, idx, resolution, rng):
        import cv2

        if self.tuple_list is not None:
            line = self.tuple_list[idx].split(" ")
            scene_id, img_idxs = line[0], line[1:]
        else:
            scene_id = self.scene_list[idx // self.num_seq]
            n = len(os.listdir(osp.join(self.ROOT, scene_id, "images")))
            img_idxs = [f"{i}" for i in range(n)]
            img_idxs = self.sample_frame_idx(img_idxs, rng,
                                             full_video=self.full_video)

        k = np.array([[554.2562584220408, 0, 320],
                      [0, 554.2562584220408, 240], [0, 0, 1]], dtype=np.float32)
        camera_poses, _ = self.load_poses(osp.join(self.ROOT, scene_id, "poses.txt"))

        views = []
        for im_idx in deque(img_idxs):
            impath = osp.join(self.ROOT, scene_id, "images", f"img{im_idx}.png")
            depthpath = osp.join(self.ROOT, scene_id, "depth", f"depth{im_idx}.png")

            rgb_image = imread_cv2(impath)
            depthmap = imread_cv2(depthpath, cv2.IMREAD_UNCHANGED)
            depthmap = np.nan_to_num(depthmap.astype(np.float32), 0.0) / 1000.0
            depthmap[depthmap > 10] = 0
            depthmap[depthmap < 1e-3] = 0
            rgb_image = cv2.resize(rgb_image, (depthmap.shape[1], depthmap.shape[0]))

            camera_pose = camera_poses[int(im_idx)].copy()
            camera_pose[:, 1:3] *= -1.0  # gl -> cv (ref nrgbd.py:117-119)

            rgb_image, depthmap, intrinsics = self._crop_resize_if_necessary(
                rgb_image, depthmap, k, resolution, rng=rng, info=impath)

            views.append(dict(img=rgb_image, depthmap=depthmap,
                              camera_pose=camera_pose,
                              camera_intrinsics=intrinsics,
                              dataset="nrgbd",
                              label=osp.join(scene_id, im_idx),
                              instance=osp.split(impath)[1]))
        return views


class Replica(NRGBD):
    """Replica eval scenes in nice-slam format (same loader as NRGBD)."""

    def _get_views(self, idx, resolution, rng):
        views = super()._get_views(idx, resolution, rng)
        for v in views:
            v["dataset"] = "replica"
        return views
