"""ScanNet++ dataset (format contract from spann3r/datasets/scannetpp.py).

Layout: <ROOT>/data/<scene>/dslr/{undistorted_images,undistorted_depths,
nerfstudio/transforms_undistorted.json,train_test_lists.json}; splits under
<ROOT>/splits/nvs_sem_<split>.txt.  Poses are OpenGL cam2world.
"""
from __future__ import annotations

import json
import os.path as osp

import numpy as np

from ..utils.image import imread_cv2
from .base import BaseManyViewDataset


class Scannetpp(BaseManyViewDataset):
    def __init__(self, num_seq=100, num_frames=5, min_thresh=5, max_thresh=30,
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
        meta = osp.join(self.ROOT, "splits", f"nvs_sem_{self.split}.txt")
        if not osp.exists(meta):
            raise FileNotFoundError(f"Split file {meta} not found")
        return open(meta).read().splitlines()

    def __len__(self):
        return len(self.scene_list) * self.num_seq

    def _get_views(self, idx, resolution, rng, attempts=0):
        import cv2

        scene_id = self.scene_list[idx // self.num_seq]
        dslr = osp.join(self.ROOT, "data", scene_id, "dslr")
        meta = json.load(open(osp.join(dslr, "nerfstudio",
                                       "transforms_undistorted.json")))
        intrinsics = np.array([[meta["fl_x"], 0, meta["cx"]],
                               [0, meta["fl_y"], meta["cy"]],
                               [0, 0, 1]], dtype=np.float32)
        pose_of = {fr["file_path"]: np.array(fr["transform_matrix"],
                                             dtype=np.float32)
                   for fr in meta["frames"]}
        train_list = json.load(open(osp.join(dslr, "train_test_lists.json")))
        frame_ids = self.sample_frame_idx(sorted(train_list["train"]), rng,
                                          full_video=self.full_video)

        def load_frame(fid):
            rgb = imread_cv2(osp.join(dslr, "undistorted_images", fid))
            depth = imread_cv2(osp.join(dslr, "undistorted_depths",
                                        fid.replace(".JPG", ".png")),
                               cv2.IMREAD_UNCHANGED)
            depth = np.nan_to_num(depth.astype(np.float32), 0.0) / 1000.0
            pose = pose_of[fid].copy()
            pose[:, 1:3] *= -1.0  # gl -> cv
            return (rgb, depth, pose, intrinsics.copy(),
                    osp.join(scene_id, fid), fid)

        return self.load_views(frame_ids, load_frame, resolution, rng,
                               "scannetpp", idx, attempts)
