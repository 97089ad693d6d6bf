"""DTU MVS eval dataset (format contract from spann3r/datasets/dtu.py).

Layout: <ROOT>/<scan>/{images/NNNNNNNN.jpg, depths/*.npy, binary_masks/*.png,
cams/*_cam.txt (MVSNet format), pair.txt}.  Depth masked by an eroded
binary mask; frames consumed in reverse order (the reference pops from the
right of its deque).
"""
from __future__ import annotations

import os
import os.path as osp

import numpy as np

from ..utils.image import imread_cv2
from .base import BaseManyViewDataset


def load_cam_mvsnet(f, interval_scale=1.0):
    """MVSNet cam.txt parser (contract from ref dtu.py:50-91): 4x4 extrinsic
    (world2cam) + 3x3 intrinsic + optional depth-range row."""
    words = f.read().split()
    extrinsic = np.array(words[1:17], np.float32).reshape(4, 4)
    intrinsic4 = np.zeros((4, 4), np.float32)
    intrinsic4[:3, :3] = np.array(words[18:27], np.float32).reshape(3, 3)
    if len(words) >= 29:
        d0 = float(words[27])
        step = float(words[28]) * interval_scale
        n = float(words[29]) if len(words) >= 30 else 192.0
        dmax = float(words[30]) if len(words) == 31 else d0 + step * n
        intrinsic4[3] = (d0, step, n, dmax)
    return intrinsic4, extrinsic


class DTU(BaseManyViewDataset):
    def __init__(self, num_seq=49, num_frames=5, min_thresh=10, max_thresh=30,
                 test_id=None, full_video=False, sample_pairs=False,
                 kf_every=1, *args, ROOT, **kwargs):
        self.ROOT = ROOT
        super().__init__(*args, **kwargs)
        self.num_seq = num_seq
        self.num_frames = num_frames
        self.max_thresh = max_thresh
        self.min_thresh = min_thresh
        self.full_video = full_video
        self.kf_every = kf_every
        self.scene_list = self.resolve_scene_list(
            test_id, lambda: os.listdir(ROOT))

    def __len__(self):
        return len(self.scene_list) * self.num_seq

    def _pair_cluster(self, pairs_path, seq_id):
        """Frame tuple from a MVSNet pair.txt cluster (ref dtu.py:93-109).

        The reference reverses [ref]+cluster then consumes by right-pop,
        which nets out to processing [ref, c0, c1, ...] in order."""
        lines = open(pairs_path).read().splitlines()
        ref_idx = int(lines[2 * seq_id + 1])
        cluster = lines[2 * seq_id + 2].split()
        ids = ["{:08d}.jpg".format(int(cluster[2 * c + 1]))
               for c in range(self.num_frames)]
        return ["{:08d}.jpg".format(ref_idx)] + ids

    def _get_views(self, idx, resolution, rng, attempts=0):
        import cv2

        scene_id = self.scene_list[idx // self.num_seq]
        root = osp.join(self.ROOT, scene_id)

        if self.full_video:
            names = sorted(os.listdir(osp.join(root, "images")))
            # the reference consumes full-video frames by right-pop, i.e.
            # in reverse keyframe order — preserved for eval parity
            frame_ids = self.sample_frame_idx(names, rng, full_video=True)[::-1]
        else:
            frame_ids = self._pair_cluster(osp.join(root, "pair.txt"),
                                           idx % self.num_seq)

        def load_frame(name):
            rgb = imread_cv2(osp.join(root, "images", name))
            depth = np.nan_to_num(np.load(
                osp.join(root, "depths", name.replace(".jpg", ".npy"))
            ).astype(np.float32), 0.0)

            # eroded binary mask (ref dtu.py:145-154)
            mask = imread_cv2(osp.join(root, "binary_masks",
                                       name.replace(".jpg", ".png")),
                              cv2.IMREAD_UNCHANGED).astype(np.float32) / 255.0
            mask = (mask > 0.5).astype(np.float32)
            mask = cv2.resize(mask, (depth.shape[1], depth.shape[0]),
                              interpolation=cv2.INTER_NEAREST)
            mask = cv2.erode(mask, np.ones((10, 10), np.uint8), iterations=1)
            depth = depth * mask

            k4, extrinsic = load_cam_mvsnet(
                open(osp.join(root, "cams", name.replace(".jpg", "_cam.txt"))))
            pose = np.linalg.inv(extrinsic)
            return (rgb, depth, pose, k4[:3, :3],
                    osp.join(scene_id, name), name)

        return self.load_views(frame_ids, load_frame, resolution, rng,
                               "dtu", idx, attempts)
