"""ARKitScenes dataset (format contract from spann3r/datasets/arkit.py).

Layout: <ROOT>/raw/<Training|Validation>/<video>/{lowres_wide/,<...>_depth/,
lowres_wide_intrinsics/*.pincam, lowres_wide.traj}.  Trajectory lines are
`timestamp axis-angle(3) translation(3)` world->cam, inverted, with the
ARKit axis swizzle + gl->cv conversion applied afterwards.
"""
from __future__ import annotations

import os
import os.path as osp

import numpy as np

from ..utils.image import imread_cv2
from .base import BaseManyViewDataset


def traj_string_to_matrix(traj_string: str):
    """.traj line -> (timestamp, inverted extrinsic) (ref arkit.py:92-117)."""
    import cv2
    tokens = traj_string.split()
    assert len(tokens) == 7
    rot, _ = cv2.Rodrigues(np.asarray([float(t) for t in tokens[1:4]]))
    ext = np.eye(4)
    ext[:3, :3] = rot
    ext[:3, 3] = [float(t) for t in tokens[4:7]]
    return tokens[0], np.linalg.inv(ext)


class ArkitScene(BaseManyViewDataset):
    def __init__(self, num_seq=100, num_frames=5, min_thresh=10, max_thresh=50,
                 test_id=None, full_video=False, kf_every=1, *args, ROOT, **kwargs):
        self.ROOT = ROOT
        super().__init__(*args, **kwargs)
        self.num_seq = num_seq
        self.num_frames = num_frames
        self.max_thresh = max_thresh
        self.min_thresh = min_thresh
        self.full_video = full_video
        self.kf_every = kf_every
        if test_id is None:
            sub = {"train": "Training", "val": "Validation"}[self.split]
            self.scene_path = osp.join(ROOT, "raw", sub)
            self.scene_list = os.listdir(self.scene_path)
        else:
            self.scene_path = ROOT
            self.scene_list = self.resolve_scene_list(test_id, list)

    def __len__(self):
        return len(self.scene_list) * self.num_seq

    def _intrinsics(self, intr_dir, frame_id, video_id):
        """Nerfstudio-style .pincam lookup with +-1ms timestamp slop
        (ref arkit.py:57-71)."""
        for stamp in (frame_id, f"{float(frame_id) - 0.001:.3f}",
                      f"{float(frame_id) + 0.001:.3f}"):
            fn = osp.join(intr_dir, f"{video_id}_{stamp}.pincam")
            if osp.exists(fn):
                _, _, fx, fy, hw, hh = np.loadtxt(fn)
                return np.asarray([[fx, 0, hw], [0, fy, hh], [0, 0, 1]],
                                  dtype=np.float32)
        return None

    @staticmethod
    def _pose_at(frame_id, traj):
        """Timestamped pose lookup with 0.1s slop + ARKit axis swizzle
        (ref arkit.py:73-90)."""
        pose = traj.get(str(frame_id))
        if pose is None:
            for key, val in traj.items():
                if abs(float(frame_id) - float(key)) < 0.1:
                    pose = val
                    break
        if pose is None:
            return None
        pose = np.array(pose)
        pose[0:3, 1:3] *= -1
        pose = pose[np.array([1, 0, 2, 3]), :]
        pose[2, :] *= -1
        pose = pose.astype(np.float32)
        pose[:, 1:3] *= -1.0  # gl -> cv
        return pose

    def _get_views(self, idx, resolution, rng, attempts=0):
        import cv2

        scene_id = self.scene_list[idx // self.num_seq]
        root = osp.join(self.scene_path, scene_id)
        img_dir = osp.join(root, "lowres_wide")
        depth_dir = osp.join(root, "lowres_depth")
        intr_dir = osp.join(root, "lowres_wide_intrinsics")
        traj_path = osp.join(root, "lowres_wide.traj")

        if not all(map(osp.exists, (img_dir, depth_dir, intr_dir, traj_path))):
            return self.resample(resolution, rng)
        stamps = [x.split(".png")[0].split("_")[1]
                  for x in sorted(os.listdir(depth_dir))]
        if len(stamps) < self.num_frames:
            return self.resample(resolution, rng)
        frame_ids = self.sample_frame_idx(stamps, rng,
                                          full_video=self.full_video)

        traj = {}
        for line in open(traj_path, encoding="utf-8"):
            ts, mat = traj_string_to_matrix(line)
            traj[f"{round(float(ts), 3):.3f}"] = np.array(mat.tolist())

        def load_frame(fid):
            impath = osp.join(img_dir, f"{scene_id}_{fid}.png")
            dpath = osp.join(depth_dir, f"{scene_id}_{fid}.png")
            pose = self._pose_at(fid, traj)
            k = self._intrinsics(intr_dir, fid, scene_id)
            if pose is None or k is None or not osp.exists(impath) \
                    or not osp.exists(dpath):
                return None  # missing asset -> resample
            rgb = imread_cv2(impath)
            depth = imread_cv2(dpath, cv2.IMREAD_UNCHANGED)
            depth = np.nan_to_num(depth.astype(np.float32), 0.0) / 1000.0
            return rgb, depth, pose, k, osp.join(scene_id, fid), f"{scene_id}_{fid}.png"

        return self.load_views(frame_ids, load_frame, resolution, rng,
                               "arkit", idx, attempts)
