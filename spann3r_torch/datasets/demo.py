"""Images-only demo dataset (contract from spann3r/datasets/demo.py:11-98).

Loads any folder of jpg/png/heic frames; optional <stem>.npz metadata
(camera_pose / camera_intrinsics / maximum_depth) and <stem>_depth.png
16-bit depth.  Without metadata, pseudo-intrinsics (f=1, centered pp) and
identity poses make the pipeline run end-to-end.
"""
from __future__ import annotations

import os
import os.path as osp

import numpy as np

from ..utils.image import imread_cv2
from .base import BaseManyViewDataset

EXTS = (".jpg", ".jpeg", ".png", ".heic")


class Demo(BaseManyViewDataset):
    def __init__(self, num_seq=1, num_frames=5, min_thresh=10, max_thresh=100,
                 full_video=True, kf_every=1, *args, ROOT, **kwargs):
        self.ROOT = ROOT
        super().__init__(*args, **kwargs)
        self.num_seq = num_seq
        self.num_frames = num_frames
        self.max_thresh = max_thresh
        self.min_thresh = min_thresh
        self.full_video = full_video
        self.kf_every = kf_every

    def __len__(self):
        return self.num_seq

    def _list_frames(self):
        names = [n for n in sorted(os.listdir(self.ROOT))
                 if n.lower().endswith(EXTS) and "depth" not in n.lower()]
        if not names:
            raise FileNotFoundError(
                f"no images ({'/'.join(EXTS)}) found in {self.ROOT}")
        return names

    @staticmethod
    def _read_rgb(path):
        if path.lower().endswith(".heic"):
            import PIL.Image
            return np.array(PIL.Image.open(path).convert("RGB"))
        return imread_cv2(path)

    def _get_views(self, idx, resolution, rng):
        import cv2

        names = self.sample_frame_idx(self._list_frames(), rng,
                                      full_video=self.full_video)

        def load_frame(name):
            path = osp.join(self.ROOT, name)
            rgb = self._read_rgb(path)
            stem = path.rsplit(".", 1)[0]

            meta = np.load(stem + ".npz") if osp.exists(stem + ".npz") else None
            if meta is not None:
                pose = meta["camera_pose"].astype(np.float32)
                k = meta["camera_intrinsics"].astype(np.float32)
            else:
                pose = np.eye(4, dtype=np.float32)
                k = np.array([[1.0, 0, rgb.shape[1] // 2],
                              [0, 1.0, rgb.shape[0] // 2],
                              [0, 0, 1]], dtype=np.float32)

            if osp.exists(stem + "_depth.png"):
                depth = imread_cv2(stem + "_depth.png", cv2.IMREAD_UNCHANGED)
                depth = (depth.astype(np.float32) / 65535) * \
                    np.nan_to_num(meta["maximum_depth"])
            else:
                depth = np.ones(rgb.shape[:2], dtype=np.float32)
            rgb = cv2.resize(rgb, (depth.shape[1], depth.shape[0]))
            return rgb, depth, pose, k, path, name

        return self.load_views(names, load_frame, resolution, rng,
                               "demo", idx, allow_skip=False)
