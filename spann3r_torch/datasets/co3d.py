"""CO3Dv2 dataset (format contract from spann3r/datasets/co3d.py).

Layout: <ROOT>/<category>/<instance>/{images/frameNNNNNN.jpg + .npz metadata,
depths/frameNNNNNN.jpg.geometric.png (uint16 scaled by maximum_depth),
masks/frameNNNNNN.png}; the scene index lives in selected_seqs_<split>.json.

Sampling: either combinatorial 5-frame tuples with stride-5 spacing and
+-4 jitter, or the generic monotone clip sampler.  Per-image failures
invalidate the image and walk to a neighbour; scenes with a >100x depth
range (or >10x vs the first frame) are resampled wholesale.
"""
from __future__ import annotations

import itertools
import json
import os.path as osp

import numpy as np

from ..utils.image import imread_cv2
from .base import BaseManyViewDataset


class Co3d(BaseManyViewDataset):
    def __init__(self, mask_bg=True, use_comb=True, scene_class=None,
                 scene_id=None, num_seq=100, num_frames=5, min_thresh=5,
                 max_thresh=20, full_video=False, lb=0, ub=30, kf_every=1,
                 *args, ROOT, **kwargs):
        self.ROOT = ROOT
        super().__init__(*args, **kwargs)
        assert mask_bg in (True, False, "rand")
        self.mask_bg = mask_bg
        self.num_seq = num_seq
        self.num_frames = num_frames
        self.max_thresh = max_thresh
        self.min_thresh = min_thresh
        self.full_video = full_video
        self.kf_every = kf_every
        self.use_comb = use_comb
        self.scenes, self.scene_list = self._load_index(scene_class, scene_id)
        self.combinations = self._tuples(lb, ub) if (use_comb and
                                                     not full_video) else None
        if self.combinations is not None:
            self.num_seq = len(self.combinations)
        self.invalidate = {scene: {} for scene in self.scene_list}

    def _tuples(self, lb, ub):
        """Combinatorial frame tuples with stride-5 spacing (ref co3d.py:41-53)."""
        return [c for c in itertools.combinations(range(100), self.num_frames)
                if all(lb < abs(x - y) <= ub and abs(x - y) % 5 == 0
                       for x, y in zip(c, c[1:]))]

    def _load_index(self, scene_class, scene_id):
        with open(osp.join(self.ROOT, f"selected_seqs_{self.split}.json")) as f:
            raw = json.load(f)
        scenes = {}
        for cat, instances in raw.items():
            if scene_class is not None and cat != scene_class:
                continue
            for inst, frames in instances.items():
                if scene_id is not None and inst != scene_id:
                    continue
                if frames:
                    scenes[(cat, inst)] = frames
        return scenes, list(scenes.keys())

    def __len__(self):
        return len(self.scene_list) * self.num_seq

    def _pick_frames(self, idx, pool_len, rng):
        if self.combinations is not None:
            combo = self.combinations[idx % len(self.combinations)]
            last = pool_len - 1
            return [max(0, min(i + rng.integers(-4, 5), last)) for i in combo]
        return self.sample_frames(range(pool_len), rng)

    def _skip_invalid(self, invalid, im_idx, pool_len, rng):
        """Walk from an invalidated image to a nearby valid one
        (ref co3d.py:112-119)."""
        direction = 2 * int(rng.choice(2)) - 1
        for off in range(1, pool_len):
            cand = (im_idx + direction * off) % pool_len
            if not invalid[cand]:
                return cand
        return im_idx

    def _get_views(self, idx, resolution, rng):
        import cv2
        from collections import deque

        obj, instance = self.scene_list[idx // self.num_seq]
        pool = self.scenes[obj, instance]
        inval = self.invalidate[obj, instance].setdefault(
            resolution, [False] * len(pool))
        mask_bg = (self.mask_bg is True) or \
            (self.mask_bg == "rand" and rng.choice(2))
        root = osp.join(self.ROOT, obj, instance)

        views = []
        depth_stats = []
        queue = deque(self._pick_frames(idx, len(pool), rng))
        while queue:
            im_idx = queue.popleft()
            if inval[im_idx]:
                im_idx = self._skip_invalid(inval, im_idx, len(pool), rng)
            fid = pool[im_idx]
            impath = osp.join(root, "images", f"frame{fid:06d}.jpg")
            meta = np.load(impath.replace("jpg", "npz"))
            rgb = imread_cv2(impath)
            depth = imread_cv2(osp.join(root, "depths",
                                        f"frame{fid:06d}.jpg.geometric.png"),
                               cv2.IMREAD_UNCHANGED)
            depth = (depth.astype(np.float32) / 65535) * \
                np.nan_to_num(meta["maximum_depth"])
            if mask_bg:
                m = imread_cv2(osp.join(root, "masks", f"frame{fid:06d}.png"),
                               cv2.IMREAD_UNCHANGED).astype(np.float32)
                depth *= (m / 255.0) > 0.1

            rgb, depth, k = self._crop_resize_if_necessary(
                rgb, depth, meta["camera_intrinsics"].astype(np.float32),
                resolution, rng=rng, info=impath)

            if (depth > 0.0).sum() == 0:
                inval[im_idx] = True          # invalidate + retry this slot
                queue.appendleft(im_idx)
                continue

            depth_stats.append(float(meta["maximum_depth"]))
            views.append(dict(img=rgb, depthmap=depth,
                              camera_pose=meta["camera_pose"].astype(np.float32),
                              camera_intrinsics=k, dataset="Co3d_v2",
                              label=osp.join(obj, instance),
                              instance=osp.split(impath)[1]))

        # depth-ratio rejection (ref co3d.py:174-176)
        d_max, d_min, d_first = (max(depth_stats), min(depth_stats),
                                 depth_stats[0])
        if d_max / max(d_min, 1e-8) > 100.0 or d_max / max(d_first, 1e-8) > 10.0:
            return self.resample(resolution, rng)
        return views
