"""Procedural multi-view dataset: ray-cast box rooms with exact GT.

No direct reference counterpart.  The reference proves its training system
by "eval chamfer improves" on real capture datasets
(the reference's spann3r/training.py:94-168, 377-405); none of those assets
ship in this image, so this dataset supplies the equivalent measurable
signal from the CI-tested `habitat_gen.BoxRoomBackend` renderer
(exact planar depth, exact poses, checkerboard texture).  It powers the
synthetic convergence gate (tools/convergence_gate.py) and the int8
end-to-end accuracy gate, and doubles as an always-available smoke dataset
for the train/eval CLIs.

Scenes are deterministic in the item index: item `i` is always the same
room + camera trajectory, so before/after-training comparisons see
identical inputs.  The clip-sampling curriculum (train_ratio / thresholds)
still comes from BaseManyViewDataset like every other video adapter.
"""
from __future__ import annotations

import numpy as np

from ..habitat_gen.backends import BoxRoomBackend
from ..habitat_gen.geometry import (compute_camera_intrinsics,
                                    compute_camera_pose_opencv_convention,
                                    UP, look_at_for_habitat)
from .base import BaseManyViewDataset


class SynthRoom(BaseManyViewDataset):
    """`num_seq` procedurally generated room fly-throughs of `seq_len`
    frames each.  The camera orbits a fixed look-at target on a smooth
    horizontal arc with a slow height drift — consecutive frames strongly
    covisible, distant frames progressively less so, mimicking the video
    statistics the frame-sampling curriculum expects."""

    def __init__(self, num_seq=64, num_frames=5, min_thresh=1, max_thresh=3,
                 full_video=False, kf_every=1, seq_len=24, hfov=60.0,
                 scene_seed=0, cache=False, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.num_seq = num_seq
        self.num_frames = num_frames
        self.min_thresh = min_thresh
        self.max_thresh = max_thresh
        self.full_video = full_video
        self.kf_every = kf_every
        self.seq_len = seq_len
        self.hfov = hfov
        self.scene_seed = scene_seed
        # cache=True memoizes renders (scenes are deterministic in idx):
        # the convergence gate re-visits few scenes many times, and the
        # single-core host must not starve the TPU on ray-casting
        self.cache = cache
        self._scene_cache = {}
        self._render_cache = {}

    def __len__(self):
        return self.num_seq

    # ------------------------------------------------------------------
    def _scene(self, idx, resolution):
        """Deterministic (backend, trajectory) for item idx."""
        rng = np.random.default_rng(self.scene_seed * 1_000_003 + idx)
        w, h = resolution
        # render with margin so the training-crop augmentation has pixels
        rh, rw = int(round(h * 1.25)), int(round(w * 1.25))
        size = (float(rng.uniform(4.0, 8.0)),
                float(rng.uniform(2.6, 3.4)),
                float(rng.uniform(4.0, 9.0)))
        backend = BoxRoomBackend(resolution=(rh, rw), hfov=self.hfov,
                                 size=size,
                                 checker=float(rng.uniform(0.35, 0.8)),
                                 seed=int(rng.integers(0, 2**31)))
        sx, sy, sz = size
        # look-at target near the room centre, jittered
        target = np.array([sx / 2 + rng.uniform(-0.8, 0.8),
                           rng.uniform(0.8, sy - 0.8),
                           -sz / 2 + rng.uniform(-0.8, 0.8)])
        radius = rng.uniform(1.0, max(1.2, min(sx, sz) / 2 - 0.8))
        theta0 = rng.uniform(0.0, 2 * np.pi)
        span = np.deg2rad(rng.uniform(60.0, 140.0)) * rng.choice([-1.0, 1.0])
        h0, h1 = rng.uniform(0.6, sy - 0.6, size=2)

        poses = []
        m = 0.4
        for t in np.linspace(0.0, 1.0, self.seq_len):
            ang = theta0 + span * t
            eye = np.array([target[0] + radius * np.cos(ang),
                            h0 + (h1 - h0) * t,
                            target[2] + radius * np.sin(ang)])
            eye[0] = np.clip(eye[0], m, sx - m)
            eye[1] = np.clip(eye[1], m, sy - m)
            eye[2] = np.clip(eye[2], -sz + m, -m)
            orientation, _ = look_at_for_habitat(eye, target, UP)
            poses.append((eye, orientation))
        return backend, poses, (rh, rw)

    def _get_views(self, idx, resolution, rng):
        skey = (idx, tuple(resolution))
        if self.cache and skey in self._scene_cache:
            backend, poses, (rh, rw) = self._scene_cache[skey]
        else:
            backend, poses, (rh, rw) = self._scene(idx, resolution)
            if self.cache:
                self._scene_cache[skey] = (backend, poses, (rh, rw))
        frame_ids = self.sample_frame_idx(list(range(self.seq_len)), rng,
                                          full_video=self.full_video)
        f, cu, cv = compute_camera_intrinsics(rh, rw, self.hfov)
        k = np.array([[f, 0, cu], [0, f, cv], [0, 0, 1]], np.float32)

        def load_frame(fid):
            eye, orientation = poses[fid]
            if self.cache:
                ckey = (idx, fid, tuple(resolution))
                if ckey not in self._render_cache:
                    self._render_cache[ckey] = backend.render(eye, orientation)
                cached = self._render_cache[ckey]
                obs = {"color": cached["color"],
                       "depth": cached["depth"].copy()}
            else:
                obs = backend.render(eye, orientation)
            r, t = compute_camera_pose_opencv_convention(eye, orientation)
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = r
            pose[:3, 3] = t
            return (obs["color"], obs["depth"], pose, k.copy(),
                    f"synthroom/{idx:04d}/{fid:03d}", f"{fid:03d}")

        return self.load_views(frame_ids, load_frame, resolution, rng,
                               "synthroom", idx, allow_skip=False)
