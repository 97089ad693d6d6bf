"""Training-time augmentation for stereo and flow pairs.

Reference: croco/stereoflow/augmentor.py (StereoAugmentor, FlowAugmentor —
themselves after unimatch's transforms).  Same operation set, probabilities
and parameter ranges; photometric ops reuse the repo's torchvision-exact
PIL reimplementations (datasets/base.py, parity-tested in
test_color_jitter.py).  All randomness flows through a
np.random.Generator so augmentation is seedable per worker.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from PIL import Image

import cv2

cv2.setNumThreads(0)

from ..datasets.base import (ColorJitter, adjust_brightness, adjust_contrast,
                             adjust_hue, adjust_saturation)


def adjust_gamma(image: Image.Image, gamma: float,
                 gain: float = 1.0) -> Image.Image:
    """torchvision F_pil.adjust_gamma: 255*gain*(x/255)^gamma, clamped."""
    arr = np.asarray(image).astype(np.float32) / 255.0
    out = 255.0 * gain * np.power(arr, gamma)
    return Image.fromarray(np.clip(out, 0, 255).astype(np.uint8))


class StereoAugmentor:
    """ref augmentor.py:25-157: x-only random scale (threshold-dependent
    range), random crop, vertical flip, right-image rotate/shift jitter,
    then asymmetric-capable photometric chain."""

    def __init__(self, crop_size, scale_prob=0.5, scale_xonly=True,
                 lhth=800., lminscale=0.0, lmaxscale=1.0, hminscale=-0.2,
                 hmaxscale=0.4, scale_interp_nearest=True,
                 rightjitterprob=0.5, v_flip_prob=0.5, color_aug_asym=True,
                 color_choice_prob=0.5,
                 rng: Optional[np.random.Generator] = None):
        self.crop_size = crop_size
        self.scale_prob = scale_prob
        self.scale_xonly = scale_xonly
        self.lhth = lhth
        self.lminscale, self.lmaxscale = lminscale, lmaxscale
        self.hminscale, self.hmaxscale = hminscale, hmaxscale
        self.scale_interp_nearest = scale_interp_nearest
        self.rightjitterprob = rightjitterprob
        self.v_flip_prob = v_flip_prob
        self.color_aug_asym = color_aug_asym
        self.color_choice_prob = color_choice_prob
        self.rng = rng or np.random.default_rng()

    def _random_scale(self, img1, img2, disp):
        """ref augmentor.py:42-66: small images get [0,1] log2-scale, large
        get [-0.2,0.4]; always clipped so a crop fits."""
        ch, cw = self.crop_size
        h, w = img1.shape[:2]
        r = self.rng
        interp_d = (cv2.INTER_NEAREST if self.scale_interp_nearest
                    else cv2.INTER_LINEAR)
        if self.scale_prob > 0. and r.random() < self.scale_prob:
            mn, mx = ((self.lminscale, self.lmaxscale)
                      if min(h, w) < self.lhth
                      else (self.hminscale, self.hmaxscale))
            scale_x = 2. ** r.uniform(mn, mx)
            scale_x = np.clip(scale_x, (cw + 8) / float(w), None)
            scale_y = 1.
            if not self.scale_xonly:
                scale_y = np.clip(scale_x, (ch + 8) / float(h), None)
            img1 = cv2.resize(img1, None, fx=scale_x, fy=scale_y,
                              interpolation=cv2.INTER_LINEAR)
            img2 = cv2.resize(img2, None, fx=scale_x, fy=scale_y,
                              interpolation=cv2.INTER_LINEAR)
            disp = cv2.resize(disp, None, fx=scale_x, fy=scale_y,
                              interpolation=interp_d) * scale_x
        else:
            clip_scale = (cw + 8) / float(w)
            if clip_scale > 1.:
                scale_x = clip_scale
                scale_y = scale_x if not self.scale_xonly else 1.0
                img1 = cv2.resize(img1, None, fx=scale_x, fy=scale_y,
                                  interpolation=cv2.INTER_LINEAR)
                img2 = cv2.resize(img2, None, fx=scale_x, fy=scale_y,
                                  interpolation=cv2.INTER_LINEAR)
                disp = cv2.resize(disp, None, fx=scale_x, fy=scale_y,
                                  interpolation=interp_d) * scale_x
        return img1, img2, disp

    def _random_crop(self, img1, img2, disp):
        h, w = img1.shape[:2]
        ch, cw = self.crop_size
        assert ch <= h and cw <= w, (img1.shape, ch, cw)
        ox = self.rng.integers(w - cw + 1)
        oy = self.rng.integers(h - ch + 1)
        return (img1[oy:oy + ch, ox:ox + cw], img2[oy:oy + ch, ox:ox + cw],
                disp[oy:oy + ch, ox:ox + cw])

    def _random_vflip(self, img1, img2, disp):
        if self.v_flip_prob > 0 and self.rng.random() < self.v_flip_prob:
            img1 = np.copy(np.flipud(img1))
            img2 = np.copy(np.flipud(img2))
            disp = np.copy(np.flipud(disp))
        return img1, img2, disp

    def _random_rotate_shift_right(self, img2):
        """ref augmentor.py:87-97: sub-degree rotation + sub-pixel vertical
        shift of the right image only."""
        if self.rightjitterprob > 0. and self.rng.random() < \
                self.rightjitterprob:
            r = self.rng
            angle, pixel = 0.1, 2
            px = r.uniform(-pixel, pixel)
            ag = r.uniform(-angle, angle)
            center = (r.uniform(0, img2.shape[0]), r.uniform(0, img2.shape[1]))
            rot = cv2.getRotationMatrix2D(center, ag, 1.0)
            img2 = cv2.warpAffine(img2, rot, img2.shape[1::-1],
                                  flags=cv2.INTER_LINEAR)
            trans = np.float32([[1, 0, 0], [0, 1, px]])
            img2 = cv2.warpAffine(img2, trans, img2.shape[1::-1],
                                  flags=cv2.INTER_LINEAR)
        return img2

    def _asym(self, op, img1, img2, lo, hi):
        """Apply op with one factor, re-drawing for img2 half the time when
        asymmetric color is on (ref augmentor.py:99-132)."""
        r = self.rng
        f = r.uniform(lo, hi)
        img1 = op(img1, f)
        if self.color_aug_asym and r.random() < 0.5:
            f = r.uniform(lo, hi)
        return img1, op(img2, f)

    def _random_color(self, img1, img2):
        r = self.rng
        trfs = [
            lambda a, b: ((a, b) if r.random() >= 0.5 else
                          self._asym(adjust_contrast, a, b, 0.8, 1.2)),
            lambda a, b: ((a, b) if r.random() >= 0.5 else
                          self._asym(adjust_gamma, a, b, 0.7, 1.5)),
            lambda a, b: ((a, b) if r.random() >= 0.5 else
                          self._asym(adjust_brightness, a, b, 0.5, 2.0)),
            lambda a, b: ((a, b) if r.random() >= 0.5 else
                          self._asym(adjust_hue, a, b, -0.1, 0.1)),
            # NOTE: the reference re-draws the asymmetric saturation factor
            # from uniform(-0.8, 1.2) (augmentor.py:131) — a sign typo vs
            # every other op; negative saturation inverts chroma.  Kept as
            # the sane uniform(0.8, 1.2).
            lambda a, b: ((a, b) if r.random() >= 0.5 else
                          self._asym(adjust_saturation, a, b, 0.8, 1.2)),
        ]
        img1 = Image.fromarray(img1.astype("uint8"))
        img2 = Image.fromarray(img2.astype("uint8"))
        if r.random() < self.color_choice_prob:
            t = trfs[r.integers(len(trfs))]
            img1, img2 = t(img1, img2)
        else:
            for i in r.permutation(len(trfs)):
                img1, img2 = trfs[i](img1, img2)
        return (np.array(img1).astype(np.float32),
                np.array(img2).astype(np.float32))

    def __call__(self, img1, img2, disp, dataset_name):
        img1, img2, disp = self._random_scale(img1, img2, disp)
        img1, img2, disp = self._random_crop(img1, img2, disp)
        img1, img2, disp = self._random_vflip(img1, img2, disp)
        img2 = self._random_rotate_shift_right(img2)
        img1, img2 = self._random_color(img1, img2)
        return img1, img2, disp


class FlowAugmentor:
    """ref augmentor.py:161-289: isotropic scale + stretch, h/v flips with
    flow sign fixes, crop, then symmetric-or-asymmetric ColorJitter."""

    def __init__(self, crop_size, min_scale=-0.2, max_scale=0.5,
                 spatial_aug_prob=0.8, stretch_prob=0.8, max_stretch=0.2,
                 h_flip_prob=0.5, v_flip_prob=0.1,
                 asymmetric_color_aug_prob=0.2,
                 rng: Optional[np.random.Generator] = None):
        self.crop_size = crop_size
        self.min_scale, self.max_scale = min_scale, max_scale
        self.spatial_aug_prob = spatial_aug_prob
        self.stretch_prob = stretch_prob
        self.max_stretch = max_stretch
        self.h_flip_prob = h_flip_prob
        self.v_flip_prob = v_flip_prob
        self.asymmetric_color_aug_prob = asymmetric_color_aug_prob
        self.rng = rng or np.random.default_rng()
        self.photo_aug = ColorJitter(brightness=0.4, contrast=0.4,
                                     saturation=0.4, hue=0.5 / 3.14,
                                     rng=self.rng)

    def _jitter(self, img: np.ndarray) -> np.ndarray:
        params = self.photo_aug.get_params()
        out = ColorJitter.apply(Image.fromarray(img), *params)
        return np.array(out, dtype=np.uint8)

    def color_transform(self, img1, img2):
        """ref augmentor.py:183-197: one jitter per image (asymmetric) or
        one jitter of the stacked pair (symmetric)."""
        if self.rng.random() < self.asymmetric_color_aug_prob:
            return self._jitter(img1), self._jitter(img2)
        stack = np.concatenate([img1, img2], axis=0)
        stack = self._jitter(stack)
        img1, img2 = np.split(stack, 2, axis=0)
        return img1, img2

    def _resize_flow(self, flow, scale_x, scale_y, factor=1.0):
        """Dense bilinear resize + value rescale, or the sparse
        scatter-based variant when invalid pixels exist
        (ref augmentor.py:199-235)."""
        if np.all(np.isfinite(flow)):
            flow = cv2.resize(flow, None, fx=scale_x / factor,
                              fy=scale_y / factor,
                              interpolation=cv2.INTER_LINEAR)
            flow = flow * [scale_x, scale_y]
            return flow
        ht, wd = flow.shape[:2]
        coords = np.stack(np.meshgrid(np.arange(wd), np.arange(ht)),
                          axis=-1).reshape(-1, 2).astype(np.float32)
        flow = flow.reshape(-1, 2).astype(np.float32)
        valid = np.isfinite(flow[:, 0])
        coords0, flow0 = coords[valid], flow[valid]
        ht1 = int(round(ht * scale_y / factor))
        wd1 = int(round(wd * scale_x / factor))
        rescale = np.array([[scale_x, scale_y]], np.float32)
        coords1 = coords0 * rescale / factor
        flow1 = flow0 * rescale
        xx = np.round(coords1[:, 0]).astype(np.int32)
        yy = np.round(coords1[:, 1]).astype(np.int32)
        v = (xx > 0) & (xx < wd1) & (yy > 0) & (yy < ht1)
        out = np.full([ht1, wd1, 2], np.inf, dtype=np.float32)
        out[yy[v], xx[v]] = flow1[v]
        return out

    def spatial_transform(self, img1, img2, flow, dname):
        r = self.rng
        if r.random() < self.spatial_aug_prob:
            ht, wd = img1.shape[:2]
            clip_min = np.maximum((self.crop_size[0] + 8) / float(ht),
                                  (self.crop_size[1] + 8) / float(wd))
            scale = 2 ** r.uniform(self.min_scale, self.max_scale)
            scale_x = scale_y = scale
            if r.random() < self.stretch_prob:
                scale_x *= 2 ** r.uniform(-self.max_stretch, self.max_stretch)
                scale_y *= 2 ** r.uniform(-self.max_stretch, self.max_stretch)
            scale_x = np.clip(scale_x, clip_min, None)
            scale_y = np.clip(scale_y, clip_min, None)
            img1 = cv2.resize(img1, None, fx=scale_x, fy=scale_y,
                              interpolation=cv2.INTER_LINEAR)
            img2 = cv2.resize(img2, None, fx=scale_x, fy=scale_y,
                              interpolation=cv2.INTER_LINEAR)
            flow = self._resize_flow(
                flow, scale_x, scale_y,
                factor=2.0 if dname == "Spring" else 1.0)
        elif dname == "Spring":
            flow = self._resize_flow(flow, 1.0, 1.0, factor=2.0)

        if self.h_flip_prob > 0. and r.random() < self.h_flip_prob:
            img1 = img1[:, ::-1]
            img2 = img2[:, ::-1]
            flow = flow[:, ::-1] * [-1.0, 1.0]
        if self.v_flip_prob > 0. and r.random() < self.v_flip_prob:
            img1 = img1[::-1, :]
            img2 = img2[::-1, :]
            flow = flow[::-1, :] * [1.0, -1.0]

        y0 = (r.integers(0, img1.shape[0] - self.crop_size[0])
              if img1.shape[0] - self.crop_size[0] > 0 else 0)
        x0 = (r.integers(0, img1.shape[1] - self.crop_size[1])
              if img1.shape[1] - self.crop_size[1] > 0 else 0)
        img1 = img1[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        img2 = img2[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        flow = flow[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        return img1, img2, flow

    def __call__(self, img1, img2, flow, dname):
        img1, img2, flow = self.spatial_transform(img1, img2, flow, dname)
        img1, img2 = self.color_transform(np.ascontiguousarray(
            img1, dtype=np.uint8), np.ascontiguousarray(img2, dtype=np.uint8))
        return (np.ascontiguousarray(img1), np.ascontiguousarray(img2),
                np.ascontiguousarray(flow))
