"""Dataset base classes (torch-free numpy pipeline).

Implements the reference's view contract (dust3r BaseStereoViewDataset) and
size algebra (EasyDataset: `2 * ds`, `10000 @ ds`, `ds1 + ds2`) over plain
numpy.  Views are dicts:
    img:        (H, W, 3) float32, normalized to [-1, 1]   (NHWC, TPU layout)
    depthmap:   (H, W) float32
    camera_pose:(4, 4) float32 cam2world
    camera_intrinsics: (3, 3) float32
    pts3d:      (H, W, 3) float32 world frame (derived)
    valid_mask: (H, W) bool (derived)
    true_shape: (2,) int32
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import PIL.Image

from ..utils.geometry import depthmap_to_absolute_camera_coordinates
from . import cropping


def img_norm(image: PIL.Image.Image) -> np.ndarray:
    """ToTensor + Normalize(0.5, 0.5) equivalent, HWC float32."""
    arr = np.asarray(image, dtype=np.float32) / 255.0
    return (arr - 0.5) / 0.5


def adjust_brightness(image: PIL.Image.Image, factor: float) -> PIL.Image.Image:
    """torchvision F_pil.adjust_brightness (ImageEnhance.Brightness)."""
    from PIL import ImageEnhance
    return ImageEnhance.Brightness(image).enhance(factor)


def adjust_contrast(image: PIL.Image.Image, factor: float) -> PIL.Image.Image:
    """torchvision F_pil.adjust_contrast (ImageEnhance.Contrast)."""
    from PIL import ImageEnhance
    return ImageEnhance.Contrast(image).enhance(factor)


def adjust_saturation(image: PIL.Image.Image, factor: float) -> PIL.Image.Image:
    """torchvision F_pil.adjust_saturation (ImageEnhance.Color)."""
    from PIL import ImageEnhance
    return ImageEnhance.Color(image).enhance(factor)


def adjust_hue(image: PIL.Image.Image, factor: float) -> PIL.Image.Image:
    """torchvision F_pil.adjust_hue: shift the PIL-HSV hue channel by
    uint8(factor*255) with wraparound, then convert back to RGB."""
    if not -0.5 <= factor <= 0.5:
        raise ValueError(f"hue factor {factor} not in [-0.5, 0.5]")
    h, s, v = image.convert("HSV").split()
    np_h = np.asarray(h, dtype=np.uint8)
    # uint8 wraparound add, identical to torchvision F_pil's
    # `np_h += np.uint8(hue_factor * 255)`: C-style truncation toward zero,
    # then mod-256 wrap
    np_h = (np_h.astype(np.int16) + int(factor * 255)) % 256
    h = PIL.Image.fromarray(np_h.astype(np.uint8), "L")
    return PIL.Image.merge("HSV", (h, s, v)).convert("RGB")


class ColorJitter:
    """torchvision.ColorJitter(0.5, 0.5, 0.5, 0.1) + ImgNorm semantics
    (ref dust3r/datasets/utils/transforms.py:11): factors drawn uniformly,
    the four adjustments applied in a RANDOM ORDER per call, PIL backend
    ops — parity-tested against torchvision in tests/test_color_jitter.py."""

    def __init__(self, brightness=0.5, contrast=0.5, saturation=0.5, hue=0.1,
                 rng: Optional[np.random.Generator] = None):
        self.b, self.c, self.s, self.h = brightness, contrast, saturation, hue
        self.rng = rng or np.random.default_rng()

    def get_params(self):
        """(op_order, b, c, s, h) like torchvision ColorJitter.get_params."""
        r = self.rng
        order = r.permutation(4)
        b = float(r.uniform(max(0, 1 - self.b), 1 + self.b)) if self.b else None
        c = float(r.uniform(max(0, 1 - self.c), 1 + self.c)) if self.c else None
        s = float(r.uniform(max(0, 1 - self.s), 1 + self.s)) if self.s else None
        h = float(r.uniform(-self.h, self.h)) if self.h else None
        return order, b, c, s, h

    @staticmethod
    def apply(image: PIL.Image.Image, order, b, c, s, h) -> PIL.Image.Image:
        for idx in order:
            if idx == 0 and b is not None:
                image = adjust_brightness(image, b)
            elif idx == 1 and c is not None:
                image = adjust_contrast(image, c)
            elif idx == 2 and s is not None:
                image = adjust_saturation(image, s)
            elif idx == 3 and h is not None:
                image = adjust_hue(image, h)
        return image

    def __call__(self, image: PIL.Image.Image) -> np.ndarray:
        return img_norm(self.apply(image, *self.get_params()))


class EasyDataset:
    """Size algebra: `2 * ds`, `10000 @ ds`, `ds1 + ds2`
    (ref dust3r/datasets/base/easy_dataset.py)."""

    def __add__(self, other):
        return CatDataset([self, other])

    def __rmul__(self, factor):
        return MulDataset(factor, self)

    def __rmatmul__(self, factor):
        return ResizedDataset(factor, self)

    def set_epoch(self, epoch):
        pass

    def set_ratio(self, train_ratio):
        pass


class MulDataset(EasyDataset):
    def __init__(self, multiplicator: int, dataset):
        assert isinstance(multiplicator, int) and multiplicator > 0
        self.multiplicator = multiplicator
        self.dataset = dataset

    def __len__(self):
        return self.multiplicator * len(self.dataset)

    def __repr__(self):
        return f"{self.multiplicator}*{self.dataset!r}"

    def __getitem__(self, idx):
        if isinstance(idx, tuple):
            idx, other = idx
            return self.dataset[idx // self.multiplicator, other]
        return self.dataset[idx // self.multiplicator]

    @property
    def _resolutions(self):
        return self.dataset._resolutions


class ResizedDataset(EasyDataset):
    def __init__(self, new_size: int, dataset):
        assert isinstance(new_size, int) and new_size > 0
        self.new_size = new_size
        self.dataset = dataset

    def __len__(self):
        return self.new_size

    def __repr__(self):
        return f"{self.new_size} @ {self.dataset!r}"

    def set_epoch(self, epoch):
        # epoch-seeded reshuffle with rotary extension (ref easy_dataset.py:92-103)
        rng = np.random.default_rng(seed=epoch + 777)
        perm = rng.permutation(len(self.dataset))
        reps = 1 + (len(self) - 1) // len(self.dataset)
        self._idxs_mapping = np.concatenate([perm] * reps)[:self.new_size]

    def set_ratio(self, train_ratio):
        self.dataset.train_ratio = train_ratio

    def __getitem__(self, idx):
        assert hasattr(self, "_idxs_mapping"), "call set_epoch() first"
        if isinstance(idx, tuple):
            idx, other = idx
            return self.dataset[self._idxs_mapping[idx], other]
        return self.dataset[self._idxs_mapping[idx]]

    @property
    def _resolutions(self):
        return self.dataset._resolutions


class CatDataset(EasyDataset):
    def __init__(self, datasets):
        for ds in datasets:
            assert isinstance(ds, EasyDataset)
        self.datasets = datasets
        self._cum_sizes = np.cumsum([len(ds) for ds in datasets])

    def __len__(self):
        return int(self._cum_sizes[-1])

    def __repr__(self):
        return " + ".join(repr(ds) for ds in self.datasets)

    def set_epoch(self, epoch):
        for ds in self.datasets:
            ds.set_epoch(epoch)

    def set_ratio(self, train_ratio):
        for ds in self.datasets:
            ds.set_ratio(train_ratio)

    def __getitem__(self, idx):
        other = None
        if isinstance(idx, tuple):
            idx, other = idx
        if not (0 <= idx < len(self)):
            raise IndexError(idx)
        db_idx = int(np.searchsorted(self._cum_sizes, idx, "right"))
        new_idx = idx - (self._cum_sizes[db_idx - 1] if db_idx > 0 else 0)
        ds = self.datasets[db_idx]
        return ds[(new_idx, other)] if other is not None else ds[new_idx]

    @property
    def _resolutions(self):
        res = self.datasets[0]._resolutions
        for ds in self.datasets[1:]:
            assert tuple(ds._resolutions) == tuple(res)
        return res


class BaseViewDataset(EasyDataset):
    """Multi-view dataset contract (ref base_stereo_view_dataset.py:63-119).

    Subclasses implement `_get_views(idx, resolution, rng) -> list[dict]`
    returning raw views with PIL image / depthmap / intrinsics / pose.
    """

    def __init__(self, *, split=None, resolution=None, transform=None,
                 aug_crop=False, seed=None):
        self.num_views = 2
        self.split = split
        self._set_resolutions(resolution)
        self.transform = transform if transform is not None else img_norm
        if isinstance(self.transform, str):
            self.transform = {"ColorJitter": ColorJitter(),
                              "ImgNorm": img_norm}[self.transform]
        self.aug_crop = aug_crop
        self.seed = seed
        self.train_ratio = 1.0

    def __len__(self):
        return len(self.scenes)

    def __repr__(self):
        res = ";".join(f"{w}x{h}" for w, h in self._resolutions)
        return (f"{type(self).__name__}(split={self.split}, "
                f"resolutions=[{res}])")

    def _set_resolutions(self, resolutions):
        assert resolutions is not None, "undefined resolution"
        if not isinstance(resolutions, list):
            resolutions = [resolutions]
        self._resolutions = []
        for r in resolutions:
            w, h = (r, r) if isinstance(r, int) else r
            assert isinstance(w, int) and isinstance(h, int) and w >= h
            self._resolutions.append((w, h))

    def _get_views(self, idx, resolution, rng) -> List[dict]:
        raise NotImplementedError

    def _crop_resize_if_necessary(self, image, depthmap, intrinsics,
                                  resolution, rng=None, info=None):
        return cropping.crop_resize_if_necessary(
            image, depthmap, intrinsics, resolution, rng=rng,
            aug_crop=self.aug_crop, info=info)

    def __getitem__(self, idx):
        if isinstance(idx, tuple):
            idx, ar_idx = idx
        else:
            assert len(self._resolutions) == 1
            ar_idx = 0

        if self.seed:
            self._rng = np.random.default_rng(seed=self.seed + idx)
        elif not hasattr(self, "_rng"):
            self._rng = np.random.default_rng()

        resolution = self._resolutions[ar_idx]
        views = self._get_views(int(idx), resolution, self._rng)

        for v, view in enumerate(views):
            assert "pts3d" not in view and "valid_mask" not in view
            view["idx"] = (int(idx), ar_idx, v)
            width, height = view["img"].size
            view["true_shape"] = np.int32((height, width))
            view["img"] = self.transform(view["img"])

            assert "camera_intrinsics" in view
            if "camera_pose" not in view:
                view["camera_pose"] = np.full((4, 4), np.nan, dtype=np.float32)
            else:
                assert np.isfinite(view["camera_pose"]).all(), \
                    f"NaN in camera pose of view {view.get('label')}"
            assert np.isfinite(view["depthmap"]).all(), \
                f"NaN in depthmap of view {view.get('label')}"

            pts3d, valid = depthmap_to_absolute_camera_coordinates(
                view["depthmap"], view["camera_intrinsics"], view["camera_pose"])
            view["pts3d"] = pts3d
            view["valid_mask"] = valid & np.isfinite(pts3d).all(axis=-1)

        for view in views:
            _transpose_to_landscape(view)
        return views


def _transpose_to_landscape(view):
    """Rectify portrait views so every array is landscape
    (ref base_stereo_view_dataset.py:215-233); img is HWC here."""
    height, width = view["true_shape"]
    if width < height:
        view["img"] = view["img"].swapaxes(0, 1)
        view["valid_mask"] = view["valid_mask"].swapaxes(0, 1)
        view["depthmap"] = view["depthmap"].swapaxes(0, 1)
        view["pts3d"] = view["pts3d"].swapaxes(0, 1)
        view["camera_intrinsics"] = view["camera_intrinsics"][[1, 0, 2]]


class BaseManyViewDataset(BaseViewDataset):
    """Video-clip sampling (ref spann3r/datasets/base_many_view_dataset.py).

    Stride-bounded monotone frame sampling with a curriculum threshold
    (train_ratio interpolates [min_thresh, max_thresh]) and random reversal.
    """

    def sample_frames(self, img_idxs, rng, _depth=0):
        num_frames = self.num_frames
        thresh = int(self.min_thresh
                     + self.train_ratio * (self.max_thresh - self.min_thresh))
        n = len(img_idxs)
        selected = []
        initial_range = max(n // num_frames, n - thresh * (num_frames - 1))
        current = int(rng.choice(np.arange(initial_range)))
        selected.append(current)
        while len(selected) < num_frames:
            lo = current + 1
            hi = min(current + thresh, n - (num_frames - len(selected)))
            candidates = [i for i in range(lo, hi + 1) if i not in selected]
            if not candidates:
                break
            current = int(rng.choice(candidates))
            selected.append(current)
        if len(selected) < num_frames:
            if _depth > 50:
                raise RuntimeError("cannot sample a frame clip")
            return self.sample_frames(img_idxs, rng, _depth + 1)
        ids = [img_idxs[i] for i in selected]
        if rng.choice([True, False]):
            ids.reverse()
        return ids

    def sample_frame_idx(self, img_idxs, rng, full_video=False):
        if not full_video:
            return self.sample_frames(img_idxs, rng)
        return img_idxs[::self.kf_every]

    # ------------------------------------------------------------------
    # shared adapter machinery: every dataset adapter is "discover scenes,
    # list frame ids, load one frame" — the loop, crop/resize, validity
    # retry and view-dict construction live here once.
    # ------------------------------------------------------------------

    def resolve_scene_list(self, test_id, discover):
        """test_id overrides discovery (a single id or a list)."""
        if test_id is None:
            return discover()
        return test_id if isinstance(test_id, list) else [test_id]

    def resample(self, resolution, rng):
        """Jump to a random other item (bad scene/frame recovery)."""
        return self._get_views(int(rng.integers(0, len(self) - 1)),
                               resolution, rng)

    def load_views(self, frame_ids, load_frame, resolution, rng,
                   dataset_name, idx, attempts=0, allow_skip=None):
        """Drive the per-frame loop for an adapter.

        load_frame(fid) -> (rgb, depthmap, pose, intrinsics, label, instance)
        or None to force a scene resample.  Frames with no valid depth or a
        non-finite pose are skipped in full-video mode and retried (then
        resampled) otherwise — the reference's recovery policy.
        """
        if allow_skip is None:
            allow_skip = self.full_video
        views = []
        for fid in frame_ids:
            item = load_frame(fid)
            if item is None:
                return self.resample(resolution, rng)
            rgb, depthmap, pose, intrinsics, label, instance = item
            rgb, depthmap, intrinsics = self._crop_resize_if_necessary(
                rgb, depthmap, intrinsics, resolution, rng=rng, info=label)
            if (depthmap > 0.0).sum() == 0 or not np.isfinite(pose).all():
                if allow_skip:
                    print(f"Warning: no valid depth for {label}")
                    continue
                if attempts >= 5:
                    return self.resample(resolution, rng)
                return self._get_views(idx, resolution, rng,
                                       attempts=attempts + 1)
            views.append(dict(img=rgb, depthmap=depthmap, camera_pose=pose,
                              camera_intrinsics=intrinsics,
                              dataset=dataset_name, label=label,
                              instance=instance))
        return views
