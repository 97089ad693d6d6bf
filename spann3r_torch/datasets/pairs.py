"""Image-pair dataset for CroCo masked cross-view pretraining
(ref croco/datasets/pairs_dataset.py, croco/datasets/transforms.py).

File contracts kept from the reference:
  - cache file (`pairs.txt`): one "relpath1 relpath2" per line
    (load_pairs_from_cache_file, ref pairs_dataset.py:13-18)
  - list file (`listing.txt`): one stem per line -> stem_1.jpg / stem_2.jpg,
    '#'-prefixed lines skipped (load_pairs_from_list_file, ref :20-25)
  - dataset names: 'habitat_release' uses <data_dir>/habitat_release/pairs.txt;
    crop datasets (ARKitScenes/MegaDepth/3DStreetView/IndoorVL) use
    <data_dir>/<name>_crops/listing.txt (dnames_to_image_pairs, ref :62-82)
  - transform string: 'cropN' (independent random crop per image) and
    'acolor' (asymmetric ColorJitter 0.6-1.4 b/c/s, no hue), '+'-joined
    (get_pair_transforms, ref transforms.py:66-86)

TPU-first deviations: images come out as HWC float32 numpy (NHWC pipeline),
normalized with the ImageNet statistics the reference's NormalizeBoth uses.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import PIL.Image

from .base import ColorJitter

# the reference normalizes with torchvision's ImageNet stats
# (ref croco/datasets/transforms.py:83)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

CROP_DATASETS = ("ARKitScenes", "MegaDepth", "3DStreetView", "IndoorVL")


def load_pairs_from_cache_file(fname: str, root: str = "") -> List[Tuple[str, str]]:
    if not os.path.isfile(fname):
        raise FileNotFoundError(f"cannot parse pairs from {fname}")
    with open(fname) as f:
        lines = f.read().strip().splitlines()
    return [(os.path.join(root, l.split()[0]), os.path.join(root, l.split()[1]))
            for l in lines if l.strip()]


def load_pairs_from_list_file(fname: str, root: str = "") -> List[Tuple[str, str]]:
    if not os.path.isfile(fname):
        raise FileNotFoundError(f"cannot parse pairs from {fname}")
    with open(fname) as f:
        lines = f.read().strip().splitlines()
    return [(os.path.join(root, l + "_1.jpg"), os.path.join(root, l + "_2.jpg"))
            for l in lines if l.strip() and not l.startswith("#")]


def write_cache_file(fname: str, pairs, root: str = "") -> None:
    if root and not root.endswith("/"):
        root += "/"
    lines = []
    for im1, im2 in pairs:
        if root:
            assert im1.startswith(root) and im2.startswith(root), (im1, im2)
        lines.append(f"{im1[len(root):]} {im2[len(root):]}")
    with open(fname, "w") as f:
        f.write("\n".join(lines))


def parse_and_cache_all_pairs(dname: str, data_dir: str = "./data/") -> str:
    """Walk <data_dir>/habitat_release for *_1.jpeg/*_2.jpeg pairs and cache
    them (ref pairs_dataset.py:41-57; 'val' subtrees excluded)."""
    if dname != "habitat_release":
        raise NotImplementedError(f"Unknown dataset: {dname}")
    dirname = os.path.join(data_dir, "habitat_release")
    if not os.path.isdir(dirname):
        raise FileNotFoundError(dirname)
    cache_file = os.path.join(dirname, "pairs.txt")
    if os.path.isfile(cache_file):
        raise FileExistsError(f"cache file already exists: {cache_file}")
    pairs = []
    for root, dirs, files in os.walk(dirname):
        if "val" in root:
            continue
        dirs.sort()
        pairs += [(os.path.join(root, f),
                   os.path.join(root, f[:-len("_1.jpeg")] + "_2.jpeg"))
                  for f in sorted(files) if f.endswith("_1.jpeg")]
    write_cache_file(cache_file, pairs, root=dirname)
    return cache_file


def dnames_to_image_pairs(dnames: str, data_dir: str = "./data/"):
    all_pairs = []
    for dname in dnames.split("+"):
        if dname == "habitat_release":
            dirname = os.path.join(data_dir, "habitat_release")
            pairs = load_pairs_from_cache_file(
                os.path.join(dirname, "pairs.txt"), root=dirname)
        elif dname in CROP_DATASETS:
            dirname = os.path.join(data_dir, dname + "_crops")
            pairs = load_pairs_from_list_file(
                os.path.join(dirname, "listing.txt"), root=dirname)
        else:
            raise NotImplementedError(f"Unknown dataset: {dname}")
        all_pairs += pairs
    return all_pairs


class PairTransforms:
    """'cropN+acolor'-style augmentation chain.

    cropN: INDEPENDENT random NxN crop per image (ref RandomCropPair — "the
    crop will be intentionally different for the two images").
    acolor: ColorJitter(0.6-1.4 brightness/contrast/saturation, hue=0) with
    assymetric_prob=1.0, i.e. independent params per image
    (ref transforms.py:76-78).
    """

    def __init__(self, transform_str: str, normalize: bool = True,
                 rng: Optional[np.random.Generator] = None):
        self.rng = rng or np.random.default_rng()
        self.crop: Optional[int] = None
        self.acolor = False
        for s in transform_str.split("+"):
            if s.startswith("crop"):
                self.crop = int(s[len("crop"):])
            elif s == "acolor":
                self.acolor = True
            elif s == "":
                pass
            else:
                raise NotImplementedError(f"Unknown augmentation: {s}")
        self.normalize = normalize
        self._jitter = ColorJitter(brightness=0.4, contrast=0.4,
                                   saturation=0.4, hue=0.0, rng=self.rng)

    def _crop_one(self, img: PIL.Image.Image) -> PIL.Image.Image:
        c = self.crop
        w, h = img.size
        if w < c or h < c:  # torchvision RandomCrop would pad; upsample
            img = img.resize((max(w, c), max(h, c)), PIL.Image.BICUBIC)
            w, h = img.size
        x = int(self.rng.integers(0, w - c + 1))
        y = int(self.rng.integers(0, h - c + 1))
        return img.crop((x, y, x + c, y + c))

    def _finish(self, img: PIL.Image.Image) -> np.ndarray:
        arr = np.asarray(img, np.float32) / 255.0
        if self.normalize:
            arr = (arr - IMAGENET_MEAN) / IMAGENET_STD
        return arr

    def __call__(self, im1: PIL.Image.Image, im2: PIL.Image.Image):
        if self.crop is not None:
            im1, im2 = self._crop_one(im1), self._crop_one(im2)
        if self.acolor:  # independent jitter params per image
            im1 = ColorJitter.apply(im1, *self._jitter.get_params())
            im2 = ColorJitter.apply(im2, *self._jitter.get_params())
        return self._finish(im1), self._finish(im2)


class PairsDataset:
    """len/getitem dataset of augmented image pairs (ref PairsDataset)."""

    def __init__(self, dnames: str, trfs: str = "", normalize: bool = True,
                 data_dir: str = "./data/", seed: Optional[int] = None):
        self.image_pairs = dnames_to_image_pairs(dnames, data_dir=data_dir)
        self.transforms = PairTransforms(
            trfs, normalize=normalize,
            rng=np.random.default_rng(seed) if seed is not None else None)

    def __len__(self) -> int:
        return len(self.image_pairs)

    def __getitem__(self, index: int):
        p1, p2 = self.image_pairs[index]
        im1 = PIL.Image.open(p1).convert("RGB")
        im2 = PIL.Image.open(p2).convert("RGB")
        return self.transforms(im1, im2)
