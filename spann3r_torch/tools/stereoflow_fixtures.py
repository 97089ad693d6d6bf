"""Small stereo and flow trees in each dataset's on-disk layout, from a seed.

    write_tree(kind, data_root, seed=0, pairs=4, shrink=1) -> splits

writes `pairs` training pairs of `kind` (SceneFlow, FlyingChairs or
Kitti15) under `data_root` in the layout and file formats that
`stereoflow.datasets` reads (`_SUBPATHS`: SceneFlow's PNG frames and PFM
disparities, FlyingChairs' PPM frames and `.flo` flows, KITTI 2015's PNG
frames, 16-bit PNG disparities and 16-bit PNG flows), at each dataset's raw
size (`RAW_SIZES`) divided by `shrink`, and the split cache that the
dataset's `_build_cache` would write beside them
(`data_root/datasets_{stereo,flow}_cache/<name>.pkl`): the real scan
asserts the official pair counts (datasets.py:284-292), which a small tree
cannot meet. Point the datasets at the tree with
`stereoflow.datasets.DATA_ROOT = data_root` in the process, or with
SPANN3R_STEREOFLOW_DATA=data_root in the environment of a CLI.

The frames are a smooth random texture and its copy shifted by the ground
truth's mean displacement, the disparities positive and the flows finite
(KITTI's sparse disparity maps leave a tenth of the pixels invalid). The CPU tests
hold the port's dataset copies to the JAX package's on these trees, and
chip_smoke.py trains and tests on them.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Tuple

import numpy as np
import PIL.Image

from ..stereoflow import datasets as sfd
from ..stereoflow import io as sfio

# (width, height) of the raw frames: SceneFlow's renders, FlyingChairs',
# and KITTI 2015's most common capture size
RAW_SIZES: Dict[str, Tuple[int, int]] = {
    "SceneFlow": (960, 540), "FlyingChairs": (512, 384), "Kitti15": (1242, 375),
}
KINDS = tuple(RAW_SIZES)
# SceneFlow's split of the JAX package's _build_cache: training pairs from
# Driving, test pairs from FlyingThings' TEST part
_SCENEFLOW_TRAIN = ("Driving/frames_finalpass/15mm_focallength/"
                    "scene_forwards/fast/left/{:04d}.png")
_SCENEFLOW_TEST = "FlyingThings/frames_finalpass/TEST/A/0000/left/{:04d}.png"


def _size(kind: str, shrink: int) -> Tuple[int, int]:
    w, h = RAW_SIZES[kind]
    return max(w // shrink, 32), max(h // shrink, 32)


def _texture(rng, w, h) -> np.ndarray:
    """A smooth random RGB texture (uint8, HWC)."""
    base = rng.integers(0, 256, (max(h // 16, 2), max(w // 16, 2), 3),
                        dtype=np.uint8)
    return np.asarray(PIL.Image.fromarray(base).resize(
        (w, h), PIL.Image.BILINEAR))


def _pair(rng, w, h, shift: int) -> Tuple[np.ndarray, np.ndarray]:
    """Two views of one texture, the second `shift` pixels to the right:
    view1(x) = view2(x - shift), a stereo pair of disparity `shift`."""
    s = abs(int(shift))
    tex = _texture(rng, w + s, h)
    return tex[:, :w], tex[:, s:s + w]


def _save(path: str, arr: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    PIL.Image.fromarray(arr).save(path)


def _disparity(rng, w, h) -> np.ndarray:
    """Positive disparities (px) on a slanted plane plus noise."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    d = 4.0 + 40.0 * xx / w + 8.0 * yy / h
    return (d + rng.random((h, w), dtype=np.float32)).astype(np.float32)


def _flow(rng, w, h) -> np.ndarray:
    """A smooth affine flow field (px) plus noise, (H, W, 2)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    a = rng.uniform(-0.02, 0.02, 6).astype(np.float32)
    u = a[0] * xx + a[1] * yy + 8.0 * a[2] / 0.02
    v = a[3] * xx + a[4] * yy + 4.0 * a[5] / 0.02
    f = np.stack([u, v], -1) + 0.1 * rng.standard_normal((h, w, 2))
    return f.astype(np.float32)


def _write_cache(data_root: str, task: str, name: str, splits) -> None:
    path = os.path.join(data_root, f"datasets_{task}_cache", name + ".pkl")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(splits, f)


def _sceneflow(root, rng, n, w, h) -> List[str]:
    train = [_SCENEFLOW_TRAIN.format(i) for i in range(n)]
    test = [_SCENEFLOW_TEST.format(i) for i in range(max(n // 4, 1))]
    for rel in train + test:
        disp = _disparity(rng, w, h)
        left, right = _pair(rng, w, h, int(disp.mean()))
        _save(os.path.join(root, rel), left)
        _save(os.path.join(root, rel.replace("/left/", "/right/")), right)
        dpath = os.path.join(root, rel.replace("/frames_finalpass/",
                                               "/disparity/")[:-4] + ".pfm")
        os.makedirs(os.path.dirname(dpath), exist_ok=True)
        sfio.write_pfm(dpath, disp)
    clean = lambda ps: [p.replace("frames_finalpass", "frames_cleanpass")
                        for p in ps]
    splits = {"train_finalpass": train, "train_cleanpass": clean(train),
              "test_finalpass": test, "test_cleanpass": clean(test),
              "test1of100_finalpass": test[::100],
              "test1of100_cleanpass": clean(test[::100])}
    splits["train_allpass"] = splits["train_finalpass"] + clean(train)
    splits["test_allpass"] = splits["test_finalpass"] + clean(test)
    return splits


def _chairs(root, rng, n, w, h):
    names = ["{:05d}".format(i + 1) for i in range(n)]
    n_val = max(n // 4, 1)
    for p in names:
        flow = _flow(rng, w, h)
        img1, img2 = _pair(rng, w, h, int(round(float(flow[..., 0].mean()))))
        _save(os.path.join(root, "data", p + "_img1.ppm"), img1)
        _save(os.path.join(root, "data", p + "_img2.ppm"), img2)
        sfio.write_flo(os.path.join(root, "data", p + "_flow.flo"), flow)
    split = np.array([1] * (n - n_val) + [2] * n_val, np.int32)
    np.savetxt(os.path.join(root, "chairs_split.txt"), split, fmt="%d")
    return {"train": names[:n - n_val], "val": names[n - n_val:]}


def _kitti15(root, rng, n, w, h):
    """Stereo and flow pairs of KITTI 2015; returns (stereo, flow) splits.
    The gt maps are sparse: about a tenth of the pixels invalid (0)."""
    train = ["training/image_2/%06d" % i for i in range(n)]
    test = ["testing/image_2/%06d" % i for i in range(1)]
    for p in train + test:
        disp = _disparity(rng, w, h)
        left, right = _pair(rng, w, h, int(disp.mean()))
        _save(os.path.join(root, p + "_10.png"), left)
        _save(os.path.join(root, p + "_11.png"), _pair(rng, w, h, 3)[1])
        _save(os.path.join(root, p.replace("/image_2/", "/image_3/")
                           + "_10.png"), right)
        if p.startswith("testing"):
            continue
        valid = rng.random((h, w)) > 0.1
        d16 = np.where(valid, np.round(disp * 256), 0).astype(np.uint16)
        _save(os.path.join(root, p.replace("/image_2/", "/disp_occ_0/")
                           + "_10.png"), d16)
        fpath = os.path.join(root, p.replace("/image_2/", "/flow_occ/")
                             + "_10.png")
        os.makedirs(os.path.dirname(fpath), exist_ok=True)
        sfio.write_kitti_flow(fpath, np.round(_flow(rng, w, h) * 64) / 64)
    stereo = {"train": train, "test": test,
              "subtrain": train[:-min(5, n - 1)],
              "subval": train[-min(5, n - 1):]}
    flow = {"train": train, "test": test,
            "subtrain": train[:-min(10, n - 1)],
            "subval": train[-min(10, n - 1):]}
    return stereo, flow


def write_tree(kind: str, data_root: str, seed: int = 0, pairs: int = 4,
               shrink: int = 1):
    """Write `pairs` training pairs of `kind` under data_root (in its
    `_SUBPATHS` entry) with the split caches; returns the splits written
    ({split: pair names}; for Kitti15 the stereo ones, the flow ones in
    the flow cache)."""
    if kind not in RAW_SIZES:
        raise ValueError(f"unknown kind {kind!r}; options: {KINDS}")
    rng = np.random.default_rng(seed)
    w, h = _size(kind, shrink)
    root = os.path.join(data_root, sfd._SUBPATHS[kind])
    if kind == "SceneFlow":
        splits = _sceneflow(root, rng, pairs, w, h)
        _write_cache(data_root, "stereo", kind, splits)
    elif kind == "FlyingChairs":
        splits = _chairs(root, rng, pairs, w, h)
        _write_cache(data_root, "flow", kind, splits)
    else:
        splits, flow = _kitti15(root, rng, pairs, w, h)
        _write_cache(data_root, "stereo", kind, splits)
        _write_cache(data_root, "flow", kind, flow)
    return splits
