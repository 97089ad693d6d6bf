"""Joint image/depth/intrinsics crop-resize utilities (torch-free).

Behavioural contract from reference dust3r/datasets/utils/cropping.py:
principal-point-centered crop, Lanczos image rescale with nearest-neighbour
depth, intrinsics rewritten through the colmap<->opencv half-pixel dance.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import PIL.Image

from ..utils.geometry import (colmap_to_opencv_intrinsics,
                              opencv_to_colmap_intrinsics)

LANCZOS = PIL.Image.Resampling.LANCZOS


def _to_pil(image) -> PIL.Image.Image:
    if isinstance(image, PIL.Image.Image):
        return image
    return PIL.Image.fromarray(image)


def camera_matrix_of_crop(k: np.ndarray, in_res, out_res, scaling=1.0,
                          offset_factor=0.5, offset=None) -> np.ndarray:
    margins = np.asarray(in_res) * scaling - np.asarray(out_res)
    assert np.all(margins >= 0.0), f"negative crop margins {margins}"
    if offset is None:
        offset = offset_factor * margins
    out = opencv_to_colmap_intrinsics(k)
    out[:2, :] *= scaling
    out[:2, 2] -= offset
    return colmap_to_opencv_intrinsics(out)


def crop_image_depthmap(image, depthmap, k: np.ndarray, bbox
                        ) -> Tuple[PIL.Image.Image, Optional[np.ndarray], np.ndarray]:
    image = _to_pil(image)
    l, t, r, b = bbox
    image = image.crop((l, t, r, b))
    if depthmap is not None:
        depthmap = depthmap[t:b, l:r]
    k = k.copy()
    k[0, 2] -= l
    k[1, 2] -= t
    return image, depthmap, k


def rescale_image_depthmap(image, depthmap, k: np.ndarray, out_res
                           ) -> Tuple[PIL.Image.Image, Optional[np.ndarray], np.ndarray]:
    """Rescale so (w, h) >= out_res elementwise; Lanczos + nearest depth."""
    image = _to_pil(image)
    in_res = np.array(image.size)
    out_res = np.array(out_res)
    scale = max(out_res / in_res) + 1e-8
    target = np.floor(in_res * scale).astype(int)
    image = image.resize(tuple(target), resample=LANCZOS)
    if depthmap is not None:
        import cv2
        depthmap = cv2.resize(depthmap, tuple(target),
                              interpolation=cv2.INTER_NEAREST)
    k = camera_matrix_of_crop(k, in_res, target, scaling=scale)
    return image, depthmap, k


def bbox_from_intrinsics_in_out(k_in: np.ndarray, k_out: np.ndarray, out_res):
    w, h = out_res
    l, t = np.int32(np.round(k_in[:2, 2] - k_out[:2, 2]))
    return (l, t, l + w, t + h)


def crop_resize_if_necessary(image, depthmap, intrinsics, resolution,
                             rng: Optional[np.random.Generator] = None,
                             aug_crop: int = 0, info=None):
    """Principal-point-centered crop + Lanczos rescale + final crop
    (ref base_stereo_view_dataset.py:143-194)."""
    image = _to_pil(image)
    w, h = image.size
    cx, cy = intrinsics[:2, 2].round().astype(int)
    min_margin_x = min(cx, w - cx)
    min_margin_y = min(cy, h - cy)
    assert min_margin_x > w / 5, f"bad principal point in view={info}"
    assert min_margin_y > h / 5, f"bad principal point in view={info}"

    bbox = (cx - min_margin_x, cy - min_margin_y,
            cx + min_margin_x, cy + min_margin_y)
    image, depthmap, intrinsics = crop_image_depthmap(image, depthmap,
                                                      intrinsics, bbox)

    w, h = image.size
    assert resolution[0] >= resolution[1]
    if h > 1.1 * w:
        resolution = resolution[::-1]
    elif 0.9 < h / w < 1.1 and resolution[0] != resolution[1] and rng is not None:
        if rng.integers(2):
            resolution = resolution[::-1]

    target = np.array(resolution)
    if aug_crop > 1 and rng is not None:
        target = target + rng.integers(0, aug_crop)
    image, depthmap, intrinsics = rescale_image_depthmap(image, depthmap,
                                                         intrinsics, target)

    k2 = camera_matrix_of_crop(intrinsics, image.size, resolution,
                               offset_factor=0.5)
    bbox = bbox_from_intrinsics_in_out(intrinsics, k2, resolution)
    image, depthmap, k2 = crop_image_depthmap(image, depthmap, intrinsics, bbox)
    return image, depthmap, k2
