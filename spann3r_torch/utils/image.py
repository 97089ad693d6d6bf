"""Image IO + resize rules (torch-free; ref dust3r/utils/image.py)."""
from __future__ import annotations

import os
from typing import List

import numpy as np
import PIL.Image

os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")

LANCZOS = PIL.Image.Resampling.LANCZOS


def imread_cv2(path: str, options=None) -> np.ndarray:
    """EXR-aware image read returning RGB uint8 (or raw for depth).

    ref dust3r/utils/image.py:26-36."""
    import cv2
    if options is None:
        options = cv2.IMREAD_COLOR
    if path.endswith((".exr", ".EXR")):
        options = cv2.IMREAD_ANYDEPTH
    img = cv2.imread(path, options)
    if img is None:
        raise IOError(f"Could not load image={path}")
    if img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return img


def img_to_arr(img) -> np.ndarray:
    if isinstance(img, PIL.Image.Image):
        return np.asarray(img)
    return img


def rgb(ftensor, true_shape=None) -> np.ndarray:
    """Normalized [-1,1] float image back to [0,1] RGB for viz."""
    arr = np.asarray(ftensor)
    if arr.ndim == 3 and arr.shape[0] == 3:
        arr = arr.transpose(1, 2, 0)
    if arr.dtype != np.uint8:
        arr = arr * 0.5 + 0.5
    if true_shape is not None:
        h, w = true_shape
        arr = arr[:h, :w]
    return arr.clip(0, 1)


def _resize_pil(img: PIL.Image.Image, long_edge: int) -> PIL.Image.Image:
    s = long_edge / max(img.size)
    interp = LANCZOS if s < 1 else PIL.Image.Resampling.BICUBIC
    return img.resize([round(x * s) for x in img.size], interp)


def load_images(folder_or_list, size: int, square_ok: bool = False,
                verbose: bool = False) -> List[dict]:
    """Load + resize images for raw inference (ref image.py:68-123).

    size=224: crop to 224x224 centered; size=512: long edge 512, crop to
    multiples of 16.  Returns view dicts with normalized HWC float32 'img'.
    """
    if isinstance(folder_or_list, str):
        root = folder_or_list
        names = sorted(os.listdir(root))
        paths = [os.path.join(root, n) for n in names
                 if n.lower().endswith((".jpg", ".jpeg", ".png", ".bmp"))]
    else:
        paths = list(folder_or_list)

    imgs = []
    for idx, path in enumerate(paths):
        img = PIL.Image.open(path).convert("RGB")
        w1, h1 = img.size
        if size == 224:
            img = _resize_pil(img, round(size * max(w1 / h1, h1 / w1)))
        else:
            img = _resize_pil(img, size)
        w, h = img.size
        cx, cy = w // 2, h // 2
        if size == 224:
            half = min(cx, cy)
            img = img.crop((cx - half, cy - half, cx + half, cy + half))
        else:
            halfw, halfh = ((2 * cx) // 16) * 8, ((2 * cy) // 16) * 8
            if not square_ok and w == h:
                halfh = 3 * halfw // 4
            img = img.crop((cx - halfw, cy - halfh, cx + halfw, cy + halfh))
        w2, h2 = img.size
        if verbose:
            print(f" - loaded {path} {w1}x{h1} -> {w2}x{h2}")
        arr = (np.asarray(img, dtype=np.float32) / 255.0 - 0.5) / 0.5
        imgs.append(dict(img=arr[None], true_shape=np.int32([[h2, w2]]),
                         idx=idx, instance=str(idx), path=path))
    assert imgs, "no images found"
    return imgs
