"""Disparity / optical-flow file formats and visualization.

Reference: croco/stereoflow/datasets_stereo.py:541-662 (disp readers, PFM,
dsp5) and datasets_flow.py:378-489, 491-637 (flo/KITTI/hdf5 flow + the
Middlebury color wheel).  Invalid pixels are encoded as +inf on load, the
contract the criteria and metrics depend on.  hdf5-backed formats (Spring
.dsp5/.flo5) are gated on h5py availability.
"""
from __future__ import annotations

import os
import re
import struct
import sys
from typing import Tuple

import numpy as np
from PIL import Image

try:
    import h5py
    HAS_H5PY = True
except ImportError:  # Spring hdf5 formats become unavailable
    HAS_H5PY = False

TAG_FLOAT = 202021.25  # .flo sanity tag (ref datasets_flow.py:387-391)
TAG_STRING = "PIEH"


def read_img(filename: str) -> np.ndarray:
    """RGB uint8 (H, W, 3) (ref datasets_stereo.py:541-544)."""
    return np.asarray(Image.open(filename).convert("RGB"))


# ------------------------------- PFM -------------------------------

def read_pfm(filename: str) -> Tuple[np.ndarray, float]:
    """(data flipped to top-down, scale) (ref datasets_stereo.py:581-616)."""
    with open(filename, "rb") as f:
        header = f.readline().rstrip().decode("ascii")
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError(f"{filename}: not a PFM file")
        m = re.match(r"^(\d+)\s(\d+)\s$", f.readline().decode("ascii"))
        if not m:
            raise ValueError(f"{filename}: malformed PFM header")
        width, height = map(int, m.groups())
        scale = float(f.readline().decode("ascii").rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(data.reshape(shape)), scale


def write_pfm(filename: str, image: np.ndarray, scale: float = 1):
    """ref datasets_stereo.py:618-645."""
    if image.dtype.name != "float32":
        raise ValueError("PFM image dtype must be float32")
    image = np.flipud(image)
    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        color = False
    else:
        raise ValueError("PFM image must be HxWx3, HxWx1 or HxW")
    with open(filename, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(b"%d %d\n" % (image.shape[1], image.shape[0]))
        endian = image.dtype.byteorder
        if endian == "<" or (endian == "=" and sys.byteorder == "little"):
            scale = -scale
        f.write(b"%f\n" % scale)
        np.ascontiguousarray(image).tofile(f)


# ---------------------------- disparity ----------------------------

def read_png_disp(filename: str, coef: float = 1.0) -> np.ndarray:
    """16-bit png / coef, zeros -> +inf (ref datasets_stereo.py:551-555)."""
    disp = np.asarray(Image.open(filename)).astype(np.float32) / coef
    disp[disp == 0.0] = np.inf
    return disp


def read_pfm_disp(filename: str) -> np.ndarray:
    """non-positive -> +inf (ref datasets_stereo.py:557-560)."""
    disp = np.ascontiguousarray(read_pfm(filename)[0]).astype(np.float32)
    disp[disp <= 0] = np.inf
    return disp


def read_npy_disp(filename: str) -> np.ndarray:
    return np.load(filename)


def read_booster_disp(filename: str) -> np.ndarray:
    disp = np.load(filename)
    disp[disp == 0.0] = np.inf
    return disp


def read_crestereo_disp(filename):
    return read_png_disp(filename, coef=32.0)


def read_middlebury20052006_disp(filename):
    return read_png_disp(filename, coef=1.0)


def read_kitti_disp(filename):
    return read_png_disp(filename, coef=256.0)


read_sceneflow_disp = read_pfm_disp
read_eth3d_disp = read_pfm_disp
read_middlebury_disp = read_pfm_disp


def read_hdf5_disp(filename: str) -> np.ndarray:
    """Spring .dsp5; NaN -> +inf (ref datasets_stereo.py:574-579)."""
    disp = np.asarray(h5py.File(filename)["disparity"])
    disp[np.isnan(disp)] = np.inf
    return disp.astype(np.float32)


def write_dsp5(filename: str, disp: np.ndarray):
    with h5py.File(filename, "w") as f:
        f.create_dataset("disparity", data=disp, compression="gzip",
                         compression_opts=5)


# ------------------------------- flow -------------------------------

def read_flo(filename: str) -> np.ndarray:
    """Middlebury .flo (ref datasets_flow.py:392-424)."""
    if not filename.endswith(".flo"):
        raise ValueError(f"{filename}: .flo extension required")
    with open(filename, "rb") as f:
        tag = struct.unpack("f", f.read(4))[0]
        if tag != TAG_FLOAT:
            raise ValueError(f"{filename}: wrong .flo tag")
        w, h = struct.unpack("ii", f.read(8))
        if not (1 <= w <= 99999 and 1 <= h <= 99999):
            raise ValueError(f"{filename}: illegal size {w}x{h}")
        flow = np.fromfile(f, np.float32)
        if flow.shape != (h * w * 2,):
            raise ValueError(f"{filename}: truncated .flo")
    return flow.reshape(h, w, 2)


def write_flo(filename: str, flow: np.ndarray):
    """ref datasets_flow.py:425-453."""
    if not filename.endswith(".flo"):
        raise ValueError(f"{filename}: .flo extension required")
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError("flow must be (H, W, 2)")
    with open(filename, "wb") as f:
        f.write(TAG_STRING.encode("utf-8"))
        f.write(struct.pack("ii", flow.shape[1], flow.shape[0]))
        flow.astype(np.float32).tofile(f)


def read_numpy_flow(filename: str) -> np.ndarray:
    return np.load(filename)


def read_pfm_flow(filename: str) -> np.ndarray:
    """ref datasets_flow.py:381-384 (third channel must be zero)."""
    f, _ = read_pfm(filename)
    assert np.all(f[:, :, 2] == 0.0)
    return np.ascontiguousarray(f[:, :, :2]).astype(np.float32)


def read_kitti_flow(filename: str) -> np.ndarray:
    """KITTI uint16 png encoding; invalid -> +inf
    (ref datasets_flow.py:455-464)."""
    import cv2
    flow = cv2.imread(filename, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR)
    flow = flow[:, :, ::-1].astype(np.float32)
    valid = flow[:, :, 2] > 0
    flow = flow[:, :, :2]
    flow = (flow - 2 ** 15) / 64.0
    flow[~valid, 0] = np.inf
    flow[~valid, 1] = np.inf
    return flow


def write_kitti_flow(filename: str, uv: np.ndarray):
    """ref datasets_flow.py:467-471."""
    import cv2
    uv = 64.0 * uv + 2 ** 15
    valid = np.ones([uv.shape[0], uv.shape[1], 1])
    uv = np.concatenate([uv, valid], axis=-1).astype(np.uint16)
    cv2.imwrite(filename, uv[..., ::-1])


def read_hdf5_flow(filename: str) -> np.ndarray:
    flow = np.asarray(h5py.File(filename)["flow"])
    flow[np.isnan(flow)] = np.inf
    return flow.astype(np.float32)


def write_flo5(filename: str, flow: np.ndarray):
    with h5py.File(filename, "w") as f:
        f.create_dataset("flow", data=flow, compression="gzip",
                         compression_opts=5)


# --------------------------- visualization ---------------------------

def vis_disparity(disp: np.ndarray, m=None, M=None) -> np.ndarray:
    """Inferno colormap render (ref datasets_stereo.py:654-661)."""
    import cv2
    if m is None:
        m = disp.min()
    if M is None:
        M = disp.max()
    disp_vis = ((disp - m) / (M - m + 1e-12) * 255.0).astype("uint8")
    return cv2.applyColorMap(disp_vis, cv2.COLORMAP_INFERNO)


# Middlebury color wheel segment sizes (ref datasets_flow.py:483-489)
_RY, _YG, _GC, _CB, _BM, _MR = 15, 6, 4, 11, 13, 6
UNKNOWN_THRESH = 1e9


def _colorwheel() -> np.ndarray:
    ncols = _RY + _YG + _GC + _CB + _BM + _MR
    cw = np.zeros((ncols, 3), "uint8")
    col = 0
    cw[:_RY, 0] = 255
    cw[:_RY, 1] = [(255 * i) // _RY for i in range(_RY)]
    col += _RY
    cw[col:col + _YG, 0] = [255 - (255 * i) // _YG for i in range(_YG)]
    cw[col:col + _YG, 1] = 255
    col += _YG
    cw[col:col + _GC, 1] = 255
    cw[col:col + _GC, 2] = [(255 * i) // _GC for i in range(_GC)]
    col += _GC
    cw[col:col + _CB, 1] = [255 - (255 * i) // _CB for i in range(_CB)]
    cw[col:col + _CB, 2] = 255
    col += _CB
    cw[col:col + _BM, 0] = [(255 * i) // _BM for i in range(_BM)]
    cw[col:col + _BM, 2] = 255
    col += _BM
    cw[col:col + _MR, 0] = 255
    cw[col:col + _MR, 2] = [255 - (255 * i) // _MR for i in range(_MR)]
    return cw


def _compute_color(flow: np.ndarray, saturate: bool = True) -> np.ndarray:
    """ref datasets_flow.py:550-613."""
    flow = np.array(flow, copy=True)
    nanidx = np.isnan(flow[:, :, 0])
    flow[nanidx] = 0.0
    cw = _colorwheel()
    ncols = cw.shape[0]

    rad = np.sqrt(np.sum(np.square(flow), 2))
    a = np.arctan2(-flow[:, :, 1], -flow[:, :, 0]) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype("int")
    k1 = k0 + 1
    k1[k1 == ncols] = 0
    f = fk - k0
    if not saturate:
        rad = np.minimum(rad, 1)

    img = np.zeros((flow.shape[0], flow.shape[1], 3), "uint8")
    for i in range(3):
        tmp = cw[:, i].astype("float")
        col0 = tmp[k0] / 255
        col1 = tmp[k1] / 255
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] *= 0.75
        img[:, :, i] = (255 * col * (1 - nanidx.astype("float"))).astype(
            "uint8")
    return img


def flow_to_color(flow: np.ndarray, maxflow=None, maxmaxflow=None,
                  saturate=False) -> np.ndarray:
    """ref datasets_flow.py:509-537."""
    flow = np.array(flow, copy=True)
    assert flow.shape[2] == 2
    unknown = np.max(np.abs(flow), 2) > UNKNOWN_THRESH
    flow[unknown] = 0.0
    if maxflow is None:
        maxflow = np.max(np.sqrt(np.sum(np.square(flow), 2)))
    if maxmaxflow is not None:
        maxflow = min(maxmaxflow, maxflow)
    eps = np.spacing(1)
    img = _compute_color(flow / (maxflow + eps), saturate=saturate)
    img[np.tile(unknown[:, :, None], [1, 1, 3])] = 0.0
    return img
