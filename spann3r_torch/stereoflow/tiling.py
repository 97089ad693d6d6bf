"""Tiled high-resolution inference with confidence-weighted aggregation
(the JAX package's stereoflow/tiling.py).

Reference: croco/stereoflow/engine.py:178-279 (tiled_pred, _overlapping,
_crop). The reference loops tile by tile through the model; here the tiles
of an image go to the model in chunks of `tile_batch` windows (the tail
padded with repeats, one batch shape for every call), and are aggregated on
the host. The weighting formula, the linspace offsets and the upscale path
are the JAX package's, whose bicubic resize (`jax.image.resize`: Keys'
cubic with a = -0.5, antialiased when it shrinks) `_resize_img` computes as
one weight matrix per axis; torch's bicubic (a = -0.75, no antialias) is
another function.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch


def tile_slices(total: int, window: int, overlap: float = 0.5):
    """ref engine.py:268-271 (_overlapping): linspace-rounded offsets."""
    assert total >= window and 0 <= overlap < 1, (total, window, overlap)
    num_windows = 1 + int(np.ceil((total - window) / ((1 - overlap) * window)))
    offsets = np.linspace(0, total - window, num_windows).round().astype(int)
    return [slice(int(x), int(x) + window) for x in offsets]


def _conf_weight(predconf: np.ndarray, conf_mode: str) -> np.ndarray:
    """Tile weight from the raw confidence channel (ref engine.py:205-211,
    237-242)."""
    if conf_mode.startswith("conf_expsigmoid_"):  # e.g. conf_expsigmoid_10_5
        beta, betasigmoid = map(
            float, conf_mode[len("conf_expsigmoid_"):].split("_"))
        sig = 1.0 / (1.0 + np.exp(-predconf / betasigmoid))
        return np.exp(-beta * 2 * (sig - 0.5))
    if conf_mode.startswith("conf_expbeta"):  # e.g. conf_expbeta3
        beta = float(conf_mode[len("conf_expbeta"):])
        return np.exp(-beta * predconf)
    raise NotImplementedError(f"conf_mode {conf_mode} is not implemented")


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel with a = -0.5, of |x|."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _cubic_weights(n_in: int, n_out: int) -> torch.Tensor:
    """(n_in, n_out) fp32 weights of jax.image.resize's bicubic along one
    axis (jax/_src/image/scale.py compute_weight_mat, no translation,
    antialias on): the kernel widened by 1 / scale when shrinking, each
    output's weights normalised to sum 1, outputs that sample outside the
    input zeroed."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = ((torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale
                - 0.5)
    x = (torch.abs(sample_f[None, :]
                   - torch.arange(n_in, dtype=torch.float32)[:, None])
         / kernel_scale)
    w = _keys_cubic(x)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize_img(img: np.ndarray, new_hw) -> np.ndarray:
    """Bicubic resize of an NHWC batch on the host, fp32: jax.image.resize
    (method='bicubic') as two weight-matrix products (ref engine.py:163-164
    resizes with torch's a = -0.75 kernel; the differences are sub-1% and
    only on the upscale path, for images smaller than a tile)."""
    x = torch.from_numpy(np.asarray(img, np.float32))
    h, w = x.shape[1:3]
    if new_hw[0] != h:
        x = torch.einsum("bhwc,hk->bkwc", x, _cubic_weights(h, new_hw[0]))
    if new_hw[1] != w:
        x = torch.einsum("bhwc,wk->bhkc", x, _cubic_weights(w, new_hw[1]))
    return x.numpy()


def resize_stereo_or_flow(data: np.ndarray, new_hw) -> np.ndarray:
    """Resize gt/pred maps and rescale the displacement values
    (ref engine.py:165-175)."""
    assert data.ndim == 4 and data.shape[-1] in (1, 2)
    scale_x = new_hw[1] / float(data.shape[2])
    out = _resize_img(data, new_hw)
    out[..., 0] *= scale_x
    if out.shape[-1] == 2:
        out[..., 1] *= new_hw[0] / float(data.shape[1])
    return out


def _loss(criterion, pred, gt, conf=None) -> float:
    """A criterion on host numpy arrays, as a float."""
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (pred, gt)]
    if conf is not None:
        args.append(torch.from_numpy(np.ascontiguousarray(conf)))
    return float(criterion(*args))


def tiled_pred(model_fn: Callable, criterion, img1: np.ndarray,
               img2: np.ndarray, gt: Optional[np.ndarray],
               crop: Tuple[int, int] = (352, 704), overlap: float = 0.5,
               conf_mode: str = "conf_expsigmoid_10_5",
               with_conf: bool = False, num_channels: int = None,
               tile_batch: int = 8):
    """Weighted-average overlapping-tile inference (ref engine.py:178-266).

    model_fn: (img1, img2) numpy (tile_batch, win_h, win_w, 3) -> numpy
    (tile_batch, win_h, win_w, C[+1]); `engine.make_tile_fn` moves each
    chunk to the model's device and the result back. Returns (pred
    (B,H,W,C), mean tiled loss (None without gt or criterion), c (B,H,W) the
    aggregated raw confidence)."""
    img1 = np.asarray(img1)
    img2 = np.asarray(img2)
    B, H, W, _ = img1.shape
    if gt is not None:
        C = gt.shape[-1]
    else:
        assert num_channels is not None, "need num_channels when gt is None"
        C = num_channels
    win_h, win_w = crop

    # upscale when the image is smaller than one tile (engine.py:196-204).
    # DEVIATION (the JAX package's): the reference computes
    # max(win_w/W, win_h/W), W in both ratios, so a short-H image can stay
    # below win_h and crash in _overlapping; this uses the evidently
    # intended win_h/H (the same whenever the reference works at all).
    do_change_scale = H < win_h or W < win_w
    if do_change_scale:
        upscale = max(win_w / W, win_h / H)
        original_hw = (H, W)
        new_hw = (round(H * upscale), round(W * upscale))
        img1 = _resize_img(img1, new_hw)
        img2 = _resize_img(img2, new_hw)
        if gt is not None:
            gt = resize_stereo_or_flow(np.array(gt, copy=True), new_hw)
        H, W = new_hw

    sy_list = tile_slices(H, win_h, overlap)
    sx_list = tile_slices(W, win_w, overlap)
    tiles = [(sy, sx) for sy in sy_list for sx in sx_list]
    T = len(tiles)

    crops1 = np.stack([img1[:, sy, sx] for sy, sx in tiles])  # (T,B,h,w,3)
    crops2 = np.stack([img2[:, sy, sx] for sy, sx in tiles])
    flat1 = crops1.reshape(T * B, win_h, win_w, 3)
    flat2 = crops2.reshape(T * B, win_h, win_w, 3)

    # fixed-shape chunked dispatch (pad the tail with repeats)
    n = T * B
    outs = []
    for s in range(0, n, tile_batch):
        a1, a2 = flat1[s:s + tile_batch], flat2[s:s + tile_batch]
        pad = tile_batch - a1.shape[0]
        if pad:
            a1 = np.concatenate([a1, np.repeat(a1[-1:], pad, 0)])
            a2 = np.concatenate([a2, np.repeat(a2[-1:], pad, 0)])
        o = np.asarray(model_fn(a1, a2))
        outs.append(o[:o.shape[0] - pad] if pad else o)
    out = np.concatenate(outs).reshape(T, B, win_h, win_w, -1)
    pred_tiles = out[..., :C]
    conf_tiles = out[..., C] if with_conf else None

    accu_pred = np.zeros((B, H, W, C), np.float32)
    accu_w = np.full((B, H, W), 1e-16, np.float32)
    accu_c = np.zeros((B, H, W), np.float32)
    tiled_losses = []
    for t, (sy, sx) in enumerate(tiles):
        if criterion is not None and gt is not None:
            gtcrop = gt[:, sy, sx]
            tiled_losses.append(_loss(
                criterion, pred_tiles[t], gtcrop,
                conf_tiles[t] if with_conf else None))
        w = (_conf_weight(conf_tiles[t], conf_mode) if with_conf
             else np.ones((B, win_h, win_w), np.float32))
        accu_pred[:, sy, sx] += pred_tiles[t] * w[..., None]
        accu_w[:, sy, sx] += w
        if with_conf:
            accu_c[:, sy, sx] += conf_tiles[t] * w

    pred = accu_pred / accu_w[..., None]
    c = accu_c / accu_w
    assert not np.any(np.isnan(pred))

    if do_change_scale:
        pred = resize_stereo_or_flow(pred, original_hw)

    loss = float(np.mean(tiled_losses)) if tiled_losses else None
    return pred, loss, c
