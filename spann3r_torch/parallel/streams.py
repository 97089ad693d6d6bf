"""Multi-stream serving split over ranks: B independent video streams dealt
to the data ranks of a mesh, each rank scanning its contiguous block of
streams with its own carry (its own memory bank), the results gathered in
stream order.

The JAX package shows the same thing on one process's device mesh
(tests/test_sharded_inference.py): the carry sharded over 'data', the
streams split over the devices, the results equal to single-stream scans.
Here the ranks are processes (`parallel/mesh.make_mesh_for_batch`):

    mesh = make_mesh_for_batch(B)      # None on a rank that takes no streams
    out = scan_streams(model, cfg, frames, hw, prec, mesh)
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..config import BF16, Precision, Spann3RConfig
from ..models.spann3r import (Spann3R, head2_from_hooks, init_video_carry,
                              scan_video_chunk)
from .mesh import Mesh, batch_block, gather_streams


@torch.no_grad()
def scan_streams(model: Spann3R, cfg: Spann3RConfig, frames: np.ndarray,
                 img_hw: Tuple[int, int], prec: Precision = BF16,
                 mesh: Mesh = None, chunk: int = 16) -> Dict[str, np.ndarray]:
    """frames (T, B, H, W, 3), the same on every rank (uint8 or
    normalised float): this data rank's block of streams through
    `scan_video_chunk` in chunks, from its own `init_video_carry`, then the
    deferred target-frame head on its carry. Returns, on every rank of the
    mesh, fp32 numpy in stream order: 'pts3d' (T, B, H, W, 3) and 'conf'
    (T, B, H, W), zero on the frames that emit nothing, 'emitted' (T,)
    bool, and the head's 'pts3d_2' (B, H, W, 3) and 'conf_2' (B, H, W).
    Without a mesh, one process takes every stream."""
    mesh = mesh or Mesh(1, 1, 0, 0, None, None)
    dev = next(model.parameters()).device
    t_len = frames.shape[0]
    mine = torch.from_numpy(np.ascontiguousarray(
        frames[:, batch_block(mesh, frames.shape[1])])).to(dev)
    b = mine.shape[1]
    carry = init_video_carry(cfg, img_hw, b, prec, device=dev)
    ys = []
    for s in range(0, t_len, chunk):
        carry, y = scan_video_chunk(model, cfg, carry, mine[s:s + chunk],
                                    img_hw, prec)
        ys.extend(y)
    res2 = head2_from_hooks(model, cfg, carry.dec2_prev, img_hw, prec)

    h, w = img_hw
    pts = np.zeros((t_len, b, h, w, 3), np.float32)
    conf = np.zeros((t_len, b, h, w), np.float32)
    for i, y in enumerate(ys):
        if y is not None:
            pts[i] = y["pts3d"].float().cpu().numpy()
            conf[i] = y["conf"].float().cpu().numpy()
    emitted = np.array([[y is not None] * b for y in ys], np.uint8)
    host = lambda x: x.float().cpu().numpy()[None]    # (1, b, ...)
    out = {"pts3d": gather_streams(mesh, pts),
           "conf": gather_streams(mesh, conf),
           "pts3d_2": gather_streams(mesh, host(res2["pts3d"]))[0],
           "conf_2": gather_streams(mesh, host(res2["conf"]))[0]}
    em = gather_streams(mesh, emitted).astype(bool)      # (T, B)
    if not (em == em[:, :1]).all():
        raise AssertionError("the ranks' streams emitted on other frames")
    out["emitted"] = em[:, 0]
    return out
