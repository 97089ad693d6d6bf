"""The eval alignment criterion of the sequence regression losses (ref
spann3r/loss.py + dust3r/losses.py), in PyTorch; the training losses, with
their normalisation and its options, come with training.

Pure functions over stacked tensors:
  gts:   {'pts3d': (T,B,H,W,3) world frame, 'valid_mask': (T,B,H,W) bool,
          'camera_pose': (T,B,4,4) cam2world}
  preds: {'pts3d_1','conf_1','pts3d_2','conf_2'} each (T-1,B,H,W,...), all
         pointmaps already in frame-0 coordinates.
"""
from __future__ import annotations

from typing import Dict

import torch

from .utils.geometry import geotrf, inv_se3
from .utils.masked import masked_median


def add_z(p: torch.Tensor, dz: torch.Tensor) -> torch.Tensor:
    """p with dz (B,) added to its z channel."""
    out = p.clone()
    out[..., 2] = out[..., 2] + dz[:, None, None]
    return out


def _joint_depth_median(zs: torch.Tensor, valids: torch.Tensor) -> torch.Tensor:
    """zs: (K,B,H,W) -> per-batch masked median over all frames (B,)."""
    b = zs.shape[1]
    flat = zs.permute(1, 0, 2, 3).reshape(b, -1)
    m = valids.permute(1, 0, 2, 3).reshape(b, -1)
    return masked_median(flat, m, axis=-1)


def _joint_center_scale(pts_list, valid_list) -> torch.Tensor:
    """Masked median norm about the masked median center (B,)."""
    b = pts_list[0].shape[0]
    pts = torch.stack(pts_list).permute(1, 0, 2, 3, 4).reshape(b, -1, 3)
    m = torch.stack(valid_list).permute(1, 0, 2, 3).reshape(b, -1)
    center = torch.stack([masked_median(pts[..., i], m, axis=-1)
                          for i in range(3)], dim=-1)  # (B,3)
    norm = torch.linalg.norm(pts - center[:, None, :], dim=-1)
    return masked_median(norm, m, axis=-1)


def regr3d_t_scale_shift_inv(gts: Dict, preds: Dict):
    """Eval alignment criterion (ref Regr3D_t_ScaleShiftInv, eval.py:55,
    as the eval builds it: GT scale, no normalisation; ref
    spann3r/loss.py:129-247, 294-364).

    Moves the GT into camera 0's frame, subtracts the joint masked median
    depth from GT and prediction, and scales the prediction to the GT by
    their median norms about the median centre. The statistics carry no
    gradient, like the reference's @torch.no_grad() helpers (loss.py:87,
    106).

    Returns (gt_pts list[T], pr_l list[T-1], pr_r list[T-1], valids list[T],
    monitoring): monitoring holds the PRE-subtraction shift and the scales
    (the reference exposes them via its monitoring dict,
    spann3r/loss.py:321,362 — eval re-anchors with them)."""
    t = gts["pts3d"].shape[0]
    in_cam1 = inv_se3(gts["camera_pose"][0])  # (B,4,4)
    gt_pts = [geotrf(in_cam1, gts["pts3d"][i]) for i in range(t)]
    valids = [gts["valid_mask"][i] for i in range(t)]
    pr_l = [preds["pts3d_1"][i] for i in range(t - 1)]
    pr_r = [preds["pts3d_2"][i] for i in range(t - 1)]

    gt_z = torch.stack([g[..., 2] for g in gt_pts])            # (T,B,H,W)
    pr_z = torch.stack([p[..., 2] for p in pr_l] + [pr_r[-1][..., 2]])
    vm = torch.stack(valids)  # pred frames 0..t-2 then t-1 = same order
    gt_shift = _joint_depth_median(gt_z, vm).detach()
    pr_shift = _joint_depth_median(pr_z, vm).detach()
    gt_pts = [add_z(g, -gt_shift) for g in gt_pts]
    pr_l = [add_z(p, -pr_shift) for p in pr_l]
    pr_r = [add_z(p, -pr_shift) for p in pr_r]

    gt_scale = _joint_center_scale(gt_pts, valids).detach()
    pr_scale = _joint_center_scale(pr_l + [pr_r[-1]], valids).detach()
    pr_scale = pr_scale.clamp(1e-3, 1e3)
    r = (gt_scale / pr_scale)[:, None, None, None]
    pr_l = [p * r for p in pr_l]
    pr_r = [p * r for p in pr_r]

    monitoring = {"gt_shift_z": gt_shift, "pred_shift_z": pr_shift,
                  "gt_scale": gt_scale, "pred_scale": pr_scale}
    return gt_pts, pr_l, pr_r, valids, monitoring
