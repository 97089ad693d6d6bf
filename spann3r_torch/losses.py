"""Sequence regression losses (ref spann3r/loss.py + dust3r/losses.py), in
PyTorch: the training criterion (`conf_loss_t` over `regr3d_t_frame_losses`,
with the normalisation options of `get_all_pts3d_t`) and the eval
alignment criterion (`regr3d_t_scale_shift_inv`). The pair losses and
`find_opt_scaling` of the JAX package (pretraining, global alignment) are
not ported yet.

Pure functions over stacked tensors:
  gts:   {'pts3d': (T,B,H,W,3) world frame, 'valid_mask': (T,B,H,W) bool,
          'camera_pose': (T,B,4,4) cam2world}
  preds: {'pts3d_1','conf_1','pts3d_2','conf_2'} each (T-1,B,H,W,...), all
         pointmaps already in frame-0 coordinates.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .utils.geometry import geotrf, inv_se3
from .utils.masked import masked_mean, masked_median


def l21(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Per-pixel euclidean distance (ref dust3r/losses.py:52-59)."""
    return torch.linalg.vector_norm(pred - gt, dim=-1)


# ---------------------------------------------------------------------------
# normalization (ref spann3r/loss.py:22-84)
# ---------------------------------------------------------------------------

def _avg_dis_factor(pts_list, valid_list, fix_first: bool) -> torch.Tensor:
    """norm_factor (B,): per-sample distance sum / batch-total valid count
    (the reference's quirk: the count sums over the whole batch)."""
    n_use = 1 if fix_first else len(pts_list)
    num = 0.0
    den = 0.0
    for pts, valid in zip(pts_list[:n_use], valid_list[:n_use]):
        dis = torch.linalg.vector_norm(pts, dim=-1)         # (B, H, W)
        m = valid.to(dis.dtype)
        num = num + (dis * m).sum(dim=(-2, -1))             # (B,)
        den = den + m.sum()                                 # scalar
    factor = num / (den + 1e-8)
    return factor.clamp(min=1e-8)


def normalize_pointcloud_t(pts_l, pts_r, valids, fix_first: bool
                           ) -> Tuple[list, list, torch.Tensor]:
    """Joint normalization of predictions: factor from pts_l (+ last
    pts_r)."""
    factor = _avg_dis_factor(list(pts_l) + [pts_r[-1]], list(valids),
                             fix_first)
    f = factor[:, None, None, None]
    return [p / f for p in pts_l], [p / f for p in pts_r], factor


def normalize_gt_t(gt_pts, valids, fix_first: bool
                   ) -> Tuple[list, torch.Tensor]:
    factor = _avg_dis_factor(list(gt_pts), list(valids), fix_first)
    f = factor[:, None, None, None]
    return [p / f for p in gt_pts], factor


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


def get_all_pts3d_t(gts: Dict, preds: Dict, norm_mode: bool = True,
                    gt_scale: bool = False, fix_first: bool = False,
                    dist_clip: Optional[float] = None,
                    shift_inv: bool = False, scale_inv: bool = False):
    """Transform the GT into camera 0's frame, collect the prediction lists,
    normalize (ref spann3r/loss.py:129-247).

    Returns (gt_pts list[T], pr_l list[T-1], pr_r list[T-1], gt_factor,
    pr_factor, valids list[T], monitoring). The shift and scale statistics
    carry no gradient, like the reference's @torch.no_grad() helpers
    (loss.py:87, 106); monitoring holds their PRE-subtraction values (the
    reference exposes them, spann3r/loss.py:321,362 — eval re-anchors with
    them)."""
    monitoring = {}
    t = gts["pts3d"].shape[0]
    in_cam1 = inv_se3(gts["camera_pose"][0])  # (B,4,4)
    gt_pts = [geotrf(in_cam1, gts["pts3d"][i]) for i in range(t)]
    valids = [gts["valid_mask"][i] for i in range(t)]
    if dist_clip is not None:
        valids = [v & (torch.linalg.vector_norm(gts["pts3d"][i], dim=-1)
                       <= dist_clip) for i, v in enumerate(valids)]
    pr_l = [preds["pts3d_1"][i] for i in range(t - 1)]
    pr_r = [preds["pts3d_2"][i] for i in range(t - 1)]

    gt_factor = pr_factor = None
    if norm_mode:
        pr_l, pr_r, pr_factor = normalize_pointcloud_t(pr_l, pr_r, valids,
                                                       fix_first)
        if not gt_scale:
            gt_pts, gt_factor = normalize_gt_t(gt_pts, valids, fix_first)

    if shift_inv:
        # subtract the joint masked median depth (ref loss.py:294-322)
        gt_z = torch.stack([g[..., 2] for g in gt_pts])            # (T,B,H,W)
        pr_z = torch.stack([p[..., 2] for p in pr_l] + [pr_r[-1][..., 2]])
        vm = torch.stack(valids)  # pred frames 0..t-2 then t-1 = same order
        gt_shift = _joint_depth_median(gt_z, vm).detach()
        pr_shift = _joint_depth_median(pr_z, vm).detach()
        monitoring["gt_shift_z"] = gt_shift
        monitoring["pred_shift_z"] = pr_shift
        gt_pts = [add_z(g, -gt_shift) for g in gt_pts]
        pr_l = [add_z(p, -pr_shift) for p in pr_l]
        pr_r = [add_z(p, -pr_shift) for p in pr_r]

    if scale_inv:
        # median-center / median-norm scale alignment (ref loss.py:325-364)
        gt_scale_v = _joint_center_scale(gt_pts, valids).detach()
        pr_scale_v = _joint_center_scale(pr_l + [pr_r[-1]], valids).detach()
        pr_scale_v = pr_scale_v.clamp(1e-3, 1e3)
        monitoring["gt_scale"] = gt_scale_v
        monitoring["pred_scale"] = pr_scale_v
        if gt_scale:
            r = (gt_scale_v / pr_scale_v)[:, None, None, None]
            pr_l = [p * r for p in pr_l]
            pr_r = [p * r for p in pr_r]
        else:
            r = (pr_scale_v / gt_scale_v)[:, None, None, None]
            pr_l = [p * r for p in pr_l]
            pr_r = [p * r for p in pr_r]
            g = (gt_scale_v / pr_scale_v)[:, None, None, None]
            gt_pts = [x * g for x in gt_pts]

    return gt_pts, pr_l, pr_r, gt_factor, pr_factor, valids, monitoring


def regr3d_t_scale_shift_inv(gts: Dict, preds: Dict):
    """Eval alignment criterion (ref Regr3D_t_ScaleShiftInv, eval.py:55,
    as the eval builds it: GT scale, no normalisation): the GT in camera
    0's frame, the joint masked median depth subtracted from GT and
    prediction, the prediction scaled to the GT by their median norms
    about the median centre.

    Returns (gt_pts list[T], pr_l list[T-1], pr_r list[T-1], valids list[T],
    monitoring {'gt_shift_z', 'pred_shift_z', 'gt_scale', 'pred_scale'})."""
    gt_pts, pr_l, pr_r, _, _, valids, monitoring = get_all_pts3d_t(
        gts, preds, norm_mode=False, gt_scale=True, shift_inv=True,
        scale_inv=True)
    return gt_pts, pr_l, pr_r, valids, monitoring


def regr3d_t_frame_losses(gts: Dict, preds: Dict, **kw):
    """Per-frame L21 losses on both branches (ref loss.py:184-247).

    Returns (losses list of (T-1)*2 per-pixel maps, masks, confs,
    factor_loss, details)."""
    gt_pts, pr_l, pr_r, gt_factor, pr_factor, valids, _ = \
        get_all_pts3d_t(gts, preds, **kw)
    t = len(gt_pts)
    losses, masks, confs = [], [], []
    for i in range(t):
        if i != t - 1:  # left / reference branch
            losses.append(l21(pr_l[i], gt_pts[i]))
            masks.append(valids[i])
            confs.append(preds["conf_1"][i])
        if i != 0:      # right / target branch
            losses.append(l21(pr_r[i - 1], gt_pts[i]))
            masks.append(valids[i])
            confs.append(preds["conf_2"][i - 1])

    # scale-overshoot penalty (ref loss.py:229-237, consumed training.py:217)
    if pr_factor is not None and gt_factor is not None:
        over = (pr_factor > gt_factor).to(pr_factor.dtype)
        diff = (pr_factor - gt_factor).abs()
        factor_loss = (diff * over).sum() / over.sum().clamp(min=1)
    else:
        factor_loss = torch.zeros((), device=gts["pts3d"].device)

    details = {"loss_pts3d_1": masked_mean(losses[0], masks[0]),
               "loss_pts3d_2": masked_mean(losses[1], masks[1])}
    return losses, masks, confs, factor_loss, details


def conf_loss_t(gts: Dict, preds: Dict, alpha: float = 0.4, **kw):
    """Confidence-weighted sequence loss (ref spann3r/loss.py:250-291).

    Returns (scalar loss, details, factor_loss)."""
    losses, masks, confs, factor_loss, details = regr3d_t_frame_losses(
        gts, preds, **kw)
    conf_losses = []
    conf_sum = 0.0
    for loss, mask, conf in zip(losses, masks, confs):
        cl = masked_mean(loss * conf - alpha * torch.log(conf), mask)
        # a frame with no valid pixel contributes 0, not NaN (ref
        # loss.py:284); conf_mean is left unguarded like the reference's
        cl = torch.where(mask.any(), cl, torch.zeros_like(cl))
        conf_losses.append(cl)
        conf_sum = conf_sum + masked_mean(conf, mask)
    conf_losses = torch.stack(conf_losses) * 2.0
    loss = conf_losses.mean()
    details = dict(details, conf_loss_1=conf_losses[0],
                   conf_loss_2=conf_losses[1],
                   conf_mean=conf_sum / len(losses))
    return loss, details, factor_loss
