"""Sequence regression losses (ref spann3r/loss.py + dust3r/losses.py), in
PyTorch: the training criterion (`conf_loss_t` over `regr3d_t_frame_losses`,
with the normalisation options of `get_all_pts3d_t`) and the eval
alignment criterion (`regr3d_t_scale_shift_inv`); and the two-view
(pairwise DUSt3R) losses `regr3d_pair` and `conf_loss_pair`, with the
optimal-scale fit `find_opt_scaling`.

Over several processes (`group`: the data group of parallel/mesh.py)
each rank holds its part of the batch, and the criterion's batch-wide
statistics are taken over the whole batch, as the JAX package takes them
on its global batch: the batch-total valid count of the normalisation,
each frame's masked sums and counts, and the scale-overshoot sum and
count are summed over the group (`all_reduce_sum`), so that every rank
holds the loss of the whole batch and its backward yields the derivative
through its own samples only; the trainer then sums the gradients over
the group. `group=None` is the one-process criterion.

Pure functions over stacked tensors:
  gts:   {'pts3d': (T,B,H,W,3) world frame, 'valid_mask': (T,B,H,W) bool,
          'camera_pose': (T,B,4,4) cam2world}
  preds: {'pts3d_1','conf_1','pts3d_2','conf_2'} each (T-1,B,H,W,...), all
         pointmaps already in frame-0 coordinates.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .parallel.mesh import all_reduce_sum
from .utils.geometry import geotrf, inv_se3
from .utils.masked import masked_mean, masked_median, sum_ratio


def l21(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Per-pixel euclidean distance (ref dust3r/losses.py:52-59)."""
    return torch.linalg.vector_norm(pred - gt, dim=-1)


# ---------------------------------------------------------------------------
# normalization (ref spann3r/loss.py:22-84)
# ---------------------------------------------------------------------------

def _group_sums(vals, group):
    """`vals` (scalars) summed over the group, in one collective; `vals`
    as they are without a group."""
    if group is None:
        return list(vals)
    return list(all_reduce_sum(torch.stack(list(vals)), group).unbind(0))


def _avg_dis_factor(pts_list, valid_list, fix_first: bool,
                    group=None) -> torch.Tensor:
    """norm_factor (B,): per-sample distance sum / batch-total valid count
    (the reference's quirk: the count sums over the whole batch, over the
    group's ranks too)."""
    n_use = 1 if fix_first else len(pts_list)
    num = 0.0
    den = 0.0
    for pts, valid in zip(pts_list[:n_use], valid_list[:n_use]):
        dis = torch.linalg.vector_norm(pts, dim=-1)         # (B, H, W)
        m = valid.to(dis.dtype)
        num = num + (dis * m).sum(dim=(-2, -1))             # (B,)
        den = den + m.sum()                                 # scalar
    if group is not None:
        den = all_reduce_sum(den, group)
    factor = num / (den + 1e-8)
    return factor.clamp(min=1e-8)


def normalize_pointcloud_t(pts_l, pts_r, valids, fix_first: bool, group=None
                           ) -> Tuple[list, list, torch.Tensor]:
    """Joint normalization of predictions: factor from pts_l (+ last
    pts_r)."""
    factor = _avg_dis_factor(list(pts_l) + [pts_r[-1]], list(valids),
                             fix_first, group)
    f = factor[:, None, None, None]
    return [p / f for p in pts_l], [p / f for p in pts_r], factor


def normalize_gt_t(gt_pts, valids, fix_first: bool, group=None
                   ) -> Tuple[list, torch.Tensor]:
    factor = _avg_dis_factor(list(gt_pts), list(valids), fix_first, group)
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
                    shift_inv: bool = False, scale_inv: bool = False,
                    group=None):
    """Transform the GT into camera 0's frame, collect the prediction lists,
    normalize (ref spann3r/loss.py:129-247).

    Returns (gt_pts list[T], pr_l list[T-1], pr_r list[T-1], gt_factor,
    pr_factor, valids list[T], monitoring). The shift and scale statistics
    carry no gradient, like the reference's @torch.no_grad() helpers
    (loss.py:87, 106); monitoring holds their PRE-subtraction values (the
    reference exposes them, spann3r/loss.py:321,362 — eval re-anchors with
    them). `group`: the normalisation's valid count over the data group
    (the shift and scale statistics are per sample)."""
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
                                                       fix_first, group)
        if not gt_scale:
            gt_pts, gt_factor = normalize_gt_t(gt_pts, valids, fix_first,
                                               group)

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


def regr3d_t_frame_losses(gts: Dict, preds: Dict, group=None, **kw):
    """Per-frame L21 losses on both branches (ref loss.py:184-247).
    `group`: the batch-wide statistics over the data group.

    Returns (losses list of (T-1)*2 per-pixel maps, masks, confs,
    factor_loss, details)."""
    gt_pts, pr_l, pr_r, gt_factor, pr_factor, valids, _ = \
        get_all_pts3d_t(gts, preds, group=group, **kw)
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
        num, den = _group_sums([(diff * over).sum(), over.sum()], group)
        factor_loss = num / den.clamp(min=1)
    else:
        factor_loss = torch.zeros((), device=gts["pts3d"].device)

    sums = []
    for loss, mask in zip(losses[:2], masks[:2]):
        m = mask.to(loss.dtype)
        sums += [(loss * m).sum(), m.sum()]
    s1, n1, s2, n2 = _group_sums(sums, group)
    details = {"loss_pts3d_1": sum_ratio(s1, n1),
               "loss_pts3d_2": sum_ratio(s2, n2)}
    return losses, masks, confs, factor_loss, details


def conf_loss_t(gts: Dict, preds: Dict, alpha: float = 0.4, group=None,
                **kw):
    """Confidence-weighted sequence loss (ref spann3r/loss.py:250-291).
    `group`: each frame's masked means over the data group's whole batch.

    Returns (scalar loss, details, factor_loss)."""
    losses, masks, confs, factor_loss, details = regr3d_t_frame_losses(
        gts, preds, group=group, **kw)
    sums = []
    for loss, mask, conf in zip(losses, masks, confs):
        m = mask.to(loss.dtype)
        x = loss * conf - alpha * torch.log(conf)
        sums += [(x * m).sum(), m.sum(), (conf * mask.to(conf.dtype)).sum()]
    sums = _group_sums(sums, group)
    conf_losses = []
    conf_sum = 0.0
    for i in range(len(losses)):
        num, den, conf_num = sums[3 * i:3 * i + 3]
        # a frame with no valid pixel contributes 0, not NaN (ref
        # loss.py:284); conf_mean is left unguarded like the reference's
        cl = sum_ratio(num, den)
        conf_losses.append(torch.where(den > 0, cl, torch.zeros_like(cl)))
        conf_sum = conf_sum + sum_ratio(conf_num, den)
    conf_losses = torch.stack(conf_losses) * 2.0
    loss = conf_losses.mean()
    details = dict(details, conf_loss_1=conf_losses[0],
                   conf_loss_2=conf_losses[1],
                   conf_mean=conf_sum / len(losses))
    return loss, details, factor_loss


# ---------------------------------------------------------------------------
# two-view (pairwise DUSt3R-style) losses (ref dust3r/losses.py:140-236)
# ---------------------------------------------------------------------------

def _normalize_pair(pts1, pts2, valid1, valid2):
    """avg_dis joint normalization of a two-view pair
    (ref dust3r/utils/geometry.py:246-304), a denominator per sample."""
    d1 = torch.linalg.vector_norm(pts1, dim=-1) * valid1.to(pts1.dtype)
    d2 = torch.linalg.vector_norm(pts2, dim=-1) * valid2.to(pts2.dtype)
    nnz = valid1.sum(dim=(-2, -1)) + valid2.sum(dim=(-2, -1))
    factor = (d1.sum(dim=(-2, -1)) + d2.sum(dim=(-2, -1))) / (nnz + 1e-8)
    factor = factor.clamp(min=1e-8)[:, None, None, None]
    return pts1 / factor, pts2 / factor


def regr3d_pair(gt1: Dict, gt2: Dict, pred1: Dict, pred2: Dict,
                norm_mode: bool = True, gt_scale: bool = False):
    """Two-view Regr3D (ref dust3r/losses.py:156-192): per-pixel L21 on both
    views in camera-1 coordinates. Returns (l1, l2, mask1, mask2)."""
    in_cam1 = inv_se3(gt1["camera_pose"])
    gt_pts1 = geotrf(in_cam1, gt1["pts3d"])
    gt_pts2 = geotrf(in_cam1, gt2["pts3d"])
    v1, v2 = gt1["valid_mask"], gt2["valid_mask"]
    pr1, pr2 = pred1["pts3d"], pred2["pts3d_in_other_view"]
    if norm_mode:
        pr1, pr2 = _normalize_pair(pr1, pr2, v1, v2)
        if not gt_scale:
            gt_pts1, gt_pts2 = _normalize_pair(gt_pts1, gt_pts2, v1, v2)
    return l21(pr1, gt_pts1), l21(pr2, gt_pts2), v1, v2


def conf_loss_pair(gt1, gt2, pred1, pred2, alpha: float = 0.2, **kw):
    """Two-view ConfLoss (ref dust3r/losses.py:195-236)."""
    l1, l2, m1, m2 = regr3d_pair(gt1, gt2, pred1, pred2, **kw)
    c1, c2 = pred1["conf"], pred2["conf"]
    cl1 = masked_mean(l1 * c1 - alpha * torch.log(c1), m1)
    cl2 = masked_mean(l2 * c2 - alpha * torch.log(c2), m2)
    return cl1 + cl2, {"conf_loss_1": cl1, "conf_loss2": cl2}


def find_opt_scaling(gt_pts1, gt_pts2, pr_pts1, pr_pts2=None,
                     fit_mode: str = "weiszfeld_stop_grad",
                     valid1=None, valid2=None) -> torch.Tensor:
    """Optimal gt->pred scale (B,) via mean / median / Weiszfeld IRLS
    (ref dust3r/inference.py:112-156)."""
    def flat(p, v):
        pf = p.reshape(p.shape[0], -1, 3)
        vf = (v.reshape(p.shape[0], -1) if v is not None else
              torch.ones(pf.shape[:2], dtype=torch.bool, device=p.device))
        return pf, vf

    gt, m = flat(gt_pts1, valid1)
    pr, _ = flat(pr_pts1, valid1)
    if gt_pts2 is not None:
        g2, m2 = flat(gt_pts2, valid2)
        p2, _ = flat(pr_pts2, valid2)
        gt, pr, m = (torch.cat([gt, g2], 1), torch.cat([pr, p2], 1),
                     torch.cat([m, m2], 1))

    dot_gp = (pr * gt).sum(-1)
    dot_gg = gt.square().sum(-1)

    def ratio(w):
        return masked_mean(w * dot_gp, m, axis=1) / \
            masked_mean(w * dot_gg, m, axis=1).clamp(min=1e-12)

    if fit_mode.startswith("avg"):
        scaling = ratio(1.0)
    elif fit_mode.startswith("median"):
        scaling = masked_median(torch.where(
            m, dot_gp / dot_gg.clamp(min=1e-12), torch.zeros_like(dot_gp)),
            m, axis=-1)
    elif fit_mode.startswith("weiszfeld"):
        scaling = ratio(1.0)
        for _ in range(10):
            dis = torch.linalg.vector_norm(pr - scaling[:, None, None] * gt,
                                           dim=-1)
            scaling = ratio(1.0 / dis.clamp(min=1e-8))
    else:
        raise ValueError(f"bad fit_mode {fit_mode}")

    if fit_mode.endswith("stop_grad"):
        scaling = scaling.detach()
    return scaling.clamp(min=1e-3)
