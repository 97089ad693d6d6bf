"""Scene-level reconstruction + alignment for the port's eval CLI.

Implements the reference's per-scene eval protocol (eval.py:100-160): run
the reconstruction, stack the pairwise predictions, scale-shift-invariant
alignment against GT with the GT median-depth re-anchor, and transform
into the world frame of camera 0. The alignment runs in torch on the
model's device; the results come back as numpy.
"""
from __future__ import annotations

import numpy as np
import torch


def evaluate_scene(model, cfg, prec, batch, offline=False,
                   scene_graph="complete"):
    """Run reconstruction + alignment for one scene.

    batch: collated views of ONE scene (leading axis T, batch dim 1).
    Returns (pts_aligned (T,H,W,3), gt_aligned, masks, colors, fps,
    raw preds, frame order, conf (T,H,W)) — everything in the world frame
    of the first ordered camera, GT scale.
    """
    from .. import losses as L
    from ..api import reconstruct_video
    from ..utils.geometry import geotrf

    preds, order, fps = reconstruct_video(
        model, cfg, batch["img"], prec, offline=offline,
        scene_graph=scene_graph)
    dev = next(model.parameters()).device
    on_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # stack predictions as (T-1,...) pairs for the alignment criterion
    t = len(preds)
    key = lambda j: "pts3d" if j == 0 else "pts3d_in_other_view"
    pts_seq = np.stack([np.asarray(preds[j][key(j)], np.float32)[0]
                        for j in range(t)])
    conf_seq = np.stack([np.asarray(preds[j]["conf"], np.float32)[0]
                         for j in range(t)])

    ordered = {k: batch[k][order] for k in
               ("pts3d", "valid_mask", "camera_pose", "img")}
    gts = {"pts3d": on_dev(ordered["pts3d"].astype(np.float32)),
           "valid_mask": on_dev(ordered["valid_mask"]),
           "camera_pose": on_dev(ordered["camera_pose"].astype(np.float32))}
    # preds_(1/2) layout expected by the criterion: left list = frames
    # 0..T-2, right list = frames 1..T-1 (ref loss.py:137-180)
    pts_dev, conf_dev = on_dev(pts_seq), on_dev(conf_seq)
    preds_t = {"pts3d_1": pts_dev[:-1, None], "pts3d_2": pts_dev[1:, None],
               "conf_1": conf_dev[:-1, None], "conf_2": conf_dev[1:, None]}

    with torch.no_grad():
        gt_pts, pr_l, pr_r, _, monitoring = L.regr3d_t_scale_shift_inv(
            gts, preds_t)

        # re-anchor into the world frame (ref eval.py:139-156): add back
        # the PRE-subtraction GT median depth shift and transform by
        # camera_pose[0]
        gt_shift = monitoring["gt_shift_z"]
        in_cam1 = gts["camera_pose"][0]

        pts_aligned, gt_aligned = [], []
        for j in range(t):
            p = pr_l[j] if j < t - 1 else pr_r[-1]
            p = L.add_z(p, gt_shift)
            g = L.add_z(gt_pts[j], gt_shift)
            pts_aligned.append(geotrf(in_cam1, p)[0])
            gt_aligned.append(geotrf(in_cam1, g)[0])
        pts_aligned = torch.stack(pts_aligned).cpu().numpy()
        gt_aligned = torch.stack(gt_aligned).cpu().numpy()

    masks = ordered["valid_mask"][:, 0]
    colors = (ordered["img"][:, 0] + 1.0) / 2.0
    return (pts_aligned, gt_aligned, masks, colors, fps, preds, order,
            conf_seq)
