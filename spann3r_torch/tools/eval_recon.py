"""Reconstruction metrics (ref spann3r/tools/eval_recon.py:4-56)."""
from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree as KDTree


def completion_ratio(gt_points, rec_points, dist_th=0.05):
    distances, _ = KDTree(rec_points).query(gt_points)
    return float(np.mean((distances < dist_th).astype(np.float32)))


def accuracy(gt_points, rec_points, gt_normals=None, rec_normals=None):
    """Pred->GT nearest-neighbour distance (+ normal consistency)."""
    gt_points = np.asarray(gt_points)
    rec_points = np.asarray(rec_points)
    distances, idx = KDTree(gt_points).query(rec_points, workers=-1)
    acc = float(np.mean(distances))
    acc_median = float(np.median(distances))
    if gt_normals is not None and rec_normals is not None:
        dot = np.abs(np.sum(np.asarray(gt_normals)[idx] * np.asarray(rec_normals),
                            axis=-1))
        return acc, acc_median, float(np.mean(dot)), float(np.median(dot))
    return acc, acc_median


def completion(gt_points, rec_points, gt_normals=None, rec_normals=None):
    """GT->pred nearest-neighbour distance (+ normal consistency)."""
    gt_points = np.asarray(gt_points)
    rec_points = np.asarray(rec_points)
    distances, idx = KDTree(rec_points).query(gt_points, workers=-1)
    comp = float(np.mean(distances))
    comp_median = float(np.median(distances))
    if gt_normals is not None and rec_normals is not None:
        dot = np.abs(np.sum(np.asarray(gt_normals) * np.asarray(rec_normals)[idx],
                            axis=-1))
        return comp, comp_median, float(np.mean(dot)), float(np.median(dot))
    return comp, comp_median


def compute_iou(pred_points, target_points, voxel_size=0.05):
    """Voxel IoU of two point clouds (numpy re-design of the open3d
    voxel-grid version, ref eval_recon.py:41-56)."""
    def vox(points):
        idx = np.floor(np.asarray(points) / voxel_size).astype(np.int64)
        return set(map(tuple, idx))

    a, b = vox(pred_points), vox(target_points)
    if not a and not b:
        return 1.0
    return len(a & b) / len(a | b)
