"""Losses and metrics for stereo and flow finetuning (the JAX package's
stereoflow/criterion.py).

Reference: croco/stereoflow/criterion.py. Predictions and gt are NHWC
(B, H, W, C) with C = 1 (disparity) or 2 (flow); invalid gt pixels are
+inf (the dataset loaders' contract, datasets_stereo.py:551-560). The
reference masks by boolean indexing then means; masked sums are used here
(the same value: the mean over the same pixel set), so nothing waits on the
host.

Losses return a scalar tensor; `with_conf` losses also take the raw
confidence channel (B, H, W). Built by name with build_criterion(): the
reference eval()s the criterion string (stereoflow/train.py:105), here it is
ast-parsed against a registry. The per-dataset accumulators below the
marker are the JAX package's host numpy, verbatim.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch


def _gtnorm(gt: torch.Tensor) -> torch.Tensor:
    """(B,H,W): |gt| for stereo, flow magnitude for flow
    (ref criterion.py:12-16)."""
    if gt.shape[-1] == 1:
        return gt[..., 0]
    return torch.sqrt(torch.sum(gt * gt, dim=-1))


def _valid_mask(gt: torch.Tensor, max_gtnorm: Optional[float]
                ) -> torch.Tensor:
    """(B,H,W) bool: finite gt (all channels), optionally capped by
    gt-norm (ref criterion.py:30-33, 48-51)."""
    mask = torch.all(torch.isfinite(gt), dim=-1)
    if max_gtnorm is not None:
        safe = torch.where(mask[..., None], gt, 0.0)
        mask = mask & (_gtnorm(safe) < max_gtnorm)
    return mask


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    x = torch.where(mask, x, 0.0)
    return torch.sum(x) / torch.clamp(torch.sum(mask), min=1)


def _abs_err(predictions, gt, mask):
    """(B,H,W[,C]) |gt - pred| with the invalid gt zeroed first."""
    return torch.abs(torch.where(mask[..., None], gt, 0.0) - predictions)


@dataclass(frozen=True)
class L1Loss:
    """ref criterion.py:20-36 (per-channel |err| mean over valid gt
    CHANNEL entries: the reference indexes with the (B,C,H,W) mask, so a
    C-channel pixel contributes C terms; the value equals the per-pixel
    mean because the mask is the same on every channel)."""
    max_gtnorm: Optional[float] = None
    with_conf: bool = False

    def __call__(self, predictions, gt, conf=None):
        mask = _valid_mask(gt, self.max_gtnorm)
        err = _abs_err(predictions, gt, mask)
        return _masked_mean(torch.mean(err, dim=-1), mask)


@dataclass(frozen=True)
class LaplacianLoss:
    """CroCo-Stereo on ETH3D: |err|_1 / exp(c) + c (ref criterion.py:41-54)."""
    max_gtnorm: Optional[float] = None
    with_conf: bool = True

    def __call__(self, predictions, gt, conf):
        mask = _valid_mask(gt, self.max_gtnorm)
        err = torch.sum(_abs_err(predictions, gt, mask), dim=-1)
        return _masked_mean(err / torch.exp(conf) + conf, mask)


@dataclass(frozen=True)
class LaplacianLossBounded:
    """CroCo-Flow: c' = (b-a)*sigmoid(c)+a; |err|_1/c' + log c'
    (ref criterion.py:57-70)."""
    max_gtnorm: Optional[float] = 10000.0
    a: float = 0.25
    b: float = 4.0
    with_conf: bool = True

    def __call__(self, predictions, gt, conf):
        mask = _valid_mask(gt, self.max_gtnorm)
        err = torch.sum(_abs_err(predictions, gt, mask), dim=-1)
        c = (self.b - self.a) * torch.sigmoid(conf) + self.a
        return _masked_mean(err / c + torch.log(c), mask)


@dataclass(frozen=True)
class LaplacianLossBounded2:
    """CroCo-Stereo (non-ETH3D): c' = 2a*(sigmoid(c/b)-0.5);
    |err|_1/exp(c') + c' (ref criterion.py:72-85)."""
    max_gtnorm: Optional[float] = None
    a: float = 3.0
    b: float = 3.0
    with_conf: bool = True

    def __call__(self, predictions, gt, conf):
        mask = _valid_mask(gt, self.max_gtnorm)
        err = torch.sum(_abs_err(predictions, gt, mask), dim=-1)
        c = 2 * self.a * (torch.sigmoid(conf / self.b) - 0.5)
        return _masked_mean(err / torch.exp(c) + c, mask)


_CRITERIA = {"L1Loss": L1Loss, "LaplacianLoss": LaplacianLoss,
             "LaplacianLossBounded": LaplacianLossBounded,
             "LaplacianLossBounded2": LaplacianLossBounded2}


def build_criterion(spec: str):
    """'LaplacianLossBounded2()' / 'L1Loss(max_gtnorm=400)' -> instance.
    ast-parsed keyword literals only (the reference eval()s,
    stereoflow/train.py:105)."""
    node = ast.parse(spec.strip(), mode="eval").body
    if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id in _CRITERIA):
        raise ValueError(f"unknown criterion {spec!r}; options: "
                         f"{sorted(_CRITERIA)}")
    kwargs = {k.arg: ast.literal_eval(k.value) for k in node.keywords}
    args = [ast.literal_eval(a) for a in node.args]
    return _CRITERIA[node.func.id](*args, **kwargs)


# ------------------- per-batch metrics (on the device) -------------------

def stereo_metrics(predictions: torch.Tensor, gt: torch.Tensor,
                   bad_ths=(0.5, 1, 2, 3)) -> Dict[str, torch.Tensor]:
    """ref criterion.py:89-113 (StereoMetrics): per-sample masked means,
    then the mean over the batch; 0-d tensors on the inputs' device."""
    b = predictions.shape[0]
    mask = torch.isfinite(gt[..., 0])
    gtc = torch.where(mask[..., None], gt, 999999.0)
    npx = torch.clamp(mask.reshape(b, -1).sum(dim=1), min=1)
    l1 = (torch.abs(gtc - predictions)[..., 0] * mask).reshape(b, -1)
    l2 = (torch.square(gtc - predictions)[..., 0] * mask).reshape(b, -1)
    out = {"avgerr": torch.mean(l1.sum(dim=1) / npx),
           "rmse": torch.mean(torch.sqrt(l2.sum(dim=1) / npx))}
    for th in bad_ths:
        bad = ((l1 > th) & mask.reshape(b, -1)).sum(dim=1) / npx
        out[f"bad@{th:.1f}"] = torch.mean(bad) * 100
    return out


def flow_metrics(predictions: torch.Tensor, gt: torch.Tensor,
                 bad_ths=(1, 3, 5)) -> Dict[str, torch.Tensor]:
    """ref criterion.py:115-133 (FlowMetrics)."""
    b = predictions.shape[0]
    mask = torch.isfinite(gt[..., 0])
    gtc = torch.where(mask[..., None], gt, 999999.0)
    npx = torch.clamp(mask.reshape(b, -1).sum(dim=1), min=1)
    l1 = (torch.abs(gtc - predictions).sum(-1) * mask).reshape(b, -1)
    l2 = (torch.sqrt(torch.square(gtc - predictions).sum(-1))
          * mask).reshape(b, -1)
    out = {"L1err": torch.mean(l1.sum(dim=1) / npx),
           "EPE": torch.mean(l2.sum(dim=1) / npx)}
    for th in bad_ths:
        bad = ((l2 > th) & mask.reshape(b, -1)).sum(dim=1) / npx
        out[f"bad@{th:.1f}"] = torch.mean(bad) * 100
    return out


# ---------------- per-dataset accumulators (host numpy) ----------------

def _spring_min_l1(gt: np.ndarray, pred: np.ndarray) -> np.ndarray:
    """Spring's 2x-supersampled gt: min L1 over the 4 subpixel phases
    (ref criterion.py:156-162)."""
    cands = [np.abs(gt[:, i::2, j::2] - pred).sum(-1)
             for i in (0, 1) for j in (0, 1)]
    return np.minimum.reduce(cands)


class StereoDatasetMetrics:
    """Streaming aggregation across a whole dataset
    (ref criterion.py:141-185): running pixel-weighted mean L1 + bad-pixel
    counters; call reset() / add_batch() / get_results()."""
    bad_ths = (0.5, 1, 2, 3)

    def reset(self):
        self.agg_n = 0
        self.agg_l1 = 0.0
        self.agg_nbad = [0] * len(self.bad_ths)

    def add_batch(self, predictions: np.ndarray, gt: np.ndarray):
        predictions = np.asarray(predictions)
        gt = np.asarray(gt)
        assert predictions.shape[-1] == 1 and gt.shape[-1] == 1
        if gt.shape[1] == predictions.shape[1] * 2 and \
                gt.shape[2] == predictions.shape[2] * 2:
            l1 = _spring_min_l1(gt, predictions)
            valid = np.isfinite(l1)
        else:
            valid = np.isfinite(gt[..., 0])
            l1 = np.abs(gt - predictions).sum(-1)
        n = int(valid.sum())
        if n == 0:
            return
        nnew = self.agg_n + n
        self.agg_l1 = (self.agg_n / nnew * self.agg_l1
                       + l1[valid].mean() * n / nnew)
        self.agg_n = nnew
        for i, th in enumerate(self.bad_ths):
            self.agg_nbad[i] += int((l1[valid] > th).sum())

    def get_results(self) -> Dict[str, float]:
        out = {"L1err": float(self.agg_l1)}
        for i, th in enumerate(self.bad_ths):
            out[f"bad@{th:.1f}"] = self.agg_nbad[i] / max(self.agg_n, 1) * 100
        return out


class FlowDatasetMetrics:
    """ref criterion.py:187-258: adds EPE and per-speed-bin EPE."""
    bad_ths = (0.5, 1, 3, 5)
    speed_ths = ((0, 10), (10, 40), (40, np.inf))

    def reset(self):
        self.agg_n = 0
        self.agg_l1 = 0.0
        self.agg_l2 = 0.0
        self.agg_nbad = [0] * len(self.bad_ths)
        self.agg_epe_speed = [0.0] * len(self.speed_ths)
        self.agg_n_speed = [0] * len(self.speed_ths)

    def add_batch(self, predictions: np.ndarray, gt: np.ndarray):
        predictions = np.asarray(predictions)
        gt = np.asarray(gt)
        assert predictions.shape[-1] == 2 and gt.shape[-1] == 2
        if gt.shape[1] == predictions.shape[1] * 2 and \
                gt.shape[2] == predictions.shape[2] * 2:
            l1 = _spring_min_l1(gt, predictions)
            l2 = np.minimum.reduce(
                [np.sqrt(np.square(gt[:, i::2, j::2] - predictions).sum(-1))
                 for i in (0, 1) for j in (0, 1)])
            valid = np.isfinite(l1)
            speed = sum(np.sqrt(np.square(gt[:, i::2, j::2]).sum(-1))
                        for i in (0, 1) for j in (0, 1)) / 4.0
        else:
            valid = np.isfinite(gt[..., 0])
            l1 = np.abs(gt - predictions).sum(-1)
            l2 = np.sqrt(np.square(gt - predictions).sum(-1))
            speed = np.sqrt(np.square(gt).sum(-1))
        n = int(valid.sum())
        if n == 0:
            return
        nnew = self.agg_n + n
        self.agg_l1 = (self.agg_n / nnew * self.agg_l1
                       + l1[valid].mean() * n / nnew)
        self.agg_l2 = (self.agg_n / nnew * self.agg_l2
                       + l2[valid].mean() * n / nnew)
        self.agg_n = nnew
        for i, th in enumerate(self.bad_ths):
            self.agg_nbad[i] += int((l2[valid] > th).sum())
        sv, l2v = speed[valid], l2[valid]
        for i, (t1, t2) in enumerate(self.speed_ths):
            vv = (sv >= t1) & (sv < t2)
            ns = int(vv.sum())
            if ns == 0:
                continue
            nnew = self.agg_n_speed[i] + ns
            self.agg_epe_speed[i] = (self.agg_n_speed[i] / nnew
                                     * self.agg_epe_speed[i]
                                     + ns / nnew * l2v[vv].mean())
            self.agg_n_speed[i] = nnew

    def get_results(self) -> Dict[str, float]:
        out = {"L1err": float(self.agg_l1), "EPE": float(self.agg_l2)}
        for i, th in enumerate(self.bad_ths):
            out[f"bad@{th:.1f}"] = self.agg_nbad[i] / max(self.agg_n, 1) * 100
        for i, (t1, t2) in enumerate(self.speed_ths):
            name = f"s{int(t1)}" + (f"-{int(t2)}" if np.isfinite(t2) else "+")
            out[name] = float(self.agg_epe_speed[i])
        return out
