"""Training and validation loops for stereo and flow finetuning (the JAX
package's stereoflow/engine.py).

Reference: croco/stereoflow/engine.py (train_one_epoch,
validate_one_epoch) and stereoflow/train.py's model and optimizer
assembly. One step: the binocular forward (K2 and K3 through
`ops.attention` on the card) and the fp32 pixelwise DPT head, the
criterion, the gradients against the fp32 weights, AdamW(0.9, 0.95) with
the JAX package's decay rule and no clip, the per-iteration cosine LR
applied to the update; the batch metrics on the device. Validation runs
the chunked tiled_pred with each chunk of tiles on the model's device.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import BF16, DUSt3RConfig, Precision
from ..models.croco_downstream import (cfg_from_croco_kwargs, croco_backbone,
                                       downstream_binocular)
from ..training import Optimizer, apply_updates_, lr_at
from ..training import make_optimizer as _adamw
from ..utils.metrics import MetricLogger, SmoothedValue
from .criterion import flow_metrics, stereo_metrics
from .head import PixelwiseTaskWithDPT, pixelwise_dpt_apply
from .tiling import tiled_pred

# the block stacks, whose parameters the JAX package stacks on a leading
# depth axis (so its decay rule, two or more dimensions, decays them all)
_STACKED = ("croco.enc_blocks.", "croco.dec_blocks.")


def cfg_from_croco_args(kw: Dict, crop_hw: Tuple[int, int]) -> DUSt3RConfig:
    """CroCoNet checkpoint kwargs -> DUSt3RConfig with img_size forced to
    the training crop (ref stereoflow/train.py:109-112). The reference
    interpolates stored cosine pos embeds to the new crop (train.py:122);
    here the sin-cos tables are computed for each grid, so nothing is
    interpolated."""
    kw = dict(kw)
    kw.pop("img_size", None)
    kw.pop("mask_ratio", None)
    return cfg_from_croco_kwargs(kw, tuple(crop_hw))


class StereoFlowNet(nn.Module):
    """The CroCo backbone (no mask token, no prediction head) and the
    pixelwise DPT task head: the model stereoflow/train.py:116-124
    assembles, under `croco.` and `head.`."""

    def __init__(self, cfg: DUSt3RConfig, num_channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.croco = croco_backbone(cfg, "cpu", generator)
        self.head = PixelwiseTaskWithDPT(cfg, num_channels)
        self.head.init_weights_(generator)


def init_stereoflow(generator: Optional[torch.Generator], cfg: DUSt3RConfig,
                    num_channels: int, device="cuda"
                    ) -> Tuple[StereoFlowNet, List[int]]:
    """(model on `device`, hooks), initialised by the JAX package's rules
    from `generator`."""
    model = StereoFlowNet(cfg, num_channels, generator)
    return model.to(device), model.head.hooks


def decay_mask(name: str, shape) -> bool:
    """The JAX package's decay rule on the stereoflow parameters
    (training.py:127-130): leaves of two or more dimensions, and so every
    parameter of the CroCo block stacks, which JAX holds stacked on a depth
    axis (ROADMAP C4)."""
    return len(shape) > 1 or name.startswith(_STACKED)


def make_optimizer(weight_decay: float) -> Optimizer:
    """AdamW(0.9, 0.95), eps 1e-8, decay by `decay_mask`, no gradient clip
    (ref stereoflow/train.py:68+140; the JAX package's scale_by_adam +
    add_decayed_weights); the LR is applied by the step."""
    return _adamw(weight_decay, max_norm=None, decay=decay_mask)


def make_forward(cfg: DUSt3RConfig, prec: Precision = BF16):
    """(model, img1, img2) -> (B, H, W, num_channels) raw map, fp32."""

    def forward(model: StereoFlowNet, img1, img2):
        def head_fn(states, img_hw):
            return pixelwise_dpt_apply(model.head, states, img_hw,
                                       cfg.patch_size)

        return downstream_binocular(model.croco, img1, img2, cfg, head_fn,
                                    prec=prec)

    return forward


def make_tile_fn(model: StereoFlowNet, cfg: DUSt3RConfig,
                 prec: Precision = BF16):
    """tiled_pred's model_fn: a chunk of numpy tiles to the model's device,
    the forward without gradients, the result back as numpy."""
    forward = make_forward(cfg, prec)
    dev = next(model.parameters()).device

    @torch.no_grad()
    def model_fn(a, b):
        out = forward(model, torch.from_numpy(np.ascontiguousarray(a)).to(dev),
                      torch.from_numpy(np.ascontiguousarray(b)).to(dev))
        return out.float().cpu().numpy()

    return model_fn


def split_prediction_conf(out: torch.Tensor, with_conf: bool):
    """(B,H,W,C[+1]) -> (pred, conf | None) (ref engine.py:18-23)."""
    if not with_conf:
        return out, None
    return out[..., :-1], out[..., -1]


def stereoflow_loss_and_grads(model: StereoFlowNet, cfg: DUSt3RConfig,
                              criterion, img1, img2, gt,
                              prec: Precision = BF16):
    """(loss, {name: grad}, pred) of the criterion on one batch, the
    gradients against the fp32 parameters, all on the device."""
    forward = make_forward(cfg, prec)
    params = dict(model.named_parameters())
    with torch.enable_grad():
        out = forward(model, img1, img2)
        pred, conf = split_prediction_conf(out, criterion.with_conf)
        loss = (criterion(pred, gt, conf) if criterion.with_conf
                else criterion(pred, gt))
        # refinenet4's first residual unit has no skip input to act on: its
        # gradient is zero, as JAX's, and AdamW still decays its weights
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()), allow_unused=True,
            materialize_grads=True)))
    return loss.detach(), grads, pred.detach()


def make_train_step(cfg: DUSt3RConfig, criterion, task: str, opt: Optimizer,
                    prec: Precision = BF16):
    """step(model, opt_state, img1, img2, gt, lr) -> (opt_state, loss,
    batch metrics): the gradients, the AdamW update applied in place at
    `lr`, and the batch metrics, all left on the device (the reference's
    amp step + metrics calls, engine.py:61-86)."""
    metrics_fn = stereo_metrics if task == "stereo" else flow_metrics

    def step(model, opt_state, img1, img2, gt, lr):
        loss, grads, pred = stereoflow_loss_and_grads(model, cfg, criterion,
                                                      img1, img2, gt, prec)
        params = dict(model.named_parameters())
        updates, opt_state = opt.update(grads, opt_state, params)
        apply_updates_(params, updates, lr)
        with torch.no_grad():
            bm = metrics_fn(pred, gt)
        return opt_state, loss, bm

    return step


def iterate_batches(dataset, batch_size: int, rng: np.random.Generator,
                    drop_last: bool = True):
    """Shuffled minibatches of stacked NHWC arrays (the reference's
    RandomSampler + default collate, train.py:183-189)."""
    order = rng.permutation(len(dataset))
    n_full = len(order) // batch_size
    end = n_full * batch_size if drop_last else len(order)
    for s in range(0, end, batch_size):
        idx = order[s:s + batch_size]
        items = [dataset[int(i)] for i in idx]
        img1 = np.stack([it[0] for it in items])
        img2 = np.stack([it[1] for it in items])
        gt = np.stack([it[2] for it in items])
        yield img1, img2, gt, [it[3] for it in items]


def train_one_epoch(model, opt_state, step_fn, dataset, args, epoch: int,
                    rng: np.random.Generator, log_writer=None,
                    print_freq: int = 20) -> Tuple:
    """ref engine.py:25-103: per-iteration cosine LR, metric logging,
    abort on a non-finite loss. Returns (opt_state, stats)."""
    dev = next(model.parameters()).device
    metric_logger = MetricLogger(delimiter="  ")
    metric_logger.add_meter("lr", SmoothedValue(window_size=1,
                                                fmt="{value:.6f}"))
    header = f"Epoch: [{epoch}]"

    if args.img_per_epoch:
        iter_per_epoch = -(-args.img_per_epoch // args.batch_size)
    else:
        iter_per_epoch = len(dataset) // args.batch_size

    batches = iterate_batches(dataset, args.batch_size, rng)
    for it, (img1, img2, gt, _names) in enumerate(
            metric_logger.log_every(batches, print_freq, header)):
        if it >= iter_per_epoch:
            break
        lr = lr_at(it / iter_per_epoch + epoch, args.lr, args.min_lr,
                   args.warmup_epochs, args.epochs)
        opt_state, loss, bm = step_fn(
            model, opt_state, *(torch.from_numpy(a).to(dev)
                                for a in (img1, img2, gt)), lr)
        loss_value = float(loss)
        if not np.isfinite(loss_value):
            raise FloatingPointError(
                f"Loss is {loss_value}, stopping training")
        metric_logger.update(loss=loss_value, lr=lr)
        bm = {k: float(v) for k, v in bm.items()}
        metric_logger.update(**bm)
        if log_writer is not None and (
                (it + 1) % args.tboard_log_step == 0
                or it == iter_per_epoch - 1):
            epoch_1000x = int((it / iter_per_epoch + epoch) * 1000)
            log_writer.add_scalar("train/loss", loss_value, epoch_1000x)
            log_writer.add_scalar("lr", lr, epoch_1000x)
            for k, v in bm.items():
                log_writer.add_scalar("train/" + k, v, epoch_1000x)

    print("Averaged stats:", metric_logger)
    stats = {k: meter.global_avg for k, meter in metric_logger.meters.items()}
    return opt_state, stats


def validate_one_epoch(model, cfg: DUSt3RConfig, criterion, task: str,
                       datasets, args, epoch: int, prec: Precision = BF16,
                       log_writer=None) -> Dict[str, float]:
    """ref engine.py:105-160: tiled prediction per val dataset, the Spring
    gt 4-phase averaged, loss and batch metrics per sample (on the host)."""
    model_fn = make_tile_fn(model, cfg, prec)
    metrics_fn = stereo_metrics if task == "stereo" else flow_metrics
    crop = tuple(args.crop)

    results = {}
    dnames = []
    bm_keys = []
    for dataset in datasets:
        dname = str(dataset)
        dnames.append(dname)
        ml = MetricLogger(delimiter="  ")
        for i in range(len(dataset)):
            img1, img2, gt, _name = dataset[i]
            img1, img2 = img1[None], img2[None]
            gt = gt[None]
            if dname.startswith("Spring"):
                assert gt.shape[1] == img1.shape[1] * 2
                gt = (gt[:, 0::2, 0::2] + gt[:, 0::2, 1::2]
                      + gt[:, 1::2, 0::2] + gt[:, 1::2, 1::2]) / 4.0
            pred, tiled_loss, c = tiled_pred(
                model_fn, criterion, img1, img2, gt,
                conf_mode=args.tile_conf_mode, overlap=args.val_overlap,
                crop=crop, with_conf=criterion.with_conf,
                tile_batch=getattr(args, "tile_batch", 8))
            pred_t, gt_t = torch.from_numpy(pred), torch.from_numpy(gt)
            bm = metrics_fn(pred_t, gt_t)
            loss = (criterion(pred_t, gt_t, torch.from_numpy(c))
                    if criterion.with_conf else criterion(pred_t, gt_t))
            ml.update(loss_tiled=tiled_loss, loss=float(loss))
            ml.update(**{f"{dname}_{k}": float(v) for k, v in bm.items()})
            bm_keys = list(bm.keys())
        results.update({k: meter.global_avg for k, meter in ml.meters.items()})

    if len(dnames) > 1:
        for k in bm_keys:
            results["AVG_" + k] = sum(
                results[f"{d}_{k}"] for d in dnames) / len(dnames)
    if log_writer is not None:
        epoch_1000x = int((1 + epoch) * 1000)
        for k, v in results.items():
            log_writer.add_scalar("val/" + k, v, epoch_1000x)
    print("Averaged stats:", results)
    return results
