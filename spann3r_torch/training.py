"""Training loop of the port (the JAX package's training.py, single process).

One train step: `forward_train` over a clip -> `conf_loss_t` + the scale
penalty -> gradients -> AdamW(0.9, 0.95) with decay on tensors of two or
more dimensions, a global-norm clip at 1.0, the per-iteration warmup and
half-cosine LR injected per step, and a non-finite gate that leaves the
step out on the device. Under BF16 the gradients are taken against a bf16
working copy of the fp32 master weights (the heads stay fp32) and the Adam
moments are stored in bf16, the JAX package's defaults for bf16 training
(SPANN3R_GRADS_BF16=0 and SPANN3R_ADAM_BF16=0 opt out).

Schedules kept from the reference:
  - per-iter LR: linear warmup then half-cosine to min_lr (misc.py:464-479)
  - frame-spacing curriculum: active_ratio ramps 0->1, decays to 0.5 after
    75% of training (training.py:191-196)
  - alpha coarse-to-fine: ConfLoss alpha 0.4 -> 0.2 linearly over the
    second half (training.py:410-412)
Checkpoints are `.pth` files in the reference's layout {model, optimizer,
scaler, args, epoch, best_so_far}: last, best and every keep_freq epochs,
with auto-resume from last. One process on one device: the JAX package's
tensor-parallel and FSDP layouts (--model_axis > 1, --fsdp 1) raise. Its
activation rematerialisation is here (--remat 1, --remat_scan 1;
`forward_train`), off by default: the card holds the activations.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from . import losses
from .config import (BF16, FP32, DUSt3RConfig, Precision, Spann3RConfig,
                     set_tf32_policy)
from .datasets import build_dataset, make_sampler
from .datasets.loader import DataLoader
from .models import spann3r as sp
from .utils.convert import (load_dust3r_checkpoint, load_spann3r_checkpoint,
                            read_checkpoint)

# Abort after this many CONSECUTIVE steps whose update the on-device
# non-finite-gradient gate suppressed while the loss stayed finite (see
# make_optimizer); otherwise such a run would freeze silently.
MAX_SUPPRESSED_STEPS = int(os.environ.get("SPANN3R_MAX_SUPPRESSED_STEPS", 25))

# multi-process training is ROADMAP queue A item 3
_MULTI_PROCESS = "multi-process training (DDP / FSDP2) is not ported yet: ROADMAP queue A item 3"


# ---------------------------------------------------------------------------
# args
# ---------------------------------------------------------------------------

def get_args_parser() -> argparse.ArgumentParser:
    """The flags of the JAX package's trainer (training.py:49-98), plus
    --device. --remat defaults to 0: the card holds the activations."""
    p = argparse.ArgumentParser("Spann3R training (PyTorch port)",
                                add_help=False)
    p.add_argument("--dust3r_ckpt", default=None,
                   help="path to DUSt3R .pth to warm-start from")
    p.add_argument("--pretrained", default=None,
                   help="path of a starting spann3r checkpoint (.pth)")
    p.add_argument("--resolution", default=224, type=int)
    p.add_argument("--num_frames", default=5, type=int)
    p.add_argument("--head_type", default="dpt", choices=["dpt", "linear"])
    p.add_argument("--train_criterion_alpha", default=0.4, type=float)
    p.add_argument("--train_dataset", default=None, type=str,
                   help="dataset-algebra expression (see datasets/__init__.py)")
    p.add_argument("--test_dataset", default=None, type=str)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--batch_size", default=2, type=int,
                   help="per-process batch size")
    p.add_argument("--batch_size_test", default=1, type=int)
    p.add_argument("--accum_iter", default=1, type=int)
    p.add_argument("--epochs", default=120, type=int)
    p.add_argument("--weight_decay", default=0.05, type=float)
    p.add_argument("--lr", default=5e-5, type=float)
    p.add_argument("--blr", default=1.5e-4, type=float)
    p.add_argument("--min_lr", default=1e-6, type=float)
    p.add_argument("--warmup_epochs", default=10, type=int)
    p.add_argument("--alpha_c2f", default=1, type=int)
    p.add_argument("--num_workers", default=2, type=int)
    p.add_argument("--eval_freq", default=1, type=int)
    p.add_argument("--save_freq", default=1, type=int)
    p.add_argument("--keep_freq", default=10, type=int)
    p.add_argument("--print_freq", default=20, type=int)
    p.add_argument("--output_dir", default="./output/train", type=str)
    p.add_argument("--model_axis", default=1, type=int,
                   help="tensor-parallel axis size (only 1: one process)")
    p.add_argument("--tp_min_dim", default=1024, type=int,
                   help="smallest weight last-dim sharded over 'model' "
                        "(unused at --model_axis 1)")
    p.add_argument("--fsdp", default=0, type=int,
                   help="shard weights and moments (only 0: one process)")
    p.add_argument("--bf16", default=1, type=int)
    p.add_argument("--remat", default=0, type=int,
                   help="recompute each encoder, decoder and value-encoder "
                        "block in the backward. Peak memory at 224, BF16, "
                        "full width on an H100 80GB: 20.2 GiB with 0, 16.6 "
                        "with 1 at B=2 x T=5; 39.4 and 24.2 GiB at B=4 x "
                        "T=10 (PERF.md section 5)")
    p.add_argument("--remat_scan", default=0, type=int,
                   help="also recompute the whole per-pair body in the "
                        "backward: 16.1 GiB at B=2 x T=5, 17.5 GiB at "
                        "B=4 x T=10 (same setting)")
    p.add_argument("--profile_dir", default=None, type=str,
                   help="write a torch.profiler trace of the first epoch")
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (the default; raises without a card) or cpu")
    return p


# ---------------------------------------------------------------------------
# schedules (ref croco/utils/misc.py:464-479, spann3r/training.py:191-196)
# ---------------------------------------------------------------------------

def lr_at(epoch_f: float, lr: float, min_lr: float, warmup_epochs: float,
          epochs: float) -> float:
    if epoch_f < warmup_epochs:
        return lr * epoch_f / max(warmup_epochs, 1e-8)
    t = (epoch_f - warmup_epochs) / max(epochs - warmup_epochs, 1e-8)
    return min_lr + (lr - min_lr) * 0.5 * (1.0 + math.cos(math.pi * t))


def active_ratio_at(epoch: int, epochs: int) -> float:
    r = epoch / epochs
    if r < 0.75:
        return min(1.0, r * 2.0)
    return max(0.5, 1.0 - (r - 0.75) / 0.25)


def alpha_at(epoch: int, epochs: int, alpha_init: float = 0.4,
             c2f: bool = True) -> float:
    if not c2f:
        return alpha_init
    return alpha_init - 0.2 * max((epoch - 0.5 * epochs) / (0.5 * epochs), 0.0)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

# the block stacks, whose parameters the JAX package stacks on a leading
# depth axis
_STACKED = ("dust3r.enc_blocks.", "dust3r.dec_blocks.", "dust3r.dec_blocks2.",
            "value_encoder.")


def decay_mask(name: str, shape) -> bool:
    """Whether weight decay applies to the parameter `name` of `shape`: the
    JAX package's rule, decay on leaves of 2 or more dimensions
    (training.py:127-130, after ref misc.py:420-426). JAX holds each block
    stack's parameters stacked on a leading depth axis, so its rule also
    decays the biases and LayerNorm parameters inside the block stacks (the
    reference does not); the port keeps JAX's behaviour (ROADMAP C)."""
    return len(shape) > 1 or name.startswith(_STACKED)


def global_norm_f32(tensors) -> torch.Tensor:
    """Global L2 norm with fp32 accumulation whatever the tensors' dtype (a
    bf16 sum of squares over ~700M gradients is too coarse for the clip).
    A device scalar: nothing is read to the host."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tensors))


class AdamState(NamedTuple):
    count: torch.Tensor                 # () int32: the applied steps
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Dict[str, torch.Tensor]], AdamState]
    update: Callable[..., Tuple[Dict[str, torch.Tensor], AdamState]]


def make_optimizer(weight_decay: float,
                   moment_dtype: Optional[torch.dtype] = None) -> Optimizer:
    """AdamW(0.9, 0.95), eps 1e-8, with a global-norm clip at 1.0 in fp32,
    bias correction and decoupled decay on tensors of 2 or more dimensions;
    the LR is applied by the step (JAX make_optimizer, training.py:243-319).

    update(grads, state, params) -> (updates, state): one pass per tensor
    (clip scale -> moments -> bias-corrected direction -> decay), the math
    in fp32 whatever the gradients' and moments' dtype, the update in the
    parameter's dtype. `moment_dtype` (bf16 for bf16 training) stores the
    moments. Non-finite gate: when the global gradient norm is inf or nan,
    every update is zero and the moments and the count stay as they were,
    decided on the device with no host read."""
    b1, b2, eps, max_norm = 0.9, 0.95, 1e-8, 1.0

    def init(params: Dict[str, torch.Tensor]) -> AdamState:
        zeros = {n: torch.zeros_like(p, dtype=moment_dtype or p.dtype)
                 for n, p in params.items()}
        dev = next(iter(params.values())).device
        return AdamState(torch.zeros((), dtype=torch.int32, device=dev),
                         zeros, {n: z.clone() for n, z in zeros.items()})

    @torch.no_grad()
    def update(grads: Dict[str, torch.Tensor], state: AdamState,
               params: Dict[str, torch.Tensor]):
        gnorm = global_norm_f32(grads.values())
        finite = torch.isfinite(gnorm)
        # clip_by_global_norm semantics: scale only when gnorm >= max_norm
        scale = torch.where(gnorm < max_norm, torch.ones_like(gnorm),
                            max_norm / gnorm)
        count = state.count + finite.to(state.count.dtype)
        cf = count.float()
        bc1, bc2 = 1.0 - b1 ** cf, 1.0 - b2 ** cf
        updates, mu, nu = {}, {}, {}
        for name, g in grads.items():
            p, m, v = params[name], state.mu[name], state.nu[name]
            gf = g.float() * scale
            mf, vf = m.float(), v.float()
            m2 = b1 * mf + (1.0 - b1) * gf
            v2 = b2 * vf + (1.0 - b2) * torch.square(gf)
            u = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
            if decay_mask(name, p.shape):
                u = u + weight_decay * p.float()
            updates[name] = torch.where(finite, u, torch.zeros_like(u)).to(p.dtype)
            mu[name] = torch.where(finite, m2, mf).to(m.dtype)
            nu[name] = torch.where(finite, v2, vf).to(v.dtype)
        return updates, AdamState(count, mu, nu)

    return Optimizer(init, update)


@torch.no_grad()
def apply_updates_(params: Dict[str, torch.Tensor],
                   updates: Dict[str, torch.Tensor], lr: float) -> None:
    """params += -lr * update, in place (the LR injected per step)."""
    for name, p in params.items():
        p.add_(updates[name] * (-lr))


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def _is_head(name: str) -> bool:
    return name.startswith(("dust3r.downstream_head1.",
                            "dust3r.downstream_head2."))


def work_params(model: nn.Module, prec: Precision) -> Dict[str, torch.Tensor]:
    """The tensors to differentiate against: under a bf16 compute dtype a
    bf16 working copy of the fp32 master weights, the pointmap heads kept
    fp32 (they compute in prec.head_dtype), each a new leaf; otherwise the
    parameters themselves (JAX work_params, training.py:200-234). The
    gradients then come in the working copy's dtype."""
    params = dict(model.named_parameters())
    if prec.compute_dtype != torch.bfloat16:
        return params
    return {n: (p if _is_head(n) or p.dtype != torch.float32
                else p.detach().to(torch.bfloat16).requires_grad_(True))
            for n, p in params.items()}


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A collated batch's arrays, (T, B, ...), as tensors on `device`."""
    out = {}
    for k in ("img", "pts3d", "valid_mask", "camera_pose"):
        a = batch[k]
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(a))
        out[k] = t.to(device, non_blocking=True)
    out["valid_mask"] = out["valid_mask"].bool()
    return out


class _TrainLoss(nn.Module):
    """The loss of one batch and its gradients as a module, so that
    `functional_call` runs it on the working copy of the weights. The
    backward runs inside the call too: a rematerialised block recomputes
    its forward there, and must read the working copy again, not the
    parameters the call swaps back in when it returns."""

    def __init__(self, model: nn.Module, cfg: Spann3RConfig, prec: Precision,
                 fix_first: bool, remat: bool, remat_scan: Optional[bool]):
        super().__init__()
        self.model = model
        self.cfg, self.prec, self.fix_first = cfg, prec, fix_first
        self.remat, self.remat_scan = remat, remat_scan

    def forward(self, batch, generator, alpha, wrt):
        frames = batch["img"].transpose(0, 1)            # (B,T,H,W,3)
        preds = sp.forward_train(self.model, frames, self.cfg, self.prec,
                                 generator=generator, remat=self.remat,
                                 remat_scan=self.remat_scan)
        gts = {k: batch[k] for k in ("pts3d", "valid_mask", "camera_pose")}
        loss, details, factor_loss = losses.conf_loss_t(
            gts, preds, alpha=alpha, norm_mode=True, fix_first=self.fix_first)
        loss = loss + factor_loss  # (ref training.py:217-218)
        return loss, details, torch.autograd.grad(loss, wrt, allow_unused=True)


def _grads_bf16_default() -> bool:
    return os.environ.get("SPANN3R_GRADS_BF16", "0") == "1"


def value_and_grad(model: nn.Module, cfg: Spann3RConfig, prec: Precision,
                   batch: Dict[str, torch.Tensor], generator, alpha: float,
                   fix_first: bool = False, grads_bf16: bool = False,
                   remat: bool = False, remat_scan: Optional[bool] = None):
    """(loss, details, {name: grad}) of one batch (tensors on the model's
    device, `batch_to_device`): conf_loss_t + the scale penalty of
    `forward_train` (with its `remat` and `remat_scan`), differentiated
    against the bf16 working copy under grads_bf16, else against the
    parameters. Nothing is read to the host."""
    loss_mod = _TrainLoss(model, cfg, prec, fix_first, remat, remat_scan)
    wp = work_params(model, prec) if grads_bf16 else dict(
        model.named_parameters())
    with torch.enable_grad():
        loss, details, grads = torch.func.functional_call(
            loss_mod, {f"model.{n}": t for n, t in wp.items()},
            (batch, generator, alpha, list(wp.values())), tie_weights=False)
    # a weight the loss never reads (the first DPT refinenet's unit for a
    # skip input it does not have) gets a zero gradient, as under jax.grad
    grads = {n: torch.zeros_like(t) if g is None else g
             for (n, t), g in zip(wp.items(), grads)}
    return loss.detach(), {k: v.detach() for k, v in details.items()}, grads


def make_train_step(cfg: Spann3RConfig, prec: Precision, opt: Optimizer,
                    fix_first: bool = False,
                    grads_bf16: Optional[bool] = None, remat: bool = False,
                    remat_scan: Optional[bool] = None):
    """train_step(model, opt_state, batch, generator, lr, alpha) ->
    (opt_state, metrics): one optimizer step on `batch` (collated (T, B, ...)
    arrays or tensors), the model's parameters updated in place; `metrics`
    holds the loss, the grad norm and the loss details as device scalars.
    `generator` draws the memory dropout (None: off). `grads_bf16` (default:
    SPANN3R_GRADS_BF16) differentiates against the bf16 working copy
    (`work_params`). `remat` and `remat_scan` are `forward_train`'s."""
    if grads_bf16 is None:
        grads_bf16 = _grads_bf16_default()

    def train_step(model, opt_state, batch, generator, lr, alpha):
        params = dict(model.named_parameters())
        batch = batch_to_device(batch, next(model.parameters()).device)
        loss, details, grads = value_and_grad(model, cfg, prec, batch,
                                              generator, alpha, fix_first,
                                              grads_bf16, remat, remat_scan)
        gnorm = global_norm_f32(grads.values())
        updates, opt_state = opt.update(grads, opt_state, params)
        apply_updates_(params, updates, lr)
        return opt_state, dict(details, loss=loss, grad_norm=gnorm)

    return train_step


def make_accum_train_step(cfg: Spann3RConfig, prec: Precision, opt: Optimizer,
                          accum_iter: int, fix_first: bool = False,
                          grads_bf16: Optional[bool] = None,
                          remat: bool = False,
                          remat_scan: Optional[bool] = None):
    """Gradient accumulation (ref training.py:226-231 accum_iter). Returns
    (train_step, None, None) for accum_iter <= 1, else (None, grad_step,
    apply_step): grad_step(model, grad_acc, batch, generator, alpha) ->
    (grad_acc, metrics) adds the batch's gradients / accum_iter to the fp32
    accumulator, or nothing when their norm is not finite;
    apply_step(model, opt_state, grad_acc, lr) -> (opt_state, zeroed
    grad_acc, grad norm) runs the optimizer. `remat` and `remat_scan` are
    `forward_train`'s."""
    if grads_bf16 is None:
        grads_bf16 = _grads_bf16_default()
    if accum_iter <= 1:
        return make_train_step(cfg, prec, opt, fix_first, grads_bf16, remat,
                               remat_scan), None, None

    def grad_step(model, grad_acc, batch, generator, alpha):
        batch = batch_to_device(batch, next(model.parameters()).device)
        loss, details, grads = value_and_grad(model, cfg, prec, batch,
                                              generator, alpha, fix_first,
                                              grads_bf16, remat, remat_scan)
        ok = torch.isfinite(global_norm_f32(grads.values()))
        with torch.no_grad():
            grad_acc = {n: a + torch.where(ok, grads[n].to(a.dtype),
                                           torch.zeros_like(a)) / accum_iter
                        for n, a in grad_acc.items()}
        return grad_acc, dict(details, loss=loss)

    def apply_step(model, opt_state, grad_acc, lr):
        params = dict(model.named_parameters())
        gnorm = global_norm_f32(grad_acc.values())
        updates, opt_state = opt.update(grad_acc, opt_state, params)
        apply_updates_(params, updates, lr)
        return opt_state, zero_grads(model), gnorm

    return None, grad_step, apply_step


def zero_grads(model: nn.Module) -> Dict[str, torch.Tensor]:
    """An fp32 gradient accumulator of zeros, one per parameter."""
    return {n: torch.zeros_like(p) for n, p in model.named_parameters()}


def make_eval_step(cfg: Spann3RConfig, prec: Precision, alpha: float = 0.4):
    """eval_step(model, batch) -> (loss, details, preds): the training
    forward without dropout and the criterion, no gradients."""
    @torch.no_grad()
    def eval_step(model, batch):
        batch = batch_to_device(batch, next(model.parameters()).device)
        frames = batch["img"].transpose(0, 1)
        preds = sp.forward_train(model, frames, cfg, prec, generator=None)
        gts = {k: batch[k] for k in ("pts3d", "valid_mask", "camera_pose")}
        loss, details, _ = losses.conf_loss_t(gts, preds, alpha=alpha,
                                              norm_mode=True)
        return loss, details, preds

    return eval_step


# ---------------------------------------------------------------------------
# checkpoints (.pth in the reference's layout)
# ---------------------------------------------------------------------------

class CheckpointManager:
    """last/best/periodic checkpoints + auto-resume (ref training.py:377-405,
    croco misc.save_model/load_model): output_dir/checkpoint-{name}.pth
    holding {model, optimizer, scaler, args, epoch, best_so_far}; the
    optimizer entry is {count, mu, nu}, the scaler None (no loss scaling)."""

    def __init__(self, output_dir: str):
        self.dir = os.path.abspath(output_dir)
        os.makedirs(self.dir, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.dir, f"checkpoint-{name}.pth")

    def save(self, name: str, model: nn.Module, opt_state: AdamState,
             epoch: int, best: float, args) -> None:
        state = {"model": model.state_dict(),
                 "optimizer": {"count": opt_state.count, "mu": opt_state.mu,
                               "nu": opt_state.nu},
                 "scaler": None, "args": args, "epoch": epoch,
                 "best_so_far": best}
        tmp = self.path(name) + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, self.path(name))

    def restore(self, name: str) -> Optional[Dict[str, Any]]:
        path = self.path(name)
        return read_checkpoint(path) if os.path.exists(path) else None


def _opt_state_to(ckpt_opt: Dict[str, Any], device) -> AdamState:
    return AdamState(ckpt_opt["count"].to(device),
                     {n: t.to(device) for n, t in ckpt_opt["mu"].items()},
                     {n: t.to(device) for n, t in ckpt_opt["nu"].items()})


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: no CUDA device is available; pass "
                           "--device cpu to train on the CPU")
    return dev


def precision_flag(name: str, bf16) -> bool:
    """SPANN3R_ADAM_BF16 or SPANN3R_GRADS_BF16 as `train` reads it: "1" on,
    any other value off, unset the bf16 training default (on under
    --bf16 1)."""
    v = os.environ.get(name)
    return bool(bf16) if v is None else v == "1"


def train(args, model_cfg: Optional[Spann3RConfig] = None) -> Dict[str, Any]:
    """Run the training recipe in one process. `model_cfg` overrides the
    model architecture (the CLI trains the published ViT-L configuration
    built from --resolution/--head_type); tests inject tiny ones."""
    if args.model_axis > 1 or args.fsdp:
        raise NotImplementedError(f"--model_axis {args.model_axis} --fsdp "
                                  f"{args.fsdp}: {_MULTI_PROCESS}")
    device = _device(args.device)
    set_tf32_policy()
    os.makedirs(args.output_dir, exist_ok=True)

    prec = BF16 if args.bf16 else FP32
    cfg = model_cfg if model_cfg is not None else Spann3RConfig(
        dust3r=DUSt3RConfig(img_size=(args.resolution, args.resolution),
                            head_type=args.head_type))
    print(f"device: {device}; one process")

    train_ds = build_dataset(args.train_dataset)
    test_dss = {}
    if args.test_dataset:
        for expr in args.test_dataset.split("+"):
            test_dss[expr.strip().split("(")[0]] = build_dataset(expr)
    sampler = make_sampler(train_ds, args.batch_size)
    loader = DataLoader(train_ds, args.batch_size, sampler=sampler,
                        num_workers=args.num_workers)

    model = sp.build_spann3r(cfg, device,
                             torch.Generator().manual_seed(args.seed))
    if args.dust3r_ckpt:
        load_dust3r_checkpoint(args.dust3r_ckpt, model.dust3r)
        # the pointmap patch-embed starts as a copy of the image patch-embed
        # (ref spann3r/model.py:240-242)
        if hasattr(model, "pos_patch_embed"):
            model.pos_patch_embed.load_state_dict(
                model.dust3r.patch_embed.state_dict())

    adam_bf16 = precision_flag("SPANN3R_ADAM_BF16", args.bf16)
    grads_bf16 = precision_flag("SPANN3R_GRADS_BF16", args.bf16)
    opt = make_optimizer(args.weight_decay,
                         moment_dtype=torch.bfloat16 if adam_bf16 else None)

    if args.pretrained:
        if not args.pretrained.endswith(".pth"):
            raise FileNotFoundError(f"--pretrained {args.pretrained}: "
                                    f"expected a .pth file")
        # warm start = weights only; the optimizer starts fresh
        load_spann3r_checkpoint(args.pretrained, model)
        print(f"warm-started weights from {args.pretrained}")
    opt_state = opt.init(dict(model.named_parameters()))

    ckpt = CheckpointManager(args.output_dir)
    start_epoch, best_so_far = 0, float("inf")
    restored = ckpt.restore("last")
    if restored is not None:
        model.load_state_dict(restored["model"])
        opt_state = _opt_state_to(restored["optimizer"], device)
        start_epoch = int(restored["epoch"]) + 1
        best_so_far = float(restored["best_so_far"])
        print(f"auto-resumed from epoch {start_epoch}")

    eff_batch = args.batch_size * args.accum_iter
    if args.lr is None:
        args.lr = args.blr * eff_batch / 256

    train_step, grad_step, apply_step = make_accum_train_step(
        cfg, prec, opt, args.accum_iter, grads_bf16=grads_bf16,
        remat=bool(args.remat), remat_scan=bool(args.remat_scan) or None)
    eval_step = make_eval_step(cfg, prec)
    grad_acc = zero_grads(model) if args.accum_iter > 1 else None

    snapshot_sources(args.output_dir)
    writer = None
    try:
        from torch.utils.tensorboard import SummaryWriter
        writer = SummaryWriter(log_dir=args.output_dir)
    except ImportError:
        pass

    log_path = os.path.join(args.output_dir, "log.txt")
    generator = torch.Generator(device).manual_seed(args.seed)
    steps_per_epoch = max(len(loader), 1)
    t0 = time.time()
    last_loss = float("nan")
    # Streak of consecutive on-device-suppressed updates (non-finite grads
    # while the loss stays finite): the lagged loss check alone would never
    # fire then, so abort after a bounded streak.
    suppressed_streak = {"n": 0}
    for epoch in range(start_epoch, args.epochs + 1):
        # ---- eval + checkpointing cadence (ref training.py:377-405) ----
        test_stats = {}
        if epoch > 0 and args.eval_freq > 0 and epoch % args.eval_freq == 0:
            for name, tds in test_dss.items():
                test_stats[name] = test_one_epoch(
                    eval_step, model, tds, args.batch_size_test,
                    output_dir=args.output_dir, epoch=epoch)
                med = test_stats[name].get("loss_med", float("inf"))
                if med < best_so_far:
                    best_so_far = med
                    ckpt.save("best", model, opt_state, epoch - 1,
                              best_so_far, args)
        if epoch > start_epoch:
            if args.save_freq and (epoch % args.save_freq == 0
                                   or epoch == args.epochs):
                ckpt.save("last", model, opt_state, epoch - 1, best_so_far,
                          args)
            if args.keep_freq and epoch % args.keep_freq == 0:
                ckpt.save(str(epoch), model, opt_state, epoch - 1,
                          best_so_far, args)

        stats = {f"test_{k}_{k2}": float(v2) for k, v in test_stats.items()
                 for k2, v2 in v.items()}
        with open(log_path, "a") as f:
            f.write(json.dumps(dict(epoch=epoch, **stats)) + "\n")

        if epoch >= args.epochs:
            break

        # ---- curriculum ----
        alpha = alpha_at(epoch, args.epochs, args.train_criterion_alpha,
                         bool(args.alpha_c2f))
        active_ratio = active_ratio_at(epoch, args.epochs)
        train_ds.set_epoch(epoch)
        train_ds.set_ratio(active_ratio)
        sampler.set_epoch(epoch)

        # ---- one epoch ----
        from .utils.metrics import MetricLogger
        logger = MetricLogger()
        prof = None
        if args.profile_dir and epoch == start_epoch:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()

        # Lagged finiteness check (ref training.py:222-224 checks every
        # iteration): the optimizer suppresses non-finite updates on the
        # device (make_optimizer), and the host reads the PREVIOUS step's
        # loss after enqueueing the current one, so steps dispatch back to
        # back and a poisoned update never reaches the weights.
        pending = None  # (iteration, loss, grad_norm) of the prior step

        def check_pending(p):
            it_prev, dev_loss, dev_gnorm = p
            loss_f = float(dev_loss)
            if not math.isfinite(loss_f):
                raise RuntimeError(
                    f"non-finite loss {loss_f} at epoch {epoch} it {it_prev} "
                    "(update suppressed on device; detected one step late — "
                    "one additional finite step may have applied after it)")
            if not math.isfinite(float(dev_gnorm)):
                suppressed_streak["n"] += 1
                if suppressed_streak["n"] >= MAX_SUPPRESSED_STEPS:
                    raise RuntimeError(
                        f"{suppressed_streak['n']} consecutive non-finite-"
                        f"gradient steps (loss finite, last {loss_f}) up to "
                        f"epoch {epoch} it {it_prev}: every update was "
                        "suppressed by the on-device gate; aborting instead "
                        "of training in place")
            else:
                suppressed_streak["n"] = 0
            return loss_f

        for it, batch in enumerate(loader):
            epoch_f = epoch + it / steps_per_epoch
            lr = lr_at(epoch_f, args.lr, args.min_lr, args.warmup_epochs,
                       args.epochs)
            if args.accum_iter > 1:
                grad_acc, metrics = grad_step(model, grad_acc, batch,
                                              generator, alpha)
                metrics = dict(metrics, grad_norm=0.0)
                if (it + 1) % args.accum_iter == 0:
                    opt_state, grad_acc, gnorm = apply_step(
                        model, opt_state, grad_acc, lr)
                    metrics["grad_norm"] = gnorm
            else:
                opt_state, metrics = train_step(model, opt_state, batch,
                                                generator, lr, alpha)

            if pending is not None:
                last_loss = check_pending(pending)
            pending = (it, metrics["loss"], metrics["grad_norm"])

            if it % args.print_freq == 0:
                m = {k: float(v) for k, v in metrics.items()}
                logger.update(loss=m["loss"], grad_norm=m["grad_norm"], lr=lr)
                print(f"E{epoch} it{it}/{steps_per_epoch} "
                      f"loss={m['loss']:.4f} lr={lr:.2e} "
                      f"gnorm={m['grad_norm']:.2f} ar={active_ratio:.2f} "
                      f"alpha={alpha:.2f}")
                if writer is not None:
                    step1000 = int(epoch_f * 1000)
                    writer.add_scalar("train_loss", m["loss"], step1000)
                    writer.add_scalar("train_lr", lr, step1000)
                    writer.add_scalar("active_ratio", active_ratio, step1000)

        if pending is not None:
            last_loss = check_pending(pending)
        if prof is not None:
            prof.stop()
            os.makedirs(args.profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(args.profile_dir,
                                                  "trace.json"))
        logger.synchronize_between_processes()
        print(f"E{epoch} averaged stats: {logger}")
        if logger.meters["loss"].count > 0:
            # per-epoch train summary (ref croco/utils/misc.py log_stats)
            with open(log_path, "a") as f:
                f.write(json.dumps({
                    "epoch": epoch,
                    "train_loss": logger.meters["loss"].global_avg,
                    "train_lr": logger.meters["lr"].global_avg,
                    "alpha": alpha, "active_ratio": active_ratio}) + "\n")

    if writer is not None:
        writer.close()
    print(f"Training done in {time.time() - t0:.0f}s")
    return {"model": model, "opt_state": opt_state, "best": best_so_far,
            "last_loss": last_loss}


def snapshot_sources(output_dir: str) -> None:
    """Copy the package into output/recording/ so every run records the
    code it trained with (ref spann3r/training.py:360-371)."""
    import shutil
    rec = os.path.join(output_dir, "recording")
    pkg_root = os.path.dirname(os.path.abspath(__file__))
    dst_pkg = os.path.join(rec, "spann3r_torch")
    if os.path.exists(dst_pkg):
        shutil.rmtree(dst_pkg)
    shutil.copytree(pkg_root, dst_pkg,
                    ignore=shutil.ignore_patterns("__pycache__", "*.so",
                                                  "*.pyc", "_build"))


def _dump_eval_plys(out_dir: str, epoch: int, batch, preds, start_idx: int,
                    max_ply: int) -> int:
    """Write per-sequence predicted pointmaps as colored PLYs (ref
    spann3r/training.py:126-149). Returns how many were written."""
    from .utils.export import write_ply
    # target-frame predictions cover frames 1..T-1 in frame-0 coords
    pts = preds["pts3d_2"].float().cpu().numpy()      # (T-1,B,H,W,3)
    conf = preds["conf_2"].float().cpu().numpy()      # (T-1,B,H,W)
    imgs = np.asarray(batch["img"], np.float32)[1:]   # (T-1,B,H,W,3)
    written = 0
    for j in range(pts.shape[1]):
        idx = start_idx + j
        if idx >= max_ply:
            break
        keep = (conf[:, j] > 1.001).reshape(-1)
        p = pts[:, j].reshape(-1, 3)[keep]
        c = (imgs[:, j].reshape(-1, 3)[keep] + 1.0) / 2.0
        write_ply(os.path.join(out_dir, f"epoch{epoch:03d}_{idx:03d}.ply"),
                  p, c)
        written += 1
    return written


def _merge_eval_stats(losses_all, detail_sums) -> Dict[str, float]:
    """The eval statistics of the one process: mean and median loss, the
    details' means (JAX _merge_eval_stats at a world of one)."""
    if not losses_all:
        return {}
    stats = {"loss_avg": float(np.mean(losses_all)),
             "loss_med": float(np.median(losses_all))}
    n = max(len(losses_all), 1)
    stats.update({k: v / n for k, v in detail_sums.items()})
    return stats


def test_one_epoch(eval_step, model, dataset, batch_size: int,
                   output_dir: Optional[str] = None, epoch: int = 0,
                   max_ply: int = 10) -> Dict[str, float]:
    """Seeded held-out eval: mean and median loss and the per-detail means;
    optionally dumps the first `max_ply` reconstructions as PLYs (ref
    training.py:94-168)."""
    if hasattr(dataset, "set_epoch"):
        dataset.set_epoch(epoch)
    loader = DataLoader(dataset, batch_size, sampler=list(range(len(dataset))),
                        num_workers=1)
    losses_all = []
    detail_sums: Dict[str, float] = {}
    ply_dir = None
    if output_dir is not None and max_ply > 0:
        ply_dir = os.path.join(output_dir, "eval_ply")
        os.makedirs(ply_dir, exist_ok=True)
    n_ply = 0
    for batch in loader:
        loss, details, preds = eval_step(model, batch)
        losses_all.append(float(loss))
        for k, v in details.items():
            detail_sums[k] = detail_sums.get(k, 0.0) + float(v)
        if ply_dir is not None and n_ply < max_ply:
            n_ply += _dump_eval_plys(ply_dir, epoch, batch, preds, n_ply,
                                     max_ply)
    return _merge_eval_stats(losses_all, detail_sums)
