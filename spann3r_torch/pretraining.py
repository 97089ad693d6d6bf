"""CroCo masked cross-view pretraining (the JAX package's pretraining.py,
after the reference's croco/pretrain.py:37-254).

One step: `croco_forward` (exact-count masks) -> MaskedMSE -> gradients ->
AdamW(0.9, 0.95) with decay on the JAX package's tensors (`decay_mask`:
two or more dimensions, and everything inside the block stacks, which JAX
stacks on a depth axis), no clip (the reference's NativeScaler is called
without clip_grad, croco/pretrain.py:225-227), the optional layer-decay LR
scales, and a non-finite gate decided on the device: when the gradient norm
is inf or nan the update is zero and the moments stay. The LR is the
reference's per-iteration warmup and half-cosine (cosine horizon --epochs,
training stopped at --max_epoch). --amp 1 computes the transformer in bf16
against the fp32 weights.

One process, or several under torchrun (`parallel/mesh.py`): each rank
reads its strided share of the pairs (`PairLoader`, the same number of
batches on every rank), the gradients are summed over the ranks and
divided by their number, which is the gradient of the loss over the global
batch since every rank masks the same count of tokens on the same batch
size. Checkpoints are `.pth` files in the reference's layout (the port's
`CheckpointManager`): last every --save_freq epochs, one per --keep_freq
epochs, auto-resume from last.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from .config import BF16, FP32, DUSt3RConfig, Precision, set_tf32_policy
from .datasets.pairs import PairsDataset
from .models import croco_pretrain as cp
from .parallel.mesh import all_reduce_flat, init_distributed
from .training import (CheckpointManager, Optimizer, _opt_state_to,
                       apply_updates_, global_norm_f32, layer_lr_scales,
                       lr_at, make_optimizer)

# the block stacks, whose parameters the JAX package stacks on a leading
# depth axis (so its decay rule decays them all)
_STACKED = ("enc_blocks.", "dec_blocks.")


def get_args_parser() -> argparse.ArgumentParser:
    """The JAX package's flags (ref croco/pretrain.py:37-70), plus
    --device."""
    p = argparse.ArgumentParser("CroCo pre-training", add_help=False)
    p.add_argument("--model", default="CroCoNet()", type=str,
                   help="model string, e.g. CroCoNet(enc_embed_dim=1024)")
    p.add_argument("--norm_pix_loss", default=1, type=int, choices=[0, 1])
    p.add_argument("--dataset", default="habitat_release", type=str)
    p.add_argument("--transforms", default="crop224+acolor", type=str)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--batch_size", default=64, type=int)
    p.add_argument("--epochs", default=800, type=int,
                   help="cosine-schedule horizon")
    p.add_argument("--max_epoch", default=400, type=int,
                   help="stop training at this epoch")
    p.add_argument("--accum_iter", default=1, type=int)
    p.add_argument("--weight_decay", default=0.05, type=float)
    p.add_argument("--layer_decay", default=1.0, type=float,
                   help="per-layer LR decay (croco/utils/misc.py:404-460; "
                        "1.0 = off, the reference pretrain default)")
    p.add_argument("--lr", default=None, type=float)
    p.add_argument("--blr", default=1.5e-4, type=float)
    p.add_argument("--min_lr", default=0.0, type=float)
    p.add_argument("--warmup_epochs", default=40, type=int)
    p.add_argument("--amp", default=1, type=int, choices=[0, 1],
                   help="bf16 compute (AMP analogue)")
    p.add_argument("--num_workers", default=2, type=int)
    p.add_argument("--save_freq", default=1, type=int)
    p.add_argument("--keep_freq", default=20, type=int)
    p.add_argument("--print_freq", default=20, type=int)
    p.add_argument("--output_dir", default="./output/", type=str)
    p.add_argument("--data_dir", default="./data/", type=str)
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (the default; raises without a card) or cpu")
    return p


def decay_mask(name: str, shape) -> bool:
    """The JAX package's decay rule on CroCo's parameters: leaves of two or
    more dimensions, and every parameter of the block stacks."""
    return len(shape) > 1 or name.startswith(_STACKED)


def make_pretrain_optimizer(weight_decay: float) -> Optimizer:
    """AdamW(0.9, 0.95), eps 1e-8, no gradient clip, decay by `decay_mask`;
    the LR is applied by the step."""
    return make_optimizer(weight_decay, max_norm=None, decay=decay_mask)


def pretrain_loss_and_grads(model, img1: torch.Tensor, img2: torch.Tensor,
                            mask: torch.Tensor, mask_ratio: float,
                            prec: Precision, norm_pix_loss: bool = True,
                            group=None, world: int = 1):
    """(loss, {name: grad}) of MaskedMSE on one batch against the fp32
    parameters, as device tensors; over `world` ranks the loss and the
    gradients of the global batch (each rank's mean). The mask is taken
    unchecked, as the JAX package's jitted step takes it: `croco_forward`'s
    check reads the row counts back to the host, which would make every
    step wait for the one before, and `random_mask` draws exact counts."""
    params = dict(model.named_parameters())
    with torch.enable_grad():
        pred, mask, target = cp.croco_forward(model, img1, img2, mask,
                                              mask_ratio, prec,
                                              check_mask=False)
        loss = cp.masked_mse(pred, mask, target, norm_pix_loss=norm_pix_loss)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
    loss = loss.detach()
    if world > 1:
        grads = all_reduce_flat(grads, group)
        torch._foreach_div_(list(grads.values()), world)
        dist.all_reduce(loss, group=group)
        loss /= world
    return loss, grads


def make_pretrain_step(mask_ratio: float, prec: Precision, opt: Optimizer,
                       norm_pix_loss: bool = True,
                       lr_scales: Optional[Dict[str, float]] = None,
                       group=None, world: int = 1):
    """(step, grad_step, apply_step), the JAX package's make_pretrain_step
    with the mask drawn by the caller (`random_mask`):
      step(model, opt_state, img1, img2, mask, lr) -> (opt_state, loss)
      grad_step(model, grad_acc, img1, img2, mask, inv_accum)
          -> (grad_acc, loss): adds the gradients times inv_accum to the
          fp32 accumulator, or nothing when their norm is not finite
      apply_step(model, opt_state, grad_acc, lr) -> (opt_state, zeroed acc)
    The model's parameters are updated in place; the loss stays on the
    device. Over `world` ranks of `group` the batch is this rank's part, the
    loss and the gradients those of the global batch."""

    def loss_and_grads(model, img1, img2, mask):
        return pretrain_loss_and_grads(model, img1, img2, mask, mask_ratio,
                                       prec, norm_pix_loss, group, world)

    def update(model, opt_state, grads, lr):
        params = dict(model.named_parameters())
        updates, opt_state = opt.update(grads, opt_state, params)
        if lr_scales is None:
            apply_updates_(params, updates, lr)
        else:
            with torch.no_grad():
                for n, p in params.items():
                    p.add_(updates[n] * (-lr * lr_scales[n]))
        return opt_state

    def step(model, opt_state, img1, img2, mask, lr):
        loss, grads = loss_and_grads(model, img1, img2, mask)
        return update(model, opt_state, grads, lr), loss

    def grad_step(model, grad_acc, img1, img2, mask, inv_accum):
        loss, grads = loss_and_grads(model, img1, img2, mask)
        ok = torch.isfinite(global_norm_f32(grads.values()))
        with torch.no_grad():
            grad_acc = {n: a + torch.where(ok, grads[n].float(),
                                           torch.zeros_like(a)) * inv_accum
                        for n, a in grad_acc.items()}
        return grad_acc, loss

    def apply_step(model, opt_state, grad_acc, lr):
        opt_state = update(model, opt_state, grad_acc, lr)
        return opt_state, {n: torch.zeros_like(a) for n, a in grad_acc.items()}

    return step, grad_step, apply_step


class PairLoader:
    """Shuffled, rank-strided, drop-last batches of a PairsDataset (the
    reference's DistributedSampler + DataLoader, croco/pretrain.py:133-149):
    every rank yields exactly len(self) batches, so no rank enters a step's
    collectives that its peers never join."""

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 world: int = 1, rank: int = 0):
        self.ds = dataset
        self.bs = batch_size
        self.seed = seed
        self.world = world
        self.rank = rank
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.ds) // (self.bs * self.world)

    def __iter__(self):
        order = np.random.default_rng(self.seed + self.epoch).permutation(
            len(self.ds))
        order = order[self.rank::self.world][:len(self) * self.bs]
        for s in range(0, len(order) - self.bs + 1, self.bs):
            items = [self.ds[int(i)] for i in order[s:s + self.bs]]
            yield (np.stack([a for a, _ in items]),
                   np.stack([b for _, b in items]))


def num_patches(cfg: DUSt3RConfig) -> int:
    return ((cfg.img_size[0] // cfg.patch_size)
            * (cfg.img_size[1] // cfg.patch_size))


def main(args) -> Dict[str, float]:
    """Run the pretraining recipe in this process (one rank of torchrun's
    group where its environment says so). Returns the model, the optimizer
    state and the last epoch's mean loss."""
    set_tf32_policy()
    was_joined = dist.is_available() and dist.is_initialized()
    dev = init_distributed(args.device)
    joined = dist.is_available() and dist.is_initialized()
    rank = dist.get_rank() if joined else 0
    world = dist.get_world_size() if joined else 1
    os.makedirs(args.output_dir, exist_ok=True)

    cfg, mask_ratio = cp.parse_croco_model(args.model)
    prec = BF16 if args.amp else FP32
    dataset = PairsDataset(args.dataset, trfs=args.transforms,
                           data_dir=args.data_dir, seed=args.seed + rank)
    loader = PairLoader(dataset, args.batch_size, seed=args.seed,
                        world=world, rank=rank)
    eff_batch = args.batch_size * args.accum_iter * world
    if args.lr is None:
        args.lr = args.blr * eff_batch / 256

    model = cp.build_croco(cfg, dev, torch.Generator().manual_seed(args.seed))
    opt = make_pretrain_optimizer(args.weight_decay)
    opt_state = opt.init(dict(model.named_parameters()))
    lr_scales = None
    if args.layer_decay < 1.0:
        lr_scales = layer_lr_scales([n for n, _ in model.named_parameters()],
                                    cfg.enc.depth, cfg.dec.depth,
                                    args.layer_decay)
    step, grad_step, apply_step = make_pretrain_step(
        mask_ratio, prec, opt, norm_pix_loss=bool(args.norm_pix_loss),
        lr_scales=lr_scales, group=dist.group.WORLD if joined else None,
        world=world)
    grad_acc = ({n: torch.zeros_like(p) for n, p in model.named_parameters()}
                if args.accum_iter > 1 else None)

    ckpt = CheckpointManager(args.output_dir)
    start_epoch = 0
    restored = ckpt.restore("last")
    if restored is not None:
        model.load_state_dict(restored["model"], strict=True)
        opt_state = _opt_state_to(restored["optimizer"], dev)
        start_epoch = int(restored["epoch"]) + 1
        print(f"auto-resumed from epoch {start_epoch}")

    writer = None
    if rank == 0:
        try:
            from torch.utils.tensorboard import SummaryWriter
            writer = SummaryWriter(log_dir=args.output_dir)
        except ImportError:
            pass
    log_path = os.path.join(args.output_dir, "log.txt")
    gen = torch.Generator(device=dev).manual_seed(args.seed + rank)
    n_patches = num_patches(cfg)
    print(f"process {rank}/{world} on {dev}: {cfg}, mask ratio {mask_ratio}, "
          f"{len(dataset)} pairs, {len(loader)} steps an epoch, lr "
          f"{args.lr:.3e}")

    t0 = time.time()
    steps_per_epoch = max(len(loader), 1)
    last_stats: Dict[str, float] = {"train_loss": float("nan"),
                                    "epoch": start_epoch - 1}
    for epoch in range(start_epoch, args.max_epoch):
        loader.set_epoch(epoch)
        losses = []
        # the update is gated on the device, so the host reads step N-1's
        # loss after enqueueing step N instead of waiting on every step
        # (the reference syncs each iteration, ref pretrain.py:220-222)
        pending = None

        def check_pending(p):
            it_prev, dev_loss = p
            loss_f = float(dev_loss)
            if not math.isfinite(loss_f):
                print(f"Loss is {loss_f} at it {it_prev} (update suppressed "
                      f"on device), stopping training")
                sys.exit(1)
            return loss_f

        for it, (img1, img2) in enumerate(loader):
            epoch_f = epoch + it / steps_per_epoch
            lr = lr_at(epoch_f, args.lr, args.min_lr, args.warmup_epochs,
                       args.epochs)
            img1 = torch.from_numpy(img1).to(dev, non_blocking=True)
            img2 = torch.from_numpy(img2).to(dev, non_blocking=True)
            mask = cp.random_mask(gen, img1.shape[0], n_patches, mask_ratio,
                                  dev)
            if args.accum_iter > 1:
                grad_acc, loss = grad_step(model, grad_acc, img1, img2, mask,
                                           1.0 / args.accum_iter)
                if (it + 1) % args.accum_iter == 0:
                    opt_state, grad_acc = apply_step(model, opt_state,
                                                     grad_acc, lr)
            else:
                opt_state, loss = step(model, opt_state, img1, img2, mask, lr)
            if pending is not None:
                losses.append(check_pending(pending))
            pending = (it, loss)
            if it % args.print_freq == 0:
                loss_f = float(loss)
                print(f"E{epoch} it{it}/{steps_per_epoch} "
                      f"loss={loss_f:.4f} lr={lr:.2e}", flush=True)
                if writer is not None:
                    step1000 = int(epoch_f * 1000)
                    writer.add_scalar("train_loss", loss_f, step1000)
                    writer.add_scalar("lr", lr, step1000)
        if pending is not None:
            losses.append(check_pending(pending))

        if rank == 0 and args.save_freq and epoch % args.save_freq == 0:
            ckpt.save("last", model, opt_state, epoch, float("inf"), args)
        if rank == 0 and args.keep_freq and epoch % args.keep_freq == 0 \
                and (epoch > 0 or args.max_epoch == 1):
            ckpt.save(str(epoch), model, opt_state, epoch, float("inf"), args)
        if joined:
            dist.barrier()

        last_stats = {"train_loss": float(np.mean(losses)) if losses
                      else float("nan"), "epoch": epoch}
        if rank == 0:
            with open(log_path, "a") as f:
                f.write(json.dumps(last_stats) + "\n")

    if writer is not None:
        writer.close()
    if joined and not was_joined:
        dist.destroy_process_group()
    print(f"Training time {time.time() - t0:.0f}s")
    return {"model": model, "opt_state": opt_state, **last_stats}
