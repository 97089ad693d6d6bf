"""CLI drivers for stereo and flow finetuning and evaluation (the JAX
package's stereoflow/driver.py).

Reference: croco/stereoflow/train.py (argument surface, model assembly,
epoch loop, best-checkpoint logic) and croco/stereoflow/test.py (tiled
evaluation, metric / pred / visu / submission dumps). Checkpoints are
`.pth` files in the reference's layout (`training.CheckpointManager`:
output_dir/checkpoint-{last,best}.pth with the model, the AdamW state, the
epoch and the best metric) beside a JSON sidecar, stereoflow_args.json,
that carries the CroCo and task arguments. --pretrained reads a
reference-format CroCo `.pth`, --start_from a reference-format stereoflow
`.pth` (the CroCo keys at the top level, the head under `head.`).
Both drivers run on the card unless --device cpu is passed, and raise
without one; the rank comes from `parallel/mesh.py` (0 without torchrun)
and seeds the data only, as the JAX package's driver.py does: no gradient is
all-reduced.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import pickle
import time
from types import SimpleNamespace
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from ..config import BF16, FP32, set_tf32_policy
from ..models.croco_downstream import (croco_args_from_ckpt,
                                       croco_kwargs_from_cfg)
from ..models.croco_pretrain import parse_croco_model
from ..parallel.mesh import init_distributed, make_mesh
from ..training import CheckpointManager, _opt_state_to
from ..utils.convert import (checkpoint_state, is_alias_or_vestigial_key,
                             read_checkpoint)
from . import datasets as sfd
from . import io as sfio
from .criterion import (FlowDatasetMetrics, StereoDatasetMetrics,
                        build_criterion)
from .engine import (cfg_from_croco_args, init_stereoflow, make_optimizer,
                     make_tile_fn, make_train_step, train_one_epoch,
                     validate_one_epoch)
from .tiling import tiled_pred

# keys of a CroCo pretraining checkpoint that the downstream model does not
# hold: the pretraining's mask token and prediction head, and the cosine
# mode's stored sin-cos tables (computed for each grid here)
_PRETRAIN_ONLY = ("mask_token", "prediction_head.", "enc_pos_embed",
                  "dec_pos_embed")


def get_args_parser() -> argparse.ArgumentParser:
    """ref stereoflow/train.py:37-81 (stereo/flow subparsers with
    task-dependent defaults), plus --device."""
    parser = argparse.ArgumentParser(
        "Finetuning CroCo models on stereo or flow", add_help=False)
    subparsers = parser.add_subparsers(title="Task (stereo or flow)",
                                       dest="task", required=True)
    ps = subparsers.add_parser("stereo", help="Training stereo model")
    pf = subparsers.add_parser("flow", help="Training flow model")

    def add_arg(name, default=None, default_stereo=None, default_flow=None,
                **kwargs):
        if default is not None:
            assert default_stereo is None and default_flow is None
            default_stereo = default_flow = default
        ps.add_argument(name, default=default_stereo, **kwargs)
        pf.add_argument(name, default=default_flow, **kwargs)

    add_arg("--output_dir", required=True, type=str)
    add_arg("--crop", type=int, nargs="+", default_stereo=[352, 704],
            default_flow=[320, 384])
    add_arg("--pretrained", type=str, default=None,
            help="pretrained CroCo .pth (reference format)")
    add_arg("--model", type=str, default=None,
            help="'CroCoNet(...)' string for random init (testing escape "
                 "hatch; the reference requires --pretrained)")
    add_arg("--criterion", default_stereo="LaplacianLossBounded2()",
            default_flow="LaplacianLossBounded()", type=str)
    add_arg("--bestmetric", default_stereo="avgerr", default_flow="EPE",
            type=str)
    add_arg("--dataset", type=str, required=True)
    add_arg("--seed", default=0, type=int)
    add_arg("--batch_size", default_stereo=6, default_flow=8, type=int)
    add_arg("--epochs", default=32, type=int)
    add_arg("--img_per_epoch", type=int, default=None)
    add_arg("--weight_decay", type=float, default=0.05)
    add_arg("--lr", type=float, default_stereo=3e-5, default_flow=2e-5)
    add_arg("--min_lr", type=float, default=0.)
    add_arg("--warmup_epochs", type=int, default=1)
    add_arg("--fp32", action="store_true",
            help="full fp32 compute (the reference's amp=0 default; "
                 "bf16 compute is the default here)")
    add_arg("--val_dataset", type=str, default="")
    add_arg("--tile_conf_mode", type=str,
            default_stereo="conf_expsigmoid_15_3",
            default_flow="conf_expsigmoid_10_5")
    add_arg("--val_overlap", default=0.7, type=float)
    add_arg("--tile_batch", default=8, type=int)
    add_arg("--eval_every", type=int, default=1)
    add_arg("--save_every", type=int, default=1)
    add_arg("--start_from", type=str, default=None)
    add_arg("--tboard_log_step", type=int, default=100)
    add_arg("--num_workers", default=8, type=int)  # accepted, unused
    add_arg("--device", default="cuda", type=str,
            help="cuda (the default; raises without a card) or cpu")
    return parser


def load_pretrained_croco(path: str):
    """(the CroCo backbone's state dict, croco_args) from a
    reference-format pretrained checkpoint (ref train.py:107-125), without
    the keys the downstream model does not hold."""
    ckpt = read_checkpoint(path)
    state = {k: v for k, v in checkpoint_state(ckpt).items()
             if not k.startswith(_PRETRAIN_ONLY)}
    return state, croco_args_from_ckpt(ckpt)


def stereoflow_state_from_reference(state: Dict[str, torch.Tensor]
                                    ) -> Dict[str, torch.Tensor]:
    """A reference stereoflow model's state dict (the CroCo keys at the top
    level, the task head under `head.`) as the port's (`croco.` and
    `head.`), without the DPT scratch's aliased `layer_rn.N` entries and
    the pretraining's keys."""
    out = {}
    for k, v in state.items():
        if is_alias_or_vestigial_key(k) or k.startswith(_PRETRAIN_ONLY):
            continue
        out[k if k.startswith("head.") else "croco." + k] = v
    return out


def _sidecar_path(output_dir):
    return os.path.join(output_dir, "stereoflow_args.json")


def main(args) -> Dict:
    set_tf32_policy()
    was_joined = dist.is_available() and dist.is_initialized()
    dev = init_distributed(args.device)
    rank = make_mesh().rank
    os.makedirs(args.output_dir, exist_ok=True)
    print("output_dir: " + args.output_dir)
    rng = np.random.default_rng(args.seed + rank)

    criterion = build_criterion(args.criterion)
    print("Criterion: ", args.criterion)
    num_channels = {"stereo": 1, "flow": 2}[args.task]
    if criterion.with_conf:
        num_channels += 1

    # model (ref train.py:107-127)
    pre_croco = None
    if args.pretrained:
        pre_croco, croco_args = load_pretrained_croco(args.pretrained)
    elif args.model:
        croco_args = croco_kwargs_from_cfg(parse_croco_model(args.model)[0])
    else:
        raise SystemExit("need --pretrained (or --model for random init)")
    cfg = cfg_from_croco_args(croco_args, tuple(args.crop))
    print("Croco args: " + str(croco_args))
    prec = FP32 if args.fp32 else BF16

    model, _hooks = init_stereoflow(
        torch.Generator().manual_seed(args.seed), cfg, num_channels, dev)
    if pre_croco is not None:
        model.croco.load_state_dict(pre_croco, strict=True)
    print(f"Total params: {sum(p.numel() for p in model.parameters())}")

    opt = make_optimizer(args.weight_decay)
    opt_state = opt.init(dict(model.named_parameters()))
    step_fn = make_train_step(cfg, criterion, args.task, opt, prec=prec)

    ckpt = CheckpointManager(args.output_dir)
    best_so_far = np.inf
    start_epoch = 0
    restored = ckpt.restore("last")
    if restored is not None:  # automatic restart (ref train.py:145-147)
        model.load_state_dict(restored["model"], strict=True)
        opt_state = _opt_state_to(restored["optimizer"], dev)
        start_epoch = int(restored["epoch"]) + 1
        best_so_far = float(restored["best_so_far"])
        print(f"resumed from checkpoint-last at epoch {start_epoch}")
    elif args.start_from:
        print(f"Starting from another model's weights: {args.start_from}")
        model.load_state_dict(stereoflow_state_from_reference(
            checkpoint_state(read_checkpoint(args.start_from))), strict=True)

    if rank == 0:
        with open(_sidecar_path(args.output_dir), "w") as f:
            json.dump({"task": args.task, "croco_args": croco_args,
                       "crop": list(args.crop),
                       "criterion": args.criterion,
                       "tile_conf_mode": args.tile_conf_mode,
                       "num_channels": num_channels}, f)

    log_writer = None
    if rank == 0:
        try:
            from torch.utils.tensorboard import SummaryWriter
            log_writer = SummaryWriter(log_dir=args.output_dir,
                                       purge_step=start_epoch * 1000)
        except ImportError:
            pass

    print("Building Train Data loader for dataset: ", args.dataset)
    build_train = (sfd.get_train_dataset_stereo if args.task == "stereo"
                   else sfd.get_train_dataset_flow)
    train_dataset = build_train(args.dataset, crop_size=tuple(args.crop),
                                seed=args.seed + rank)
    print(repr(train_dataset))

    datasets_val = None
    bestmetric = None
    if args.val_dataset:
        build_val = (sfd.get_test_datasets_stereo if args.task == "stereo"
                     else sfd.get_test_datasets_flow)
        datasets_val = build_val(args.val_dataset)
        for d in datasets_val:
            print(repr(d))
        bestmetric = (("AVG_" if len(datasets_val) > 1
                       else str(datasets_val[0]) + "_") + args.bestmetric)

    print(f"Start training for {args.epochs} epochs")
    start_time = time.time()
    val_stats, train_stats = {}, {}
    for epoch in range(start_epoch, args.epochs):
        epoch_ns = SimpleNamespace(**vars(args))
        opt_state, train_stats = train_one_epoch(
            model, opt_state, step_fn, train_dataset, epoch_ns, epoch, rng,
            log_writer=log_writer)

        log_stats = {f"train_{k}": v for k, v in train_stats.items()}
        log_stats["epoch"] = epoch
        if datasets_val is not None and args.eval_every > 0 and \
                (epoch + 1) % args.eval_every == 0:
            val_stats = validate_one_epoch(
                model, cfg, criterion, args.task, datasets_val, epoch_ns,
                epoch, prec=prec, log_writer=log_writer)
            log_stats.update({f"val_{k}": v for k, v in val_stats.items()})
            if val_stats[bestmetric] <= best_so_far:
                best_so_far = val_stats[bestmetric]
                if rank == 0:
                    ckpt.save("best", model, opt_state, epoch, best_so_far,
                              args)

        if rank == 0 and ((epoch + 1) % args.save_every == 0
                          or epoch + 1 == args.epochs):
            ckpt.save("last", model, opt_state, epoch, best_so_far, args)
        if rank == 0:
            with open(os.path.join(args.output_dir, "log.txt"), "a",
                      encoding="utf-8") as f:
                f.write(json.dumps(log_stats) + "\n")

    if log_writer is not None:
        log_writer.close()
    if dist.is_available() and dist.is_initialized() and not was_joined:
        dist.destroy_process_group()
    total = str(datetime.timedelta(seconds=int(time.time() - start_time)))
    print(f"Training time {total}")
    return {"best": best_so_far, "last_train": train_stats,
            "last_val": val_stats, "model": model, "opt_state": opt_state}


# ----------------------------- test driver -----------------------------

def get_test_args_parser() -> argparse.ArgumentParser:
    """ref stereoflow/test.py:30-48, plus --device."""
    parser = argparse.ArgumentParser("Test CroCo models on stereo/flow",
                                     add_help=False)
    parser.add_argument("--model", required=True, type=str,
                        help="output_dir of a stereoflow training run "
                             "(checkpoint-{best,last}.pth + sidecar)")
    parser.add_argument("--dataset", required=True, type=str,
                        help="test dataset(s), '+'-separated")
    parser.add_argument("--tile_conf_mode", type=str, default="",
                        help="empty = use the training sidecar's")
    parser.add_argument("--tile_overlap", type=float, default=0.7)
    parser.add_argument("--tile_batch", type=int, default=8)
    parser.add_argument("--fp32", action="store_true")
    parser.add_argument("--save", type=str, nargs="+", default=[],
                        choices=["metrics", "pred", "visu", "err10",
                                 "submission"])
    parser.add_argument("--num_workers", default=4, type=int)  # unused
    parser.add_argument("--device", default="cuda", type=str,
                        help="cuda (the default; raises without a card) or "
                             "cpu")
    return parser


def load_trained(model_dir: str, device="cuda"):
    """A finetuned stereoflow model from its output_dir: the sidecar's
    configuration, checkpoint-best.pth where there is one, else
    checkpoint-last.pth. Returns (model, cfg, hooks, meta)."""
    with open(_sidecar_path(model_dir)) as f:
        meta = json.load(f)
    cfg = cfg_from_croco_args(meta["croco_args"], tuple(meta["crop"]))
    model, hooks = init_stereoflow(None, cfg, meta["num_channels"], "cpu")
    ckpt = CheckpointManager(model_dir)
    restored = ckpt.restore("best") or ckpt.restore("last")
    assert restored is not None, f"no checkpoint in {model_dir}"
    model.load_state_dict(restored["model"], strict=True)
    return model.to(device), cfg, hooks, meta


def test_main(args) -> Dict[str, Dict]:
    """ref stereoflow/test.py:125-215: per-dataset tiled eval + dumps."""
    set_tf32_policy()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to test on the CPU")
    model, cfg, hooks, meta = load_trained(args.model, dev)
    task = meta["task"]
    criterion = build_criterion(meta["criterion"])
    tile_conf_mode = args.tile_conf_mode or meta["tile_conf_mode"]
    crop = tuple(meta["crop"])
    prec = FP32 if args.fp32 else BF16
    model_fn = make_tile_fn(model, cfg, prec)

    build = (sfd.get_test_datasets_stereo if task == "stereo"
             else sfd.get_test_datasets_flow)
    datasets = build(args.dataset)
    all_results = {}
    for dataset in datasets:
        dname = str(dataset)
        outdir = os.path.join(
            args.model,
            dname + "_tiled_{:s}_overlap{:g}".format(tile_conf_mode,
                                                     args.tile_overlap))
        os.makedirs(outdir, exist_ok=True)
        has_gt = True
        dm = (StereoDatasetMetrics if task == "stereo"
              else FlowDatasetMetrics)()
        dm.reset()
        for i in range(len(dataset)):
            img1, img2, gt, name = dataset[i]
            t0 = time.time()
            pred, _, _ = tiled_pred(
                model_fn, None, img1[None], img2[None],
                gt[None] if gt is not None else None,
                crop=crop, overlap=args.tile_overlap,
                conf_mode=tile_conf_mode, with_conf=criterion.with_conf,
                num_channels={"stereo": 1, "flow": 2}[task],
                tile_batch=args.tile_batch)
            elapsed = time.time() - t0
            pred0 = pred[0]
            if gt is not None:
                dm.add_batch(pred, gt[None])
            else:
                has_gt = False
            _save_sample(dataset, task, args.save, outdir,
                         dataset.pairnames[i], pred0,
                         gt, elapsed)
        results = dm.get_results() if has_gt else {}
        all_results[dname] = results
        if "metrics" in args.save and has_gt:
            with open(os.path.join(outdir, "metrics.pkl"), "wb") as f:
                pickle.dump(results, f)
        if "submission" in args.save and hasattr(dataset,
                                                 "finalize_submission"):
            dataset.finalize_submission(outdir)
        print(dname, results)
    return all_results


def _save_sample(dataset, task, save, outdir, pairname, pred, gt, elapsed):
    """Per-sample dumps (ref test.py:84-123): raw pred (npy, vs the
    reference's torch .pth tensor), visu/err10 pngs, submission files."""
    from PIL import Image
    if not save:
        return
    fname = os.path.join(outdir, dataset.pairname_to_str(pairname))
    os.makedirs(os.path.dirname(fname), exist_ok=True)
    if "pred" in save:
        np.save(fname + "_pred.npy", pred.squeeze(-1)
                if task == "stereo" else pred)
    if "visu" in save:
        if task == "stereo":
            disp = pred[..., 0]
            m = M = None
            if gt is not None:
                mask = np.isfinite(gt)
                m, M = gt[mask].min(), gt[mask].max()
            Image.fromarray(
                sfio.vis_disparity(disp, m=m, M=M)[..., ::-1]).save(
                fname + "_pred.png")
        else:
            ref = gt if gt is not None else pred
            flow_norm = float(np.sqrt(np.square(ref).sum(-1)).max())
            Image.fromarray(sfio.flow_to_color(
                pred, maxflow=flow_norm)).save(fname + "_pred.png")
    if "err10" in save and gt is not None:
        err = np.sum(np.abs(pred - gt), axis=-1)
        err = np.clip(err, 0, 10.0) / 10.0 * 255.0
        err[~np.isfinite(err)] = 255.0
        Image.fromarray(err.astype(np.uint8)).save(fname + "_err.png")
    if "submission" in save and hasattr(dataset, "submission_save_pairname"):
        sub = (pred.squeeze(-1).astype(np.float32) if task == "stereo"
               else pred.astype(np.float32))
        dataset.submission_save_pairname(pairname, sub, outdir, elapsed)
