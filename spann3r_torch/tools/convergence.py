"""Synthetic convergence gate of the port: evidence that its trainer learns.

The JAX package's counterpart is `spann3r_tpu/tools/convergence.py`. The
reference's only end-to-end training evidence is "eval chamfer improves and
the best checkpoint is kept" (ref training.py:94-168, 377-405), on real
datasets this repository does not hold. The gate reproduces that chain on
procedural SynthRoom scenes (`datasets/synth.py`): it runs the real
`training.train` recipe (curriculum, alpha coarse-to-fine, per-iteration LR
schedule, best-on-eval checkpoints, optional remat) from random init and
requires that

  1. the held-out eval loss (the `test_one_epoch` protocol) drops, and
  2. the reconstruction chamfer through the real inference and alignment
     pipeline (`tools/eval_pipeline.evaluate_scene`, the eval protocol)
     drops.

`python -m spann3r_torch.tools.convergence_gate` runs it on the card and
writes the artifact; tests/test_torch_gates.py runs a miniature on the CPU.
"""
from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Any, Dict, Optional

import numpy as np


def device_name(device) -> str:
    """The card's name and power limit as nvidia-smi gives them (`name,
    power.limit`), or the torch name of a CPU device."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={dev.index or 0}"],
            capture_output=True, text=True, timeout=30)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return torch.cuda.get_device_name(dev)


def synth_chamfer(model, cfg, prec, dataset, n_scenes: Optional[int] = None,
                  offline: bool = False) -> Dict[str, float]:
    """Masked accuracy and completion of full-pipeline reconstructions over
    the first `n_scenes` items of a full-video dataset (the eval metric
    protocol, ref eval.py:167-197, without the ICP refinement: random-init
    clouds lie too far from the GT for ICP to mean anything, and the gate
    measures the change)."""
    from ..datasets.loader import collate_views
    from .eval_pipeline import evaluate_scene
    from .eval_recon import accuracy, completion

    n = len(dataset) if n_scenes is None else min(n_scenes, len(dataset))
    accs, comps = [], []
    for i in range(n):
        batch = collate_views([dataset[i]])
        pts, gts, masks, _, _, _, _, _ = evaluate_scene(
            model, cfg, prec, batch, offline=offline)
        m = np.asarray(masks) > 0
        acc, _ = accuracy(gts[m].reshape(-1, 3), pts[m].reshape(-1, 3))
        comp, _ = completion(gts[m].reshape(-1, 3), pts[m].reshape(-1, 3))
        accs.append(acc)
        comps.append(comp)
    return {"acc": float(np.mean(accs)), "comp": float(np.mean(comps)),
            "chamfer": float((np.mean(accs) + np.mean(comps)) / 2.0),
            "n_scenes": n}


def _read_curve(output_dir: str) -> list:
    path = os.path.join(output_dir, "log.txt")
    if not os.path.exists(path):
        return []
    curve = []
    with open(path) as f:
        for line in f:
            try:
                curve.append(json.loads(line))
            except json.JSONDecodeError:
                pass
    return curve


def _kill_resume_drill(args, child_cmd, kill_epoch: int,
                       mid_epoch_wait: float = 15.0) -> Dict[str, Any]:
    """Run the training child process and SIGKILL it mid-epoch
    `kill_epoch`, so that the parent's `training.train` call that follows
    takes the real auto-resume path (ref training.py:377-405 load-last).

    The top-of-epoch log line of `kill_epoch` is written after the
    checkpoint-last save of epoch kill_epoch - 1 (the epoch loop's order),
    so once it appears the child is inside epoch `kill_epoch` with a
    checkpoint to resume from on disk; the wait that follows lands the kill
    mid-epoch, not on the boundary."""
    import signal

    def _top_of_epoch_seen(epoch: int) -> bool:
        # the top-of-epoch stats line has no train_loss key; the epoch-end
        # train summary has one
        return any(d.get("epoch") == epoch and "train_loss" not in d
                   for d in _read_curve(args.output_dir))

    proc = subprocess.Popen(child_cmd)
    t0 = time.time()
    try:
        while not _top_of_epoch_seen(kill_epoch):
            if proc.poll() is not None:
                raise RuntimeError(
                    f"training child exited (rc={proc.returncode}) before "
                    f"epoch {kill_epoch} was reached: cannot drill resume")
            time.sleep(2.0)
        time.sleep(mid_epoch_wait)  # land the kill mid-epoch
        proc.send_signal(signal.SIGKILL)
        proc.wait()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return {"kill_epoch": kill_epoch, "child_wall_s": time.time() - t0,
            "child_rc": proc.returncode}


def run_gate(args, model_cfg, chamfer_expr: str,
             n_chamfer_scenes: int = 4,
             artifact_path: Optional[str] = None,
             kill_resume: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Eval before -> train (the real trainer) -> eval after. Returns (and
    optionally writes) the gate artifact: the eval stats and the chamfer
    before and after, the per-epoch curve of log.txt, the schedule the run
    crossed, and the device (its name and power limit), the remat settings
    and the wall time.

    kill_resume={'cmd': [...], 'epoch': K} first runs the
    start of the training in a child process, SIGKILLs it mid-epoch K, and
    lets the in-process `training.train` auto-resume from checkpoint-last;
    the artifact then records the resume boundary and whether the
    train-loss curve is continuous across it."""
    import torch

    from .. import training as tr
    from ..config import BF16, FP32
    from ..datasets import build_dataset
    from ..models.spann3r import build_spann3r

    t0 = time.time()
    # The drill runs first, so that the child has the card to itself until
    # it is killed. The weights before training are a function of the seed
    # (the trainer builds them the same way), so computing them after the
    # drill changes nothing.
    drill = None
    if kill_resume:
        drill = _kill_resume_drill(args, kill_resume["cmd"],
                                   kill_resume["epoch"],
                                   kill_resume.get("mid_epoch_wait", 15.0))

    prec = BF16 if args.bf16 else FP32
    model0 = build_spann3r(model_cfg, args.device,
                           torch.Generator().manual_seed(args.seed))
    eval_step = tr.make_eval_step(model_cfg, prec)
    test_ds = build_dataset(args.test_dataset)
    if hasattr(test_ds, "set_epoch"):
        test_ds.set_epoch(0)
    before_eval = tr.test_one_epoch(eval_step, model0, test_ds,
                                    args.batch_size_test, output_dir=None)
    chamfer_ds = build_dataset(chamfer_expr)
    before_chamfer = synth_chamfer(model0, model_cfg, prec, chamfer_ds,
                                   n_chamfer_scenes)
    del model0

    # after the drill this auto-resumes from the killed child's
    # checkpoint-last
    result = tr.train(args, model_cfg=model_cfg)
    model1 = result["model"]
    after_eval = tr.test_one_epoch(eval_step, model1, test_ds,
                                   args.batch_size_test, output_dir=None)
    after_chamfer = synth_chamfer(model1, model_cfg, prec, chamfer_ds,
                                  n_chamfer_scenes)

    artifact = {
        "train_dataset": args.train_dataset,
        "test_dataset": args.test_dataset,
        "chamfer_dataset": chamfer_expr,
        "epochs": args.epochs, "batch_size": args.batch_size,
        "accum_iter": args.accum_iter, "remat": bool(args.remat),
        "remat_scan": bool(args.remat_scan),
        "lr": args.lr, "alpha_c2f": bool(args.alpha_c2f),
        "bf16": bool(args.bf16),
        # the precision deviations the trainer applied (training.train
        # reads these at step-build time)
        "adam_bf16": tr.precision_flag("SPANN3R_ADAM_BF16", args.bf16),
        "grads_bf16": tr.precision_flag("SPANN3R_GRADS_BF16", args.bf16),
        "device": device_name(args.device),
        "before": {"eval": before_eval, "chamfer": before_chamfer},
        "after": {"eval": after_eval, "chamfer": after_chamfer},
        "curve": _read_curve(args.output_dir),
        "eval_improved": after_eval.get("loss_med", np.inf)
        < before_eval.get("loss_med", np.inf),
        "chamfer_improved": after_chamfer["chamfer"]
        < before_chamfer["chamfer"],
    }

    # schedule coverage and resume-boundary continuity from the train-loss
    # curve (training.train writes per-epoch {'epoch', 'train_loss',
    # 'alpha', 'active_ratio'} summary lines)
    train_curve = [d for d in artifact["curve"] if "train_loss" in d]
    if train_curve:
        alphas = [d["alpha"] for d in train_curve]
        ars = [d["active_ratio"] for d in train_curve]
        artifact["schedule"] = {
            "alpha_per_epoch": alphas, "active_ratio_per_epoch": ars,
            "alpha_c2f_kink_crossed": min(alphas) < max(alphas),
            "active_ratio_decay_crossed": len(ars) > 1
            and ars[-1] < max(ars),
        }
    if drill:
        k = drill["kill_epoch"]
        losses = {d["epoch"]: d["train_loss"] for d in train_curve}
        pre, post = losses.get(k - 1), losses.get(k)
        drill["loss_before_kill"] = pre
        drill["loss_after_resume"] = post
        drill["loss_at_start"] = train_curve[0]["train_loss"] \
            if train_curve else None
        # continuity: the first epoch after the resume continues the
        # descent, and does not restart near the from-scratch loss
        drill["curve_continuous"] = (
            pre is not None and post is not None
            and post < pre * 1.5
            and post < drill["loss_at_start"] * 0.8)
        artifact["kill_resume"] = drill
    artifact["wall_s"] = time.time() - t0
    if artifact_path:
        os.makedirs(os.path.dirname(os.path.abspath(artifact_path)),
                    exist_ok=True)
        with open(artifact_path, "w") as f:
            json.dump(artifact, f, indent=1, default=float)
    return artifact
