"""The synthetic convergence gate of the port, on the card.

    python -m spann3r_torch.tools.convergence_gate [--epochs 4]
        [--out tests/data/torch_convergence_gate.json] [--deep] [--fp32]

Runs the real `training.train` recipe (per-iteration LR schedule,
frame-spacing curriculum, alpha coarse-to-fine, best-on-eval checkpoints,
remat) from random init on procedural SynthRoom scenes: 112 x 112, clips of
5 frames, B = 16, 4 epochs of 50 steps, lr 3e-4, seed 0, the recipe of the
JAX package's `tools/convergence_gate.py`. The held-out eval loss and the
full-pipeline reconstruction chamfer (streaming inference and the eval
alignment) are measured before and after; the gate passes when both
improve. `--deep` trains 8 epochs (crossing the alpha kink past epoch 4 and
the active-ratio decay past epoch 6) and SIGKILLs the training mid-epoch
5, then resumes it; the loss curve must be continuous across the kill.

The checkpoints go to --output_dir (checkpoint-best.pth is what the int8
and BF16_FAST gates read). The CPU miniature of the gate is in
tests/test_torch_gates.py.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def small_cfg(res: int):
    """A small configuration of the production topology (RoPE ViT encoder,
    dual decoders, DPT heads, value encoder and attention heads), scaled to
    train from scratch in minutes on one card."""
    from ..config import DUSt3RConfig, MemoryConfig, Spann3RConfig, ViTConfig
    return Spann3RConfig(
        dust3r=DUSt3RConfig(
            img_size=(res, res), patch_size=16,
            enc=ViTConfig(dim=384, depth=6, num_heads=6),
            dec=ViTConfig(dim=384, depth=12, num_heads=6),
            head_type="dpt"),
        memory=MemoryConfig(long_mem_size=1024),
        value_enc_depth=3, value_enc_dim=384, value_enc_heads=6,
        attn_head_in=384 + 384, attn_head_out=384)


def gate_args(res: int, epochs: int, batch_size: int, steps_per_epoch: int,
              lr: float, output_dir: str, fp32: bool, device: str,
              per_epoch_last: bool):
    """The trainer's arguments of the gate recipe."""
    from .. import training as tr

    args = tr.get_args_parser().parse_args([])
    args.resolution = res
    args.num_frames = 5
    args.batch_size = batch_size
    args.batch_size_test = 4
    args.epochs = epochs
    args.warmup_epochs = 1
    args.lr = lr
    args.min_lr = 1e-6
    args.eval_freq = 1
    # the kill/resume drill needs a checkpoint-last every epoch (the kill
    # lands mid-epoch kill_at, the resume loads epoch kill_at - 1's save);
    # otherwise last is saved only at the end
    args.save_freq = 1 if per_epoch_last else epochs
    args.keep_freq = 0
    args.print_freq = 10
    args.num_workers = 1
    args.bf16 = 0 if fp32 else 1
    args.remat = 1
    args.seed = 0
    args.device = device
    args.output_dir = output_dir
    n_items = steps_per_epoch * batch_size
    args.train_dataset = (
        f"{n_items} @ SynthRoom(num_seq=32, num_frames=5, resolution={res}, "
        f"seq_len=24, min_thresh=1, max_thresh=3, cache=True)")
    args.test_dataset = (
        f"SynthRoom(num_seq=8, num_frames=5, resolution={res}, seq_len=24, "
        f"min_thresh=1, max_thresh=3, scene_seed=5, seed=777, cache=True)")
    return args


def chamfer_expr(res: int) -> str:
    """The gate's reconstruction scenes: 3 full videos of 16 frames, every
    second one kept."""
    return (f"SynthRoom(num_seq=3, resolution={res}, seq_len=16, kf_every=2, "
            f"full_video=True, scene_seed=9)")


def get_args_parser():
    ap = argparse.ArgumentParser("synthetic convergence gate (PyTorch port)")
    ap.add_argument("--resolution", type=int, default=112)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--steps_per_epoch", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--output_dir", type=str, default="./output/conv_gate")
    ap.add_argument("--out", type=str,
                    default="tests/data/torch_convergence_gate.json")
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--deep", action="store_true",
                    help="deep gate: 8 epochs (crosses the alpha-c2f kink "
                         "past epoch 4 and the active_ratio decay past epoch "
                         "6) and a SIGKILL mid-epoch --kill_at with "
                         "auto-resume, loss-curve continuity asserted")
    ap.add_argument("--kill_at", type=int, default=None,
                    help="SIGKILL the training child mid-epoch N, then "
                         "auto-resume in-process (the training starts in a "
                         "subprocess); --deep defaults this to 5")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    ap.add_argument("--_child", action="store_true", help=argparse.SUPPRESS)
    return ap


def main(argv=None):
    cli = get_args_parser().parse_args(argv)
    if cli.deep:
        if cli.epochs == 4:
            cli.epochs = 8
        if cli.kill_at is None:
            cli.kill_at = 5
        if cli.output_dir == "./output/conv_gate":
            # keep the 4-epoch gate's checkpoint-best (the serving gates
            # read it) out of the drill's way
            cli.output_dir = "./output/conv_gate_deep"
    if cli.kill_at and not cli._child:
        # the drill starts from scratch: a stale checkpoint would make the
        # child resume and skip the epoch the kill is meant for
        for name in ("checkpoint-last.pth", "checkpoint-best.pth", "log.txt"):
            path = os.path.join(cli.output_dir, name)
            if os.path.exists(path):
                print(f"kill/resume drill: clearing stale {path}")
                os.remove(path)

    from .. import training as tr
    from .convergence import run_gate

    if cli.device.startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("convergence_gate: no CUDA device is "
                               "available; pass --device cpu")
    res = cli.resolution
    args = gate_args(res, cli.epochs, cli.batch_size, cli.steps_per_epoch,
                     cli.lr, cli.output_dir, cli.fp32, cli.device,
                     per_epoch_last=bool(cli.kill_at or cli._child))

    if cli._child:
        # the subprocess of the kill/resume drill: only the trainer,
        # killed by the parent mid-epoch
        tr.train(args, model_cfg=small_cfg(res))
        return True

    kill_resume = None
    if cli.kill_at:
        child = [sys.executable, "-m", "spann3r_torch.tools.convergence_gate",
                 "--_child", "--resolution", str(res),
                 "--epochs", str(cli.epochs),
                 "--batch_size", str(cli.batch_size),
                 "--steps_per_epoch", str(cli.steps_per_epoch),
                 "--lr", str(cli.lr), "--output_dir", cli.output_dir,
                 "--device", cli.device]
        if cli.fp32:
            child.append("--fp32")
        # the child inherits this process's working directory and
        # environment, so it imports the same package
        kill_resume = {"cmd": child, "epoch": cli.kill_at}

    artifact = run_gate(args, small_cfg(res), chamfer_expr(res),
                        n_chamfer_scenes=3, kill_resume=kill_resume)
    artifact["date"] = time.strftime("%Y-%m-%d")
    os.makedirs(os.path.dirname(os.path.abspath(cli.out)), exist_ok=True)
    with open(cli.out, "w") as f:
        json.dump(artifact, f, indent=1, default=float)

    b, a = artifact["before"], artifact["after"]
    print(f"\n=== convergence gate ({artifact['wall_s']:.0f} s, "
          f"{artifact['device']}) ===")
    print(f"eval loss_med : {b['eval'].get('loss_med'):.4f} -> "
          f"{a['eval'].get('loss_med'):.4f}")
    print(f"chamfer       : {b['chamfer']['chamfer']:.4f} -> "
          f"{a['chamfer']['chamfer']:.4f} "
          f"(acc {b['chamfer']['acc']:.4f} -> {a['chamfer']['acc']:.4f}, "
          f"comp {b['chamfer']['comp']:.4f} -> {a['chamfer']['comp']:.4f})")
    ok = artifact["eval_improved"] and artifact["chamfer_improved"]
    if "schedule" in artifact:
        s = artifact["schedule"]
        print(f"alpha/epoch : {s['alpha_per_epoch']}")
        print(f"ar/epoch    : {s['active_ratio_per_epoch']}")
        if cli.deep:
            ok = ok and s["alpha_c2f_kink_crossed"] \
                and s["active_ratio_decay_crossed"]
    if "kill_resume" in artifact:
        d = artifact["kill_resume"]
        print(f"kill/resume : killed mid-epoch {d['kill_epoch']}, loss "
              f"{d['loss_before_kill']:.4f} -> {d['loss_after_resume']:.4f} "
              f"across the boundary (start {d['loss_at_start']:.4f}), "
              f"continuous={d['curve_continuous']}")
        ok = ok and d["curve_continuous"]
    print("GATE:", "PASS" if ok else "FAIL")
    return ok


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
