"""The int8 serving gate of the port: the reconstruction quality of int8
weights (and, with --act, int8 activations) against bf16 weights, on
trained weights.

    python -m spann3r_torch.tools.int8_gate
        [--ckpt output/conv_gate/checkpoint-best.pth]
        [--out tests/data/torch_int8_gate.json] [--rel_bound 0.05]
        [--min_dim 256] [--act 0|256]

The real eval protocol (streaming reconstruction, scale-shift-invariant
alignment, accuracy and completion; `tools/eval_pipeline`) runs on 3
procedural SynthRoom videos twice, bf16 serving weights
(`ops.quant.cast_serving_weights_`) against int8 linear weights
(`ops.quant.quantize_linear_weights_`), and the relative chamfer change
must stay within --rel_bound. The weights are the convergence gate's
checkpoint-best (`python -m spann3r_torch.tools.convergence_gate`), so the
comparison runs on weights that reconstruct; without the checkpoint the
gate runs on random weights (a check of the pipeline only). The JAX
package's counterpart is `tools/int8_gate.py`; the reference has no
quantised path, so the bound is this repository's.
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import sys
import time


def load_gate_model(ckpt: str, cfg, device: str):
    """(model, source): the model of `cfg` on `device` with the weights of
    the `.pth` at `ckpt` (the trainer's checkpoint layout), or random
    weights from seed 0 when there is no such file."""
    import torch

    from ..models.spann3r import build_spann3r
    from ..utils.convert import load_spann3r_checkpoint

    model = build_spann3r(cfg, device, torch.Generator().manual_seed(0))
    if osp.isfile(ckpt):
        load_spann3r_checkpoint(ckpt, model)
        return model, ckpt
    print(f"WARNING: {ckpt} not found - random init (pipeline-consistency "
          f"mode only)")
    return model, "random_init"


def gate_scenes(n_scenes: int, res: int):
    from ..datasets import build_dataset
    return build_dataset(f"SynthRoom(num_seq={n_scenes}, resolution={res}, "
                         f"seq_len=16, kf_every=2, full_video=True, "
                         f"scene_seed=9)")


def get_args_parser():
    ap = argparse.ArgumentParser("int8 e2e accuracy gate (PyTorch port)")
    ap.add_argument("--ckpt", type=str,
                    default="output/conv_gate/checkpoint-best.pth")
    ap.add_argument("--resolution", type=int, default=112)
    ap.add_argument("--n_scenes", type=int, default=3)
    ap.add_argument("--rel_bound", type=float, default=0.05,
                    help="max allowed relative chamfer regression int8 vs "
                         "bf16")
    ap.add_argument("--min_dim", type=int, default=256,
                    help="quantize_linear_weights_ min matrix dim. The "
                         "production default (512) targets ViT-L/B widths; "
                         "the gate's small configuration is 384 wide, so the "
                         "gate lowers it: otherwise nothing is quantised and "
                         "the comparison is vacuous (the gate fails on 0 "
                         "matrices)")
    ap.add_argument("--act", type=int, default=0,
                    help="also quantise the activations of the int8 arm's "
                         "calls with at least this many rows (act_min_rows; "
                         "the production floor is 1024, for 512-res encoder "
                         "batches; the gate's small configuration batches "
                         "fewer rows, so pass e.g. --act 256)")
    ap.add_argument("--out", type=str,
                    default="tests/data/torch_int8_gate.json")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    return ap


def run(args, cfg=None):
    """The gate's artifact; `cfg` defaults to the convergence gate's
    small_cfg at --resolution (tests pass a tiny one)."""
    from ..config import BF16
    from ..ops.quant import (cast_serving_weights_, count_quantized,
                             quantize_linear_weights_)
    from .convergence import device_name, synth_chamfer
    from .convergence_gate import small_cfg

    cfg = small_cfg(args.resolution) if cfg is None else cfg
    model, source = load_gate_model(args.ckpt, cfg, args.device)
    ds = gate_scenes(args.n_scenes, args.resolution)

    t0 = time.time()
    cast_serving_weights_(model)
    m_bf16 = synth_chamfer(model, cfg, BF16, ds, args.n_scenes)
    quantize_linear_weights_(model, min_dim=args.min_dim,
                             act_min_rows=args.act)
    nq = count_quantized(model)
    if nq == 0:
        raise AssertionError(f"no matrices quantized at min_dim="
                             f"{args.min_dim}: the bf16-vs-int8 comparison "
                             f"would be vacuous")
    m_int8 = synth_chamfer(model, cfg, BF16, ds, args.n_scenes)
    rel = (m_int8["chamfer"] - m_bf16["chamfer"]) / max(m_bf16["chamfer"],
                                                        1e-9)
    return {
        "ckpt": source, "resolution": args.resolution,
        "n_scenes": args.n_scenes, "quantized_matrices": nq,
        "int8_min_dim": args.min_dim, "int8_act_min_rows": args.act,
        "bf16": m_bf16, "int8": m_int8,
        "chamfer_rel_delta": rel, "rel_bound": args.rel_bound,
        "pass": bool(abs(rel) <= args.rel_bound),
        "device": device_name(args.device),
        "wall_s": time.time() - t0,
        "date": time.strftime("%Y-%m-%d"),
    }


def write_artifact(artifact, path):
    os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(artifact, f, indent=1, default=float)


def main(argv=None):
    from ..config import set_tf32_policy

    args = get_args_parser().parse_args(argv)
    set_tf32_policy()
    a = run(args)
    write_artifact(a, args.out)
    mb, mi = a["bf16"], a["int8"]
    print(f"\n=== int8 e2e gate ({a['wall_s']:.0f} s, "
          f"{a['quantized_matrices']} matrices quantized, act rows "
          f">= {args.act or 'off'}, ckpt={a['ckpt']}, {a['device']}) ===")
    print(f"bf16 chamfer: {mb['chamfer']:.4f} "
          f"(acc {mb['acc']:.4f} comp {mb['comp']:.4f})")
    print(f"int8 chamfer: {mi['chamfer']:.4f} "
          f"(acc {mi['acc']:.4f} comp {mi['comp']:.4f})")
    print(f"relative delta: {a['chamfer_rel_delta']:+.4%} "
          f"(bound {args.rel_bound:.0%})")
    print("GATE:", "PASS" if a["pass"] else "FAIL")
    return a["pass"]


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
