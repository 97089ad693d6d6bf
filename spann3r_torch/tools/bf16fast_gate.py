"""The BF16_FAST serving gate of the port: the reconstruction quality of
bf16 pointmap heads (BF16_FAST) against the default BF16's fp32 heads, on
trained weights.

    python -m spann3r_torch.tools.bf16fast_gate
        [--ckpt output/conv_gate/checkpoint-best.pth]
        [--out tests/data/torch_bf16fast_gate.json] [--rel_bound 0.05]

The real eval protocol (streaming reconstruction, scale-shift-invariant
alignment, accuracy and completion; `tools/eval_pipeline`) runs on 3
procedural SynthRoom videos under BF16 and BF16_FAST on the same bf16
serving weights, and the relative chamfer change must stay within
--rel_bound. The weights are the convergence gate's checkpoint-best. The
JAX package's counterpart is `tools/bf16fast_gate.py`; the reference runs
its heads in fp32, so the bound is this repository's.
"""
from __future__ import annotations

import argparse
import sys
import time


def get_args_parser():
    ap = argparse.ArgumentParser("bf16-heads e2e accuracy gate (PyTorch port)")
    ap.add_argument("--ckpt", type=str,
                    default="output/conv_gate/checkpoint-best.pth")
    ap.add_argument("--resolution", type=int, default=112)
    ap.add_argument("--n_scenes", type=int, default=3)
    ap.add_argument("--rel_bound", type=float, default=0.05,
                    help="max allowed relative chamfer regression "
                         "BF16_FAST vs BF16")
    ap.add_argument("--out", type=str,
                    default="tests/data/torch_bf16fast_gate.json")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    return ap


def run(args, cfg=None):
    """The gate's artifact; `cfg` defaults to the convergence gate's
    small_cfg at --resolution (tests pass a tiny one)."""
    from ..config import BF16, BF16_FAST
    from ..ops.quant import cast_serving_weights_
    from .convergence import device_name, synth_chamfer
    from .convergence_gate import small_cfg
    from .int8_gate import gate_scenes, load_gate_model

    cfg = small_cfg(args.resolution) if cfg is None else cfg
    model, source = load_gate_model(args.ckpt, cfg, args.device)
    ds = gate_scenes(args.n_scenes, args.resolution)

    t0 = time.time()
    cast_serving_weights_(model)
    m_bf16 = synth_chamfer(model, cfg, BF16, ds, args.n_scenes)
    m_fast = synth_chamfer(model, cfg, BF16_FAST, ds, args.n_scenes)
    rel = (m_fast["chamfer"] - m_bf16["chamfer"]) / max(m_bf16["chamfer"],
                                                        1e-9)
    return {
        "ckpt": source, "resolution": args.resolution,
        "n_scenes": args.n_scenes, "bf16": m_bf16, "bf16_fast": m_fast,
        "chamfer_rel_delta": rel, "rel_bound": args.rel_bound,
        "pass": bool(abs(rel) <= args.rel_bound),
        "device": device_name(args.device),
        "wall_s": time.time() - t0,
        "date": time.strftime("%Y-%m-%d"),
    }


def main(argv=None):
    from ..config import set_tf32_policy
    from .int8_gate import write_artifact

    args = get_args_parser().parse_args(argv)
    set_tf32_policy()
    a = run(args)
    write_artifact(a, args.out)
    mb, mf = a["bf16"], a["bf16_fast"]
    print(f"\n=== bf16-heads e2e gate ({a['wall_s']:.0f} s, "
          f"ckpt={a['ckpt']}, {a['device']}) ===")
    print(f"BF16      chamfer: {mb['chamfer']:.4f} "
          f"(acc {mb['acc']:.4f} comp {mb['comp']:.4f})")
    print(f"BF16_FAST chamfer: {mf['chamfer']:.4f} "
          f"(acc {mf['acc']:.4f} comp {mf['comp']:.4f})")
    print(f"relative delta: {a['chamfer_rel_delta']:+.4%} "
          f"(bound {args.rel_bound:.0%})")
    print("GATE:", "PASS" if a["pass"] else "FAIL")
    return a["pass"]


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
