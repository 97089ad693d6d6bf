"""The serving table of the port: FPS across precision x streams x
resolution on the card.

Runs `python -m spann3r_torch.bench` once per configuration, each in a
process of its own (each configuration builds its own model and kernels'
working set; a fresh process keeps one configuration's allocator state out
of the next), and prints a markdown table and the raw JSON lines. The
configurations are those of the root `tools/serving_table.py` (over the
JAX package's `bench.py`).

Usage:  python -m spann3r_torch.tools.serving_table [--quick]
            [--out serving.md]
"""
from __future__ import annotations

import argparse
import json
import os.path as osp
import subprocess
import sys

ROOT = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))

# (label, bench args). The 224 runs are short, so they run longer scans
# (192 frames) x 5 reps and publish the median with the min..max spread.
_224 = ["--height", "224", "--width", "224", "--frames", "192",
        "--chunk", "32", "--reps", "5"]
CONFIGS = [
    ("512x384, bf16 (reference protocol)", ["--height", "384", "--width", "512"]),
    ("512x384, bf16_fast", ["--height", "384", "--width", "512", "--bf16_heads"]),
    ("512x384, int8 weight-only", ["--height", "384", "--width", "512",
                                   "--int8", "1"]),
    ("224x224, bf16", list(_224)),
    ("224x224, bf16_fast", _224 + ["--bf16_heads"]),
    ("224x224, bf16, 8 streams", _224 + ["--streams", "8"]),
]


def run_config(label: str, args: list) -> dict:
    cmd = [sys.executable, "-m", "spann3r_torch.bench", *args]
    print(f"[serving_table] {label}: {' '.join(cmd)}", flush=True)
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                         timeout=2400)
    line = [l for l in out.stdout.splitlines() if l.startswith("{")]
    if out.returncode != 0 or not line:
        raise RuntimeError(f"no JSON from bench for {label} (rc "
                           f"{out.returncode}):\n{out.stderr[-2000:]}")
    rec = json.loads(line[-1])
    rec["label"] = label
    print(f"[serving_table] -> {rec['value']} {rec['unit']}", flush=True)
    return rec


def table(recs) -> str:
    """The markdown table. The bench's ms_per_frame is per scan step (all
    streams advance one frame); per processed frame = step time / streams."""
    lines = ["| configuration | FPS (median) | spread | ms/frame | MFU |",
             "|---|---|---|---|---|"]
    for r in recs:
        lo, hi = r.get("fps_spread", [r["value"], r["value"]])
        lines.append(f"| {r['label']} | {r['value']:.1f} | "
                     f"{lo:.1f}..{hi:.1f} (n={r.get('reps', 1)}) | "
                     f"{r['ms_per_frame'] / r['streams']:.2f} | "
                     f"{r['mfu_pct']:.0f}% |")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="only the two 224-res single-stream configs")
    ap.add_argument("--out", default=None, help="write markdown here")
    args = ap.parse_args()

    configs = CONFIGS[3:5] if args.quick else CONFIGS
    recs = [run_config(lbl, a) for lbl, a in configs]
    md = table(recs)
    print(md)
    for r in recs:
        print(json.dumps(r))
    if args.out:
        with open(args.out, "w") as f:
            f.write(md + "\n")


if __name__ == "__main__":
    main()
