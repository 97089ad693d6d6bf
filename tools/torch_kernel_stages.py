#!/usr/bin/env python3
"""Per-stage device times of the port's memory read (K1), and times of its
attention kernel (K2), on one CUDA card, for one or more checkouts.

    python3 tools/torch_kernel_stages.py [TREE ...]

For each TREE (a checkout of the repo; default: this one), in a process of
its own that builds that tree's kernels:
  - K1: spann3r_torch.ops.memory_read.memory_read_attention_cuda on the
    512x384 bank (P=768, C=8704, D=1024, one stream, attn_thresh 5e-4) at
    4000 and 8704 valid slots (768 too for bf16), in bf16 and fp32, under
    torch.profiler: device microseconds per call of each CUDA kernel by
    name, and their sum;
  - K2: spann3r_torch.ops.attention.sdpa_cuda in bf16 at the encoder,
    decoder and value-encoder shapes, milliseconds per launch by
    chip_smoke.cuda_ms (one CUDA-event pair around >= 50 launches, the
    median of five loops).
Trees run in the order given, so list them as A B B A to see the drift.
"""
from __future__ import annotations

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
ITERS = 20


def run_tree(tree: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from spann3r_torch.ops import attention, memory_read
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    p_, c_, d_ = 768, 8704, 1024
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn(1, n, d_, generator=g, device=dev).to(dtype)
                   for n in (p_, c_, c_))
        for size in ((768, 4000, 8704) if dtype == torch.bfloat16
                     else (4000, 8704)):
            sz = torch.tensor([size], dtype=torch.int32, device=dev)
            run = lambda: memory_read.memory_read_attention_cuda(q, k, v, sz, 5e-4)
            run()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(ITERS):
                    run()
                torch.cuda.synchronize()
            stages = {}
            for e in prof.events():
                if e.device_type == DeviceType.CUDA and "kernel" in e.name:
                    name = e.name.replace("(anonymous namespace)::", "")
                    name = name.split("(")[0].split("::")[-1]
                    stages[name] = (stages.get(name, 0.0)
                                    + e.time_range.elapsed_us() / ITERS)
            stages = {n: round(t, 1) for n, t in stages.items()}
            print(f"K1 {str(dtype)[6:]} size={size} us per call {stages} "
                  f"sum {sum(stages.values()):.1f}", flush=True)
    for b, h in ((16, 16), (1, 12), (1, 16)):
        qkv = torch.randn(b, 768, 3, h, 64, generator=g, device=dev)
        qkv = qkv.to(torch.bfloat16).permute(2, 0, 3, 1, 4)
        ms = chip_smoke.cuda_ms(lambda: attention.sdpa_cuda(
            qkv[0], qkv[1], qkv[2], 0.125))
        print(f"K2 bf16 ({b},{h},768,768) ms per launch {ms:.4f}", flush=True)


def main() -> None:
    if len(sys.argv) > 2 and sys.argv[1] == "--tree":
        run_tree(sys.argv[2])
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    for tree in sys.argv[1:] or ["."]:
        print(f"== {tree}", flush=True)
        subprocess.run([sys.executable, os.path.abspath(__file__), "--tree",
                        tree], check=True)


if __name__ == "__main__":
    main()
