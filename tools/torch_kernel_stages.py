#!/usr/bin/env python3
"""Per-stage device times of the port's memory read (K1), and times of its
attention (K2) and RoPE (K3) kernels, on one CUDA card, for one or more
checkouts.

    python3 tools/torch_kernel_stages.py [--only k1,k2,k3,k2bwd] [TREE ...]

For each TREE (a checkout of the repo; default: this one), in a process of
its own that builds that tree's kernels (all sections, or those --only
names):
  - K1: spann3r_torch.ops.memory_read.memory_read_attention_cuda on the
    512x384 bank (P=768, C=8704, D=1024, one stream, attn_thresh 5e-4) at
    4000 and 8704 valid slots (768 too for bf16), in bf16 and fp32, under
    torch.profiler: device microseconds per call of each CUDA kernel by
    name, and their sum;
  - K2: spann3r_torch.ops.attention.sdpa_cuda in bf16 at the encoder,
    decoder and value-encoder shapes, milliseconds per launch by
    chip_smoke.cuda_ms (one CUDA-event pair around >= 50 launches, the
    median of five loops);
  - K3: RoPE on the q and k of one attention (strided slices of one qkv
    projection, int32 positions of the 512x384 patch grid expanded over the
    batch with stride 0) at the encoder (16,16,768,64) and decoder
    (1,12,768,64) shapes, in bf16 and fp32, milliseconds per q+k by
    chip_smoke.cuda_ms and host microseconds to enqueue one q+k (median
    of five loops of 200): one launch where the tree has
    `rope.rope_2d_qk_cuda`, else two of `rope.rope_2d_cuda`. Where the
    tree's launcher takes a token tile (`rope._launch`), also per tile
    size. The K3 outputs of a fixed set of inputs (both signs and dtypes,
    a ragged cross-attention pair) are kept, and after the last tree each
    tree's bits are compared with the first tree's.
  - K2 backward: spann3r_torch.ops.attention.sdpa_backward_cuda at
    chip_smoke's BWD_SHAPES (the training encoder, decoder and value
    encoder at 196 tokens, the 512x384 encoder) in bf16, and at the
    training encoder in fp32, with the layouts training gives it (q, k, v
    slices of one qkv projection, dO a (B, H, N, 64) view of a
    (B, N, H, 64) buffer, lse from the forward kernel), milliseconds per
    launch by chip_smoke.cuda_ms.
Trees run in the order given, so list them as A B B A to see the drift.
"""
from __future__ import annotations

import importlib.util
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
ITERS = 20
ROPE_TILES = (1, 2, 4, 8, 16, 32)
SECTIONS = ("k1", "k2", "k3", "k2bwd")


def k3_times(rope, chip_smoke, grid, dev):
    import torch

    fused = hasattr(rope, "rope_2d_qk_cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        for label, b, h in (("encoder", 16, 16), ("decoder", 1, 12)):
            qkv = torch.randn(b, 768, 3, h, 64, generator=g, device=dev)
            qkv = qkv.to(dtype).permute(2, 0, 3, 1, 4)
            q, k = qkv[0], qkv[1]
            pos = grid[None].expand(b, -1, -1)
            if fused:
                run = lambda: rope.rope_2d_qk_cuda(q, k, pos, pos)
            else:
                run = lambda: (rope.rope_2d_cuda(q, pos), rope.rope_2d_cuda(k, pos))
            ms = chip_smoke.cuda_ms(run)
            # host microseconds to enqueue one q+k: the decoder's launches
            # are shorter than that, so the host sets their pace
            host_us = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(200):
                    run()
                host_us.append((time.perf_counter() - t0) / 200 * 1e6)
            torch.cuda.synchronize()
            print(f"K3 {str(dtype)[6:]} {label} ({b},{h},768,64) q+k ms "
                  f"{ms:.4f} in {1 if fused else 2} launches; host us per "
                  f"q+k {statistics.median(host_us):.1f}", flush=True)
            if hasattr(rope, "_launch"):
                tiles = {t: chip_smoke.cuda_ms(lambda: rope._launch(
                    [(q, pos), (k, pos)], 100.0, 1.0, tile=t))
                    for t in ROPE_TILES}
                print(f"K3 {str(dtype)[6:]} {label} q+k ms by token tile "
                      + " ".join(f"{t}:{ms:.4f}" for t, ms in tiles.items()),
                      flush=True)


def kernel_us(run):
    """Device microseconds per call of run() of each CUDA kernel by name,
    from torch.profiler over ITERS calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    return {n: round(t, 1) for n, t in stages.items()}


def k2_backward_times(attention, chip_smoke, dev):
    import torch

    g = torch.Generator(device=dev).manual_seed(0)
    cases = [(label, b, h, n, torch.bfloat16)
             for label, b, h, n in chip_smoke.BWD_SHAPES]
    cases.append(("train encoder", 10, 16, 196, torch.float32))
    for label, b, h, n, dtype in cases:
        qkv = torch.randn(b, n, 3, h, 64, generator=g, device=dev)
        q, k, v = qkv.to(dtype).permute(2, 0, 3, 1, 4)
        dout = torch.randn(b, n, h, 64, generator=g, device=dev).to(
            dtype).transpose(1, 2)
        _, lse = attention.sdpa_cuda(q, k, v, 0.125, with_lse=True)
        run = lambda: attention.sdpa_backward_cuda(q, k, v, dout, lse, 0.125)
        ms = chip_smoke.cuda_ms(run)
        print(f"K2 backward {str(dtype)[6:]} {label} ({b},{h},{n},{n}) ms "
              f"per launch {ms:.4f}; us per launch by kernel "
              f"{kernel_us(run)}", flush=True)


def k3_outputs(rope, grid, dev):
    """K3 on fixed inputs: {case: output on the CPU}."""
    import torch

    fused = hasattr(rope, "rope_2d_qk_cuda")
    outs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for label, b, h, nq, nk in (("encoder", 2, 16, 768, 768),
                                    ("decoder", 1, 12, 768, 768),
                                    ("cross", 1, 12, 196, 300)):
            g = torch.Generator(device=dev).manual_seed(1)
            if label == "cross":
                q, k = (torch.randn(b, n, h, 64, generator=g, device=dev)
                        .to(dtype).transpose(1, 2) for n in (nq, nk))
                qpos, kpos = (torch.randint(0, 32, (b, n, 2), generator=g,
                                            device=dev, dtype=torch.int32)
                              for n in (nq, nk))
            else:
                qkv = torch.randn(b, nq, 3, h, 64, generator=g, device=dev)
                qkv = qkv.to(dtype).permute(2, 0, 3, 1, 4)
                q, k = qkv[0], qkv[1]
                qpos = kpos = grid[None].expand(b, -1, -1)
            for sign in (1.0, -1.0):
                if fused:
                    got = rope.rope_2d_qk_cuda(q, k, qpos, kpos, 100.0, sign)
                else:
                    got = (rope.rope_2d_cuda(q, qpos, 100.0, sign),
                           rope.rope_2d_cuda(k, kpos, 100.0, sign))
                for name, t in zip("qk", got):
                    outs[f"{str(dtype)[6:]} {label} sign={sign:+g} {name}"] = \
                        t.contiguous().cpu()
    return outs


def compare_bits(dumps) -> None:
    """Each tree's K3 outputs against the first tree's: differing elements
    and the largest difference in units of the last place."""
    import torch

    first = torch.load(dumps[0])
    for i, path in enumerate(dumps[1:], start=1):
        other = torch.load(path)
        diff, total, worst = 0, 0, 0
        for key, a in first.items():
            b = other[key]
            ints = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
            d = (a.view(ints).long() - b.view(ints).long()).abs()
            diff += int((d > 0).sum())
            total += d.numel()
            worst = max(worst, int(d.max()))
        print(f"K3 bits: tree {i} against tree 0: {diff} of {total} elements "
              f"differ in {len(first)} outputs, at most {worst} ulp",
              flush=True)


def run_tree(tree: str, dump: str, only) -> None:
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    from spann3r_torch.models.vit import patch_positions
    from spann3r_torch.ops import attention, memory_read, rope
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    grid = patch_positions(24, 32, dev)
    if "k3" in only:
        torch.save(k3_outputs(rope, grid, dev), dump)
        k3_times(rope, chip_smoke, grid, dev)
    if "k2bwd" in only:
        k2_backward_times(attention, chip_smoke, dev)
    g = torch.Generator(device=dev).manual_seed(0)
    p_, c_, d_ = 768, 8704, 1024
    for dtype in ((torch.bfloat16, torch.float32) if "k1" in only else ()):
        q, k, v = (torch.randn(1, n, d_, generator=g, device=dev).to(dtype)
                   for n in (p_, c_, c_))
        for size in ((768, 4000, 8704) if dtype == torch.bfloat16
                     else (4000, 8704)):
            sz = torch.tensor([size], dtype=torch.int32, device=dev)
            stages = kernel_us(
                lambda: memory_read.memory_read_attention_cuda(q, k, v, sz, 5e-4))
            print(f"K1 {str(dtype)[6:]} size={size} us per call {stages} "
                  f"sum {sum(stages.values()):.1f}", flush=True)
    for b, h in ((16, 16), (1, 12), (1, 16)) if "k2" in only else ():
        qkv = torch.randn(b, 768, 3, h, 64, generator=g, device=dev)
        qkv = qkv.to(torch.bfloat16).permute(2, 0, 3, 1, 4)
        ms = chip_smoke.cuda_ms(lambda: attention.sdpa_cuda(
            qkv[0], qkv[1], qkv[2], 0.125))
        print(f"K2 bf16 ({b},{h},768,768) ms per launch {ms:.4f}", flush=True)


def main() -> None:
    args = sys.argv[1:]
    only = SECTIONS
    if args[:1] == ["--only"]:
        only = tuple(args[1].split(","))
        if not set(only) <= set(SECTIONS):
            raise SystemExit(f"--only takes some of {','.join(SECTIONS)}")
        args = args[2:]
    if args[:1] == ["--tree"]:
        run_tree(args[1], args[2], only)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        dumps = []
        for i, tree in enumerate(args or ["."]):
            print(f"== tree {i}: {tree}", flush=True)
            dumps.append(os.path.join(tmp, f"k3_{i}.pt"))
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--only", ",".join(only), "--tree", tree,
                            dumps[-1]], check=True)
        if "k3" in only:
            compare_bits(dumps)


if __name__ == "__main__":
    main()
