"""Benchmark of the port: incremental reconstruction FPS at 512x384 on the
card.

    python -m spann3r_torch.bench [--frames 64 --chunk 32 --streams 1 ...]

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline", ...extras},
the line of the JAX package's bench.py with the same keys and defaults,
plus "device" (torch.cuda.get_device_name()). Baseline target: >=20 FPS
incremental reconstruction at 512-res (BASELINE.md north-star).

Measures the streaming step of the flagship model (ViT-L encoder + dual
ViT-B decoders + DPT heads + the full spatial-memory read/dedup/spill/
prune; random weights from seed 0, stored in bf16) after a warm-up run
that also builds the CUDA kernels. The clock wraps the chunked scan only
(`models.spann3r.scan_video_chunk`, frames already on the device, results
left there) and ends with torch.cuda.synchronize(); --sync_per_chunk
synchronises after every chunk as well and reports each chunk's FPS.

Extras: ms_per_frame, mfu_pct (model FLOPs / elapsed / the card's dense
bf16 peak), streams, precision, the sync mode, reps and the min..max FPS
spread.
"""
import argparse
import contextlib
import json
import os
import time

import numpy as np

BASELINE_FPS = 20.0
# dense bf16 tensor-core FLOP/s by torch.cuda.get_device_name() (NVIDIA
# H100 SXM data sheet, at its 700 W power limit)
PEAK_BF16 = {"NVIDIA H100 80GB HBM3": 989e12}


def transformer_flops_per_frame(cfg, hw, b: int) -> float:
    """Analytic matmul FLOPs of one streaming step (all streams) outside
    the pointmap head: 2*M*K*N per matmul, the formula of the JAX package's
    bench.py. LayerNorm/softmax/elementwise FLOPs are ignored (<2%)."""
    dcfg = cfg.dust3r
    p = (hw[0] // dcfg.patch_size) * (hw[1] // dcfg.patch_size)

    def block(n, d, mlp_ratio=4):
        # qkv 6ndd + proj 2ndd + attn 4nnd + mlp 4nd*(ratio*d)
        return 8 * n * d * d + 4 * n * n * d + 4 * n * d * int(mlp_ratio * d)

    def dec_block(n, d):
        return 16 * n * d * d + 8 * n * n * d + 16 * n * d * d

    e, dd, v = dcfg.enc, dcfg.dec, cfg.value_enc_dim
    f = 2 * p * e.dim * (dcfg.patch_size ** 2 * 3)          # patch embed
    f += e.depth * block(p, e.dim)                          # ViT-L encoder
    f += 2 * 2 * p * e.dim * dd.dim                         # decoder embeds
    f += 2 * dd.depth * dec_block(p, dd.dim)                # dual decoder
    f += cfg.value_enc_depth * block(p, v)                  # value encoder
    if not cfg.use_feat:
        f += 2 * p * v * (dcfg.patch_size ** 2 * 3)         # pos patch embed
    f += 2 * p * v * cfg.attn_head_out                      # value_out
    f += 2 * (2 * p * cfg.attn_head_in * cfg.attn_head_in   # attn-head MLPs
              + 2 * p * cfg.attn_head_in * cfg.attn_head_out)
    c = cfg.memory.capacity(p)
    f += 4 * p * c * cfg.attn_head_out                      # memory read QK+AV
    return float(f * b)


def head_flops_per_frame(model, cfg, hw, b: int, prec) -> float:
    """FLOPs of one reference-frame head call over b streams, counted by
    torch.utils.flop_counter.FlopCounterMode on one call (convolutions and
    matmuls; the elementwise work that XLA's count of the JAX head adds is
    not counted)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from .models import dust3r as d3

    dcfg = cfg.dust3r
    p = (hw[0] // dcfg.patch_size) * (hw[1] // dcfg.patch_size)
    dev = next(model.parameters()).device
    states = [torch.zeros(b, p, dim, dtype=prec.compute_dtype, device=dev)
              for dim in dcfg.dpt_hook_dims]
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        d3.downstream_head(model.dust3r, 1, d3.states_from_hooks(dcfg, states),
                           hw, dcfg, prec)
    return float(counter.get_total_flops())


def model_flops_per_frame(model, cfg, hw, b: int, prec) -> float:
    """Transformer stacks and memory read (analytic) plus the head
    (counted)."""
    return (transformer_flops_per_frame(cfg, hw, b)
            + head_flops_per_frame(model, cfg, hw, b, prec))


def get_args_parser():
    ap = argparse.ArgumentParser("Spann3R benchmark (PyTorch port)")
    ap.add_argument("--height", type=int, default=384)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--streams", type=int, default=1,
                    help="independent video streams served in one batch")
    ap.add_argument("--bf16_heads", action="store_true",
                    help="BF16_FAST serving precision (bf16 DPT heads)")
    ap.add_argument("--int8", type=int, default=0,
                    help="1 = int8 weight-only serving (ops/quant.py); "
                         "2 = also int8 activations for calls of at least "
                         "quant.INT8_ACT_ROWS rows")
    ap.add_argument("--offline", action="store_true",
                    help="benchmark OFFLINE reconstruction (pairwise conf + "
                         "greedy next-best-view, ref demo.py --offline) "
                         "instead of the streaming scan")
    ap.add_argument("--sync_per_chunk", action="store_true",
                    help="synchronise after every chunk and report each "
                         "chunk's FPS")
    ap.add_argument("--reps", type=int, default=1,
                    help="timed repetitions; value = median FPS, and the "
                         "min..max spread is reported as fps_spread")
    ap.add_argument("--profile", type=str, default=None,
                    help="profile the timed runs with torch.profiler and "
                         "write trace.json and summary.txt to this directory")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    return ap


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _device_name(dev) -> str:
    import torch
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def run(args, cfg=None, model=None) -> dict:
    """Runs the benchmark the flags describe and returns the dict that
    `main` prints. `cfg` replaces the full-width Spann3RConfig() (small
    configurations for tests); `model`, a model of `cfg` already built on
    the device, replaces the seeded random one (its weights are cast for
    serving in place)."""
    import torch

    from .config import BF16, BF16_FAST, Spann3RConfig, set_tf32_policy
    from .models.spann3r import build_spann3r, init_video_carry, scan_video_chunk
    from .ops import quant

    tf32 = set_tf32_policy()
    hw = (args.height, args.width)
    prec = BF16_FAST if args.bf16_heads else BF16
    b = args.streams
    cfg = cfg or Spann3RConfig()
    if model is None:
        model = build_spann3r(cfg, args.device,
                              torch.Generator().manual_seed(0))
    # serve in bf16 (the heads keep fp32 weights and compute)
    quant.cast_serving_weights_(model)
    if args.int8:
        quant.quantize_linear_weights_(
            model, act_min_rows=quant.INT8_ACT_ROWS if args.int8 >= 2 else 0)
        print(f"int8 weight-only serving: {quant.count_quantized(model)} "
              f"matrices quantized")
    dev = next(model.parameters()).device
    precision = ("int8_act" if args.int8 >= 2 else "int8" if args.int8 else
                 "bf16_fast" if args.bf16_heads else "bf16")

    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (args.frames, b, *hw, 3)).astype(np.uint8)

    if args.offline:
        # offline mode has quadratic pairwise stages; the reference times it
        # on ~20-frame clips (demo.py --kf_every on short videos)
        from .models.offline import offline_reconstruction_fused
        n_off = min(args.frames, 20)
        fl = (frames[:n_off, 0].astype(np.float32) / 255.0) * 2.0 - 1.0
        offline_reconstruction_fused(model, fl, cfg, hw, prec=prec)  # warm-up
        elapsed_reps = []
        for _ in range(max(args.reps, 1)):
            _sync(dev)
            t0 = time.perf_counter()
            offline_reconstruction_fused(model, fl, cfg, hw, prec=prec)
            _sync(dev)
            elapsed_reps.append(time.perf_counter() - t0)
        elapsed = float(np.median(elapsed_reps))
        fps = n_off / elapsed
        return {
            "metric": f"offline_recon_fps_{args.width}x{args.height}",
            "value": round(fps, 3), "unit": "frames/s",
            "vs_baseline": round(fps / BASELINE_FPS, 3),
            "ms_per_frame": round(elapsed / n_off * 1e3, 3),
            "frames": n_off, "mode": "offline", "reps": len(elapsed_reps),
            "fps_spread": [round(n_off / max(elapsed_reps), 2),
                           round(n_off / min(elapsed_reps), 2)],
            "precision": "bf16_fast" if args.bf16_heads else "bf16",
            "tf32": tf32, "device": _device_name(dev)}

    chunks = [torch.from_numpy(frames[s:s + args.chunk]).to(dev)
              for s in range(0, args.frames, args.chunk)
              if s + args.chunk <= args.frames]
    n_frames = len(chunks) * args.chunk

    def scan(carry, ch):
        return scan_video_chunk(model, cfg, carry, ch, hw, prec)

    # warm-up: builds the kernels, exercises fill/dedup/prune
    carry = init_video_carry(cfg, hw, b, prec, dev)
    scan(carry, chunks[0])
    _sync(dev)

    # counted once, outside the timed window
    flops_per_frame = model_flops_per_frame(model, cfg, hw, b, prec)
    peak = PEAK_BF16.get(_device_name(dev))

    chunk_times: list = []

    def timed_run(per_chunk_sync: bool) -> float:
        carry = init_video_carry(cfg, hw, b, prec, dev)
        _sync(dev)
        t0 = time.perf_counter()
        t_prev = t0
        for ch in chunks:
            carry, _ = scan(carry, ch)
            if per_chunk_sync:
                _sync(dev)
                t_now = time.perf_counter()
                chunk_times.append(t_now - t_prev)
                t_prev = t_now
        _sync(dev)
        return time.perf_counter() - t0

    prof = contextlib.nullcontext()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else []))
    with prof:
        elapsed_reps = [timed_run(per_chunk_sync=args.sync_per_chunk)
                        for _ in range(max(args.reps, 1))]
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
        sort = "cuda_time_total" if dev.type == "cuda" else "cpu_time_total"
        with open(os.path.join(args.profile, "summary.txt"), "w") as f:
            f.write(prof.key_averages().table(sort_by=sort, row_limit=60))
    elapsed = float(np.median(elapsed_reps))

    fps = n_frames * b / elapsed
    ms_per_frame = elapsed / n_frames * 1e3
    fps_spread = [round(n_frames * b / max(elapsed_reps), 2),
                  round(n_frames * b / min(elapsed_reps), 2)]
    mfu = flops_per_frame * n_frames / elapsed / peak if peak else None
    return {
        "metric": f"incremental_recon_fps_{args.width}x{args.height}",
        "value": round(fps, 3),
        "unit": "frames/s",
        "vs_baseline": round(fps / BASELINE_FPS, 3),
        "ms_per_frame": round(ms_per_frame, 3),
        "mfu_pct": round(mfu * 100, 2) if mfu is not None else None,
        "streams": b,
        "precision": precision,
        "sync": "per_chunk" if args.sync_per_chunk else "final",
        "reps": len(elapsed_reps),
        "fps_spread": fps_spread,
        # with --sync_per_chunk, per-chunk FPS of the LAST timed rep: shows
        # throughput stays flat once the memory bank saturates and prune
        # cycles run every chunk (ref prune loop spann3r/model.py:185-210)
        **({"chunk_fps": [round(args.chunk * b / dt, 2)
                          for dt in chunk_times[-len(chunks):]]}
           if args.sync_per_chunk and chunk_times else {}),
        "tf32": tf32,
        "device": _device_name(dev),
    }


def main():
    print(json.dumps(run(get_args_parser().parse_args())))


if __name__ == "__main__":
    main()
