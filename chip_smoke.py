#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`spann3r_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its results; any failure raises and exits non-zero:
  1. card    - requires a CUDA device; prints its name and power limit
               (nvidia-smi), the torch and CUDA versions and the TF32 flags
               (both set off);
  2. build   - compiles spann3r_torch/csrc/*.cu (into spann3r_torch/_build/)
               and prints the seconds it took;
  3. kernels - each CUDA kernel against its plain PyTorch version on the
               card, at the shapes the main path gives it, in bf16 and fp32:
               max abs/rel error beside the tolerance, median kernel and
               plain times from CUDA events;
  4. slice   - the full-width model (Spann3RConfig(), random weights from
               seed 0) at 512x384 BF16 reconstructs 24 frames through
               spann3r_torch.api.reconstruct_video (chunk 16): shapes,
               finiteness, conf >= 1, every kernel's launch count, at least
               one memory prune; then FPS of five more runs (median);
  5. parity  - the same weights at FP32, 224x224, 4 frames: the card
               (kernels) against the CPU (plain versions), tolerance 1e-3.
Before the last line it prints one JSON object with the kernels' records;
the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

SEED = 0
FRAMES_512 = 24
TIMED_RUNS = 5
HW_512 = (384, 512)
HW_224 = (224, 224)

# tolerances (max |kernel - plain| <= tol * (1 + |plain|)): fp32 RoPE is
# elementwise (1e-5); fp32 attention sums in another order (1e-4); bf16
# outputs carry one bf16 rounding (2e-2). The memory read with
# attn_thresh > 0 may keep a weight that the plain version drops, or the
# reverse, when the weight lies within rounding of the threshold. After the
# renormalisation such a weight is attn_thresh / kept (kept: the row's mass
# above the threshold, ~0.17 for a full bank of random scores), so each
# flip moves an output by up to attn_thresh / kept * max|v| and a slot's
# sum by attn_thresh / kept: that case adds 2 * attn_thresh / min(kept) *
# max(1, max|v|) to the bound, and the run prints how many elements needed
# it.
TOL = {("rope2d", torch.float32): 1e-5, ("sdpa", torch.float32): 1e-4,
       ("memory_read", torch.float32): 1e-4}
TOL_BF16 = 2e-2
E2E_TOL = 1e-3

SOURCES = {
    "rope2d": ("spann3r_torch/csrc/rope2d.cu",
               "spann3r_tpu/ops/pallas_rope.py:56"),
    "sdpa": ("spann3r_torch/csrc/sdpa.cu",
             "spann3r_tpu/ops/pallas_attention.py:60"),
    "memory_read": ("spann3r_torch/csrc/memory_read.cu",
                    "spann3r_tpu/ops/pallas_memory.py:129"),
}
# the memory-read kernel also replaces the two other pallas_call sites of
# the same TPU kernel
ALSO_REPLACES = {"memory_read": ["spann3r_tpu/ops/pallas_memory.py:138",
                                 "spann3r_tpu/ops/pallas_memory.py:149"]}


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of fn() on the card, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(name, got, want, tol, extra=0.0):
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (got - want).abs()
    base = tol * (1.0 + want.abs())
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp(min=1e-6)).max())
    ok = bool((err <= base + extra).all())
    return ok, max_abs, max_rel, int((err > base).sum())


def kept_mass(q, k, size, thr):
    """Smallest per-query attention mass above the threshold (plain math)."""
    s = torch.matmul(q[0, :, :].float(), k[0, :size].float().T) / q.shape[-1] ** 0.5
    a = torch.softmax(s, dim=-1)
    return float(torch.where(a < thr, 0.0, a).sum(-1).min())


# ---------------------------------------------------------------------------
# phase 1 and 2
# ---------------------------------------------------------------------------

def phase_card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False); this script runs only on the card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0].strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[card] nvidia-smi: {card}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count "
        f"{torch.cuda.device_count()}")
    log(f"[card] tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return card


def phase_build():
    from spann3r_torch.ops import _kernels
    t0 = time.perf_counter()
    _kernels.lib()
    log(f"[build] {_kernels.library_path().name} ready in "
        f"{time.perf_counter() - t0:.1f} s (nvcc "
        f"{_kernels.build_seconds if _kernels.build_seconds is not None else 0.0:.1f} s)")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def phase_kernels(records):
    from spann3r_torch.ops import attention, memory_read, rope

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    randn = lambda *s, dtype: torch.randn(*s, generator=g, device=dev).to(dtype)
    failures = []

    def case(kernel, label, dtype, run_kernel, run_plain, main, extra=0.0,
             time_it=True):
        tol = TOL.get((kernel, dtype), TOL_BF16) if dtype == torch.float32 \
            else TOL_BF16
        outs_k, outs_p = run_kernel(), run_plain()
        if not isinstance(outs_k, tuple):
            outs_k, outs_p = (outs_k,), (outs_p,)
        torch.cuda.synchronize()
        ok, max_abs, max_rel, n_over = True, 0.0, 0.0, 0
        for i, (a, b) in enumerate(zip(outs_k, outs_p)):
            o, ab, rl, no = compare(f"{kernel} {label} out{i}", a, b, tol, extra)
            ok, max_abs, max_rel = ok and o, max(max_abs, ab), max(max_rel, rl)
            n_over += no
        ms = cuda_ms(run_kernel) if time_it else float("nan")
        pms = cuda_ms(run_plain) if time_it else float("nan")
        dt = "bf16" if dtype == torch.bfloat16 else "fp32"
        log(f"[kernels] {kernel:11s} {label:34s} {dt} max_abs={max_abs:.3e} "
            f"max_rel={max_rel:.3e} tol={tol:g}+{extra:.2e} "
            f"(elements past tol: {n_over}) {'ok' if ok else 'FAIL'} kernel_ms={ms:.4f} plain_ms={pms:.4f}")
        if not ok:
            failures.append(f"{kernel} {label} {dt}")
        if main:
            src, rep = SOURCES[kernel]
            records[kernel] = {"name": kernel, "route": "cuda", "source": src,
                               "replaces": rep, "max_abs_err": max_abs,
                               "ms": ms, "plain_ms": pms}
            if kernel in ALSO_REPLACES:
                records[kernel]["also_replaces"] = ALSO_REPLACES[kernel]

    for dtype in (torch.bfloat16, torch.float32):
        main = dtype == torch.bfloat16
        # K3: encoder (B=16 frames, 16 heads) and decoder (12 heads) q/k,
        # as strided slices of a qkv projection
        for (b, h, n) in ((16, 16, 768), (1, 12, 768)):
            qkv = randn(b, n, 3, h, 64, dtype=dtype).permute(2, 0, 3, 1, 4)
            tok = qkv[0]
            pos = torch.stack(torch.meshgrid(torch.arange(24), torch.arange(32),
                                             indexing="ij"), -1).reshape(-1, 2)
            pos = pos[None].expand(b, -1, -1).to(dev)
            case("rope2d", f"({b},{h},{n},64) strided", dtype,
                 lambda: rope.rope_2d_cuda(tok, pos, 100.0),
                 lambda: rope.rope_2d_plain(tok, pos, 100.0),
                 main and b == 16)
            case("rope2d", f"({b},{h},{n},64) inverse", dtype,
                 lambda: rope.rope_2d_cuda(tok.contiguous(), pos, sign=-1.0),
                 lambda: rope.rope_2d_plain(tok, pos, sign=-1.0), False,
                 time_it=False)
        # K2: encoder self-attention, decoder cross-attention, 224 ragged
        for (b, h, n, m, label) in ((16, 16, 768, 768, "self"),
                                    (1, 12, 768, 768, "cross"),
                                    (1, 16, 196, 196, "self N=196"),
                                    (1, 12, 196, 300, "cross N!=M")):
            q = randn(b, h, n, 64, dtype=dtype)
            k = randn(b, h, m, 64, dtype=dtype)
            v = randn(b, h, m, 64, dtype=dtype)
            case("sdpa", f"{label} ({b},{h},{n},{m})", dtype,
                 lambda: attention.sdpa_cuda(q, k, v, 0.125),
                 lambda: attention.sdpa_plain(q, k, v, 0.125),
                 main and b == 16)
        # K1: 512x384 bank (P=768, C=8704, D=1024)
        p_, c_, d_ = 768, 8704, 1024
        q = randn(1, p_, d_, dtype=dtype)
        k = randn(1, c_, d_, dtype=dtype)
        v = randn(1, c_, d_, dtype=dtype)
        vmax = max(1.0, float(v.float().abs().max()))
        for size in (768, 4000, 8704):
            sz = torch.tensor([size], dtype=torch.int32, device=dev)
            for thr in (5e-4, 0.0):
                extra = 0.0
                if thr > 0:
                    extra = 2 * thr / kept_mass(q, k, size, thr) * vmax
                case("memory_read", f"size={size} thresh={thr:g}", dtype,
                     lambda: memory_read.memory_read_attention_cuda(q, k, v, sz, thr),
                     lambda: memory_read.memory_read_attention_plain(q, k, v, sz, thr),
                     main and size == 8704 and thr > 0, extra=extra)
    if failures:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{failures}")


# ---------------------------------------------------------------------------
# phase 4: the slice at full width
# ---------------------------------------------------------------------------

def make_frames(t, hw, seed=SEED):
    """uint8 frames: a shifted diagonal pattern under per-frame noise, so
    consecutive frames are related but not duplicates."""
    rng = np.random.default_rng(seed)
    h, w = hw
    base = (np.indices((h, w)).sum(0) % 255).astype(np.float32)
    out = np.empty((t, 1, h, w, 3), np.uint8)
    for i in range(t):
        pat = np.roll(base, i * 12, axis=1)[..., None]
        noise = rng.integers(0, 256, (h, w, 3)).astype(np.float32)
        out[i, 0] = (0.5 * pat + 0.5 * noise).astype(np.uint8)
    return out


def phase_slice(records, card):
    from spann3r_torch import api, config
    from spann3r_torch.models import memory as mem_mod
    from spann3r_torch.models import spann3r as sp
    from spann3r_torch.ops import _kernels

    cfg = config.Spann3RConfig()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = sp.build_spann3r(cfg, dev, torch.Generator().manual_seed(SEED))
    log(f"[slice] model built in {time.perf_counter() - t0:.1f} s, "
        f"{sum(p.numel() for p in model.parameters())} params")
    frames = make_frames(FRAMES_512, HW_512)

    prunes = {"n": 0}
    orig_prune = mem_mod.memory_prune

    def counting_prune(state, mcfg):
        prunes["n"] += 1
        return orig_prune(state, mcfg)

    reads = {}
    orig_engine_run = sp.InferenceEngine.run_video

    def run_video_recording(self, *a, **kw):
        out = orig_engine_run(self, *a, **kw)
        reads.update(self.stats, lm=int(self.carry.mem.lm[0]),
                     wm=int(self.carry.mem.wm[0]),
                     size=int(self.carry.mem.size[0]))
        return out

    mem_mod.memory_prune = counting_prune
    sp.InferenceEngine.run_video = run_video_recording
    try:
        torch.cuda.synchronize()
        _kernels.reset_launches()
        preds, order, _ = api.reconstruct_video(model, cfg, frames,
                                                config.BF16, chunk=16)
        torch.cuda.synchronize()
        counts = _kernels.launch_counts()
    finally:
        mem_mod.memory_prune = orig_prune
        sp.InferenceEngine.run_video = orig_engine_run
    log(f"[slice] launches {counts} memory_reads={reads['memory_reads']} "
        f"prunes={prunes['n']} final bank size={reads['size']} "
        f"wm={reads['wm']} lm={reads['lm']}")

    h, w = HW_512
    if len(preds) != FRAMES_512 or order != list(range(FRAMES_512)):
        raise AssertionError(f"expected {FRAMES_512} preds, got {len(preds)}")
    for i, pr in enumerate(preds):
        key = "pts3d" if i == 0 else "pts3d_in_other_view"
        if set(pr) != {key, "conf"}:
            raise AssertionError(f"pred {i} keys {sorted(pr)}")
        if pr[key].shape != (1, h, w, 3) or pr["conf"].shape != (1, h, w):
            raise AssertionError(f"pred {i} shapes {pr[key].shape} "
                                 f"{pr['conf'].shape}")
        if not (np.isfinite(pr[key]).all() and np.isfinite(pr["conf"]).all()):
            raise AssertionError(f"pred {i} is not finite")
        if not (pr["conf"] >= 1.0).all():
            raise AssertionError(f"pred {i} has conf < 1")
    for name in _kernels.KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the main path")
    if counts["memory_read"] != reads["memory_reads"]:
        raise AssertionError(f"memory_read launches {counts['memory_read']} != "
                             f"memory reads {reads['memory_reads']}")
    mcfg = cfg.memory
    p_tokens = (h // 16) * (w // 16)
    if prunes["n"] < 1:
        raise AssertionError("the bank was never pruned")
    log(f"[slice] preds ok: {len(preds)} x (1,{h},{w},3) finite, conf >= 1; "
        f"lm after prunes follows long_mem_size - wm*P = "
        f"{mcfg.long_mem_size - reads['wm'] * p_tokens} (+k*P)")
    for name in _kernels.KERNELS:
        records[name]["launches"] = counts[name]

    # timed runs after the first; the host loop sets the pace, so single
    # runs vary by tens of percent: report every run and the median
    fps = []
    for _ in range(TIMED_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        api.reconstruct_video(model, cfg, frames, config.BF16, chunk=16)
        torch.cuda.synchronize()
        fps.append(FRAMES_512 / (time.perf_counter() - t0))
    log(f"[slice] 512x384 BF16 {FRAMES_512} frames: median "
        f"{statistics.median(fps):.3f} FPS over {TIMED_RUNS} runs "
        f"{[round(f, 3) for f in fps]} on {card}")
    del model
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 5: card against CPU, end to end
# ---------------------------------------------------------------------------

def phase_parity():
    from spann3r_torch import api, config
    from spann3r_torch.models import spann3r as sp

    cfg = config.Spann3RConfig()
    frames = make_frames(4, HW_224, seed=SEED + 1)
    model_cpu = sp.build_spann3r(cfg, "cpu", torch.Generator().manual_seed(SEED))
    model_gpu = sp.build_spann3r(cfg, "cuda", torch.Generator().manual_seed(SEED))
    preds_gpu, _, _ = api.reconstruct_video(model_gpu, cfg, frames, config.FP32)
    del model_gpu
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    preds_cpu, _, _ = api.reconstruct_video(model_cpu, cfg, frames, config.FP32)
    log(f"[parity] CPU run took {time.perf_counter() - t0:.1f} s")
    if len(preds_cpu) != len(preds_gpu):
        raise AssertionError("card and CPU give different pred counts")
    worst = 0.0
    for i, (a, b) in enumerate(zip(preds_gpu, preds_cpu)):
        for key in a:
            err = np.abs(a[key] - b[key])
            worst = max(worst, float(err.max()))
            if not (err <= E2E_TOL * (1.0 + np.abs(b[key]))).all():
                raise AssertionError(f"pred {i} {key}: card vs CPU max err "
                                     f"{float(err.max()):.3e} > {E2E_TOL}")
    log(f"[parity] 224x224 FP32 4 frames: card (kernels) vs CPU (plain) "
        f"max abs err {worst:.3e} <= {E2E_TOL} ok")


def main():
    card = phase_card()
    phase_build()
    records = {}
    phase_kernels(records)
    phase_slice(records, card)
    phase_parity()
    print(json.dumps({"kernels": [records[k] for k in ("rope2d", "sdpa",
                                                       "memory_read")]}))
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
