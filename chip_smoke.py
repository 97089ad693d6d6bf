#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`spann3r_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its results; any failure raises and exits non-zero:
  1. card    - requires a CUDA device; prints its name and power limit
               (nvidia-smi), the torch and CUDA versions and the TF32 flags
               (both set off by the port's set_tf32_policy);
  2. build   - compiles spann3r_torch/csrc/*.cu (into spann3r_torch/_build/)
               and prints the seconds it took;
  3. kernels - each CUDA kernel against its plain PyTorch version on the
               card, at the shapes the main path gives it (K3 on the q and
               k of one attention in one launch, at the encoder and decoder
               shapes, with int32 positions built as the model builds them;
               K1 also with two streams of unequal sizes), in bf16 and
               fp32: max abs/rel
               error beside the tolerance, and planted faults that the
               check must reject; kernel, plain and (K2 only)
               F.scaled_dot_product_attention times, each one CUDA-event
               pair around >= 50 back-to-back launches (>= 2 ms), the
               median of five such loops; the least time the card could
               take (bound_ms) from the shapes and the valid sizes;
  4. slice   - the full-width model (Spann3RConfig(), random weights from
               seed 0) at 512x384 BF16 reconstructs 24 frames through
               spann3r_torch.api.reconstruct_video (chunk 16): shapes,
               finiteness, conf >= 1, every kernel's launch count (K3 once
               per attention, by stage), at least one memory prune; then
               FPS of five more runs (median);
  5. offline - the same model reconstructs 8 normalised frames offline
               (api.reconstruct_video(offline=True), complete graph, BF16):
               the preds contract, a frame order that is a permutation,
               launches of each kernel by stage against what the code
               implies (offline_launches), the K2/K3 launches at decoder
               batch 8 and in the 8-frame encoder; the wall per clip
               (median of 3 after a first run);
  6. engine  - InferenceEngine.run (a frame at a time) on 8 frames against
               run_video on the same frames, within ENGINE_TOL;
  7. serving - the 24-frame slice under cast_serving_weights_, BF16_FAST,
               int8 weight-only and int8 weights + activations: the preds
               contract, the int8 matrices, the difference from the plain
               BF16 slice (cast weights: none beyond what two plain runs
               differ by), device busy time and copy kernels of one
               profiled run, and the median wall of 3 runs;
  8. entry   - the port's entry points on the same model: the bench
               (spann3r_torch.bench.run, 512x384 BF16, one stream, 32
               frames in chunks of 16, 3 reps: its JSON line), the demo
               (demo.main at --resolution 512 on an 8-frame folder the phase
               writes: reconstruction, the focal on the card, the PLY and
               transforms.json read back) and the eval (eval.main on two
               SynthRoom scenes at 224, seq_len 16, kf_every 2, its ICP and
               metrics on EVAL_METRIC_POINTS of each scene's points: finite
               metrics, seconds per scene split into reconstruction and
               ICP + metrics); each with its kernel launches, counted from
               0. The demo and eval CLIs need PIL and cv2: without them
               the phase fails and names the missing one;
  14. align  - (run after phase 8, on the same model) global alignment:
               (a) 8 frames at 512x384 BF16, the complete symmetric graph
               (56 pairs), models.inference.inference at batch 8, K2 and
               K3 launches by stage against pairwise_launches, then
               global_aligner (MST init on the host) and 300 Adam steps at
               lr 0.01 on the card: the inference ms, the host init s,
               the median ms a step (a CUDA-event pair around each), the
               peak memory, the accessors finite and of their shapes,
               show() to a GLB read back (masks at the median confidence:
               random weights stay below the demo's 3), and with cv2
               mask_sky on that output and PairViewer on the synthetic
               scene's first two cameras (the relative pose within 2e-2
               of the truth); (b) the synthetic consistent scene
               of tests/test_global_align.py at 512x384 with 8 cameras:
               final loss, depth correlation and the distance to the
               ground truth after a best-fit similarity within their
               bounds, and a planted fault (two edges' pred_j swapped)
               caught; (c) card against CPU on that scene at 64x48 with 4
               cameras and seeded noise: final loss and points within
               1e-3; (d) forward_mixed on a landscape and a portrait pair
               against forward on each, the same bits;
  10. train  - (run after phase 8) the training CLI's configuration at
               full published width (224x224 DPT, random weights from
               seed 0), make_train_step on SynthRoom batches (B = 2,
               T = 5, BF16 with bf16 gradients and moments, memory
               dropout): K2 and K3 launches, forward and backward, of one
               step against train_launches; losses and grad norms finite;
               the weights moved; the median step time and peak memory;
               the same for remat and remat_scan (launches with the
               recomputed forwards against train_launches, step time,
               peak memory); on one fixed batch at constant LR the last
               loss below the first; the FP32 gradients of the three remat
               settings on one batch with dropout on, within
               REMAT_GRAD_TOL of the largest |grad|; then 3 steps of the
               same model on a mixture of the six datasets that read files
               (CO3D, BlendedMVS, ScanNet, ScanNet++, ARKitScenes, Habitat:
               fixture trees in their layouts at their raw sizes, written
               from a seed), their launches against train_launches and the
               loader's clips/s, and `python -m spann3r_torch.train` on the
               mixture for one epoch at the CLI's defaults;
  11. gate   - (run after phase 10) the convergence gate's miniature:
               run_gate on its small configuration at 112 x 112, 2 epochs
               of 15 steps at B = 8, remat on: the held-out eval loss must
               fall, every kernel launched; the chamfer before and after,
               and the int8, int8 + activations and BF16_FAST relative
               chamfer changes on its checkpoint-best (reported);
  12. dist   - (run after phase 11) multi-process training: (a) in a
               subprocess, world 1 over NCCL under torchrun's environment,
               phase 10's configuration for DIST_STEPS steps with --fsdp 0
               and --fsdp 1 between two one-process runs on the same
               batches: the same bits (losses, grad norms, every weight)
               and the launches of step 1 equal to train_launches, step
               times beside the one-process runs' and phase 10's; then
               `python -m torch.distributed.run --nproc_per_node 1 -m
               spann3r_torch.train` for one step at the CLI's defaults;
               (b) two ranks on the one card over gloo: each layout
               (data 2, data 2 --fsdp 1, model 2) on the narrow FP32
               configuration with uneven valid masks, B = 1 a rank:
               the loss and the data-summed gradients against the
               one-process step on the global batch within DIST_TOL
               (DIST_TP_TOL under tensor parallelism), a
               planted fault (gradients averaged) caught, step times (gloo
               through the host: not NCCL's); (c) two full-width ranks at
               224, B = 1 x T = 5 each, --fsdp 0 and 1: the state each
               rank holds before a step against `state_bytes`, and its
               peak memory; (d) multi-stream serving over ranks
               (parallel.streams.scan_streams on make_mesh_for_batch): B =
               4 streams of 8 frames at 224 FP32 at world 1 over NCCL and
               over two gloo ranks, against four one-stream runs within
               2e-4 abs + 1e-4 rel;
  13. pretrain - (run last) CroCo pretraining at two published
               configurations at 224, B = 64, bf16: CroCoNet() (the
               pretraining CLI's default; its decoder has head dim 32) and
               the CroCo v2 ViT-L / Base decoder with RoPE100, 5 steps each
               on one batch: launches of step 1 against pretrain_launches,
               finite losses, the last below the first, the median step,
               images/s and peak memory; then box-room pairs from
               `python -m spann3r_torch.habitat_gen.scripts`, `python -m
               torch.distributed.run --nproc_per_node 1 -m
               spann3r_torch.pretrain` for one epoch and again to resume
               it, `python -m spann3r_torch.tools.croco_demo` on its
               checkpoint; and one FP32 pretrain step of a narrow
               configuration (head dims 64 and 32, RoPE100), card against
               CPU within 1e-3;
  15. stereoflow - (run after phase 13) stereo and flow finetuning at
               CroCo-Stereo's and CroCo-Flow's published recipes on the
               CroCo v2 ViT-L / Base decoder (RoPE100, random init from
               seed 0): (a) crop 352x704, B = 6, LaplacianLossBounded2, lr
               3e-5, 5 steps of stereoflow.engine.make_train_step on one
               batch of a SceneFlow fixture tree at its raw 540x960, (b)
               crop 320x384, B = 8, LaplacianLossBounded, lr 2e-5, 3 steps
               on a FlyingChairs tree at 384x512: launches of step 1
               against stereoflow_launches, finite losses, the last below
               the first, the median step, pairs/s and peak memory; the
               tiled test of one 540x960 pair at full width (9 tiles at
               overlap 0.7 in chunks of 8): launches, seconds a pair;
               (c) `python -m spann3r_torch.stereoflow_train stereo` with
               tiled validation and `python -m spann3r_torch.stereoflow_test
               --save metrics pred visu` on its output, at a narrow model;
               (d) one FP32 stereo step of that narrow model, card against
               CPU within 1e-3;
  9. parity  - the same weights at FP32, 224x224, 4 frames, streaming and
               offline: the card (kernels) against the CPU (plain
               versions), the same frame order, tolerance 1e-3; the
               eval pipeline (evaluate_scene) on a 4-frame BoxRoomBackend
               scene, its aligned points within the same tolerance; and
               one FP32 train step of a narrow configuration with head
               dim 64 (loss and every gradient, within 1e-3 of the
               largest |grad|).
Phase 3 also holds, for every bf16 shape of K2's backward, the kernel and
the library's backward (F.scaled_dot_product_attention under autograd) to
the plain bound without the flip allowance: the elements past it and the
largest excess of each, one line a shape; the kernel may lie past it on
at most ALLOWANCE_MARGIN elements more than the library (records under the
sdpa_bwd record's "allowance").
Phase 3 also holds K2 and its backward at head dim 32 (DH32_SHAPES: the
CroCoNet() decoder at B = 64, and a ragged 20-token tile and N != M as
extra coverage), with planted faults on the columns and the last tile
(records under "head_dim_32"), and K2 both ways and K3 both ways at the
pretraining path's other shapes (PRETRAIN_SHAPES: the encoders on the 20
visible tokens and on 196, the decoders' self and cross attention; K3 at
the positions a random mask gathers), with planted faults (records under
"pretrain_by_shape").
Phase 3 also holds K3, K2 and their backwards at the stereo and flow
finetuning path's shapes (STEREOFLOW_SHAPES: the encoder over both images
and the decoder's self and cross attention at 968 tokens, B = 6 pairs, and
at 480 tokens, B = 8; the tiled test's forwards at tile_batch 8), with
the same planted faults (records under "stereoflow_by_shape").
Phase 3 also holds K2's backward kernel and K3 at sign -1 (the backward)
against their plain versions at the training shapes and the 512 encoder's,
with planted faults (K2's: one in each of dq, dk and dv), K2's and K3's
forwards at the training shapes (records under "train_by_shape"), and
times them
(K2's library time: the library's
forward + backward minus its forward). Phase 7 also measures what TF32 on
would change in the slice's pointmaps. Phase 3 also runs K2 and K3 at the
offline shapes: the encoder on 8 frames,
the decoder at the pairwise scan's batch of 8 and at the candidate
batches of the greedy rounds (6 down to 2, checked, not timed), positions
expanded over the batch with stride 0. Before the last line it prints one
JSON object with the kernels' records (K3's holds the encoder shape; its
"decoder" field the decoder shape's numbers; the "offline" fields of K2
and K3 the batch-8 decoder shape's and the "offline_encoder" fields the
8-frame encoder's, each with its launches in the offline run); the last
line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
FRAMES_512 = 24
FRAMES_OFFLINE = 8
# the decoder batches of the offline run's candidate scoring: the frames
# not used yet, n - 2 down to 1 (batch 1 is the streaming decoder's)
CANDIDATE_BATCHES = tuple(range(2, FRAMES_OFFLINE - 1))
FRAMES_ENGINE = 8
FRAMES_DEMO = 8
# the entry phase's bench: 512x384 BF16, one stream (the bench's defaults
# but for the frames, the chunk and the reps)
BENCH_FLAGS = ("--frames", "32", "--chunk", "16", "--reps", "3")
# the keys of the bench's JSON line (bench.py's, plus the card's name and
# the TF32 policy)
BENCH_KEYS = frozenset({"metric", "value", "unit", "vs_baseline",
                        "ms_per_frame", "mfu_pct", "streams", "precision",
                        "sync", "reps", "fps_spread", "tf32", "device"})
# the eval's SynthRoom scenes: 16 frames, every second one kept
EVAL_SCENES, EVAL_SEQ_LEN, EVAL_KF_EVERY = 2, 16, 2
# the points of each scene that the eval's ICP and metrics take in this run
# (the CLI takes all of a scene's masked points, ~400,000 at 224 x 224 x 8
# frames): random weights leave the aligned prediction far from the GT,
# where the nearest-neighbour queries of ICP, normals, accuracy and
# completion cost the card's host ~20-35 s a scene on all the points. The
# subsample keeps the host work that checks nothing on the card out of the
# phase's time; ICP runs on it as the CLI runs it.
EVAL_METRIC_POINTS = 4096
TIMED_RUNS = 5
HW_512 = (384, 512)
HW_224 = (224, 224)

# tolerances (max |kernel - plain| <= tol * (rms + |plain|), rms the root
# mean square of the plain output over each stream or batch, so that the
# bound follows the size of what is compared): fp32 RoPE is elementwise
# (1e-5); fp32 attention sums in another order (1e-4); bf16 RoPE rounds
# once, from fp32 values that differ by fp32 rounding, so the two sides are
# at most one bf16 ulp (2^-7 of |plain|) apart (8e-3); the other bf16
# outputs carry rounded intermediates (2e-2). The memory read with
# attn_thresh > 0 may keep a weight that the plain version drops, or the
# reverse, when the weight lies within rounding of the threshold. After
# the renormalisation such a weight is attn_thresh / kept (kept: the row's
# mass above the threshold, ~0.17 for a full bank of random scores), so
# each flip moves an output by up to attn_thresh / kept * max|v| and a
# slot's sum by attn_thresh / kept: the rows and slots that hold a weight
# within 1e-4 (relative) of the threshold get 2 * attn_thresh / min(kept) *
# max(1, max|v|) added to their bound, and the run prints how many rows
# that is and how many elements needed it. A flip also rescales the rest
# of its row by up to attn_thresh / kept, so each slot's sum gets
# 2 * attn_thresh / min(kept) times the weight it takes from those rows as
# well. K2's bf16 backward rounds P and dS to bf16 on both sides: the
# entries whose fp32 values lie within rounding of a bf16 boundary may
# round apart, and each output gets the step's effect through them added
# to its bound (`bwd_flip_allowance`); the run prints how many entries
# that is. Planted faults (a key tile, a slot range or a RoPE head left out)
# must fail this check; the run also says whether the looser
# tol * (1 + |plain|) bound of earlier runs would have caught them.
TOL_BF16 = 2e-2
TOL_ROPE_BF16 = 8e-3
TOL = {("rope2d", torch.float32): 1e-5,
       ("rope2d", torch.bfloat16): TOL_ROPE_BF16,
       ("sdpa", torch.float32): 1e-4, ("memory_read", torch.float32): 1e-4,
       ("sdpa_bwd", torch.float32): 1e-4, ("rope2d_bwd", torch.float32): 1e-5,
       ("rope2d_bwd", torch.bfloat16): TOL_ROPE_BF16}
E2E_TOL = 1e-3
# the frame-at-a-time engine against the chunked run, both BF16: the
# port's bf16 bound against the JAX package (tests/test_torch_model.py
# BF16_TOL), |a - b| <= 1e-2 * (1 + |b|); the chunked run rounds its
# outputs to bf16 and encodes a chunk in one batch
ENGINE_TOL = 1e-2

# the card's published peaks (NVIDIA H100 SXM data sheet, dense): bf16
# tensor-core rate and device-memory rate, for each kernel's bound
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12   # outside the tensor cores (the fp32 paths)
PEAK_BYTES = 3.35e12

SOURCES = {
    "rope2d": ("spann3r_torch/csrc/rope2d.cu",
               "spann3r_tpu/ops/pallas_rope.py:56"),
    "sdpa": ("spann3r_torch/csrc/sdpa.cu",
             "spann3r_tpu/ops/pallas_attention.py:60"),
    "memory_read": ("spann3r_torch/csrc/memory_read.cu",
                    "spann3r_tpu/ops/pallas_memory.py:129"),
    # the backwards: K2's (fused_sdpa's _bwd, pallas_attention.py:88-91, the
    # jnp VJP) is a kernel of its own; K3's is the same kernel at sign -1
    # (pallas_rope.py:81-82)
    "sdpa_bwd": ("spann3r_torch/csrc/sdpa_bwd.cu",
                 "spann3r_tpu/ops/pallas_attention.py:60"),
    "rope2d_bwd": ("spann3r_torch/csrc/rope2d.cu",
                   "spann3r_tpu/ops/pallas_rope.py:56"),
}
BACKWARD_OF = {"sdpa_bwd": "spann3r_tpu/ops/pallas_attention.py:88-91",
               "rope2d_bwd": "spann3r_tpu/ops/pallas_rope.py:81-82"}
# the memory-read kernel also replaces the two other pallas_call sites of
# the same TPU kernel
ALSO_REPLACES = {"memory_read": ["spann3r_tpu/ops/pallas_memory.py:138",
                                 "spann3r_tpu/ops/pallas_memory.py:149"]}


def log(*args):
    print(*args, flush=True)


@functools.cache
def _spin_cycles_per_ms() -> float:
    """Clock cycles of torch.cuda._sleep per millisecond on this card."""
    torch.cuda._sleep(1000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    end.synchronize()
    return 20_000_000 / start.elapsed_time(end)


def cuda_ms(fn, loops: int = 5, min_launches: int = 50,
            min_ms: float = 2.0, max_launches: int = 800) -> float:
    """Device milliseconds per call of fn(): one CUDA-event pair around a
    loop of back-to-back calls, divided by the count, the median of
    `loops` such loops after a warm-up. A loop has at least `min_launches`
    calls, more where that is needed for `min_ms`. A spin kernel queued
    ahead of each loop holds the device while the host enqueues the loop,
    so the calls run back to back even where enqueueing one takes longer
    than running it."""
    fn()
    torch.cuda.synchronize()

    def timed_loop(n, spin_ms):
        if spin_ms > 0:
            torch.cuda._sleep(int(spin_ms * _spin_cycles_per_ms()))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(n):
            fn()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        return start.elapsed_time(end) / n, host_ms / n

    dev_ms, host_ms = timed_loop(min_launches, 0.0)
    n = min(max_launches, max(min_launches, int(min_ms / max(dev_ms, 1e-6)) + 1))
    spin = 1.5 * n * host_ms + 1.0
    return statistics.median(timed_loop(n, spin)[0] for _ in range(loops))


def bound(flops: float, nbytes: float, peak_flops: float):
    """Least time (ms) of the card for the work, and which limit binds."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def compare(name, got, want, tol, extra=0.0, unit_scale=False):
    """got against want: ok where |got - want| <= tol * (scale + |want|) +
    extra everywhere. scale is the RMS of want over each leading index (1
    with unit_scale); extra is a float or a tensor that broadcasts against
    want. Returns ok, max abs err, max rel err and the count of elements
    past the bound without extra."""
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (got - want).abs()
    scale = 1.0 if unit_scale else want.pow(2).mean(
        dim=tuple(range(1, want.dim())), keepdim=True).sqrt()
    base = tol * (scale + want.abs())
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp(min=1e-6)).max())
    ok = bool((err <= base + extra).all())
    return ok, max_abs, max_rel, int((err > base).sum())


def plain_weights(q, k, sizes, thr):
    """The memory read's final weights a (B, P, C), fp32, plain math, with
    each row's kept mass and the weights within 1e-4 of the threshold."""
    b_, p_, c_ = q.shape[0], q.shape[1], k.shape[1]
    a = torch.zeros(b_, p_, c_, device=q.device)
    kept, near = [], torch.zeros(b_, p_, c_, dtype=torch.bool, device=q.device)
    for b, size in enumerate(sizes):
        s = torch.matmul(q[b].float(), k[b, :size].float().T) / q.shape[-1] ** 0.5
        ab = torch.softmax(s, dim=-1)
        if thr > 0:
            near[b, :, :size] = (ab - thr).abs() <= 1e-4 * thr
            ab = torch.where(ab < thr, 0.0, ab)
            kept.append(ab.sum(-1, keepdim=True))
            ab = ab / (kept[-1] + 1e-12)
        a[b, :, :size] = ab
    return a, (min(float(x.min()) for x in kept) if kept else 1.0), near


def flip_allowance(q, k, v, sizes, thr):
    """The threshold flip term, on the rows (out) and slots (asum) that
    hold a weight within rounding of the threshold, 0 elsewhere, and on
    every slot's sum the shift of those rows' renormalisation: (extra for
    out, extra for asum), the term, and the count of such rows."""
    a, kept, near = plain_weights(q, k, sizes, thr)
    term = 2 * thr / kept * max(1.0, float(v.float().abs().max()))
    rows = near.any(-1, keepdim=True).float()
    shift = (rows * a).sum(1) * (2 * thr / kept)
    return ((rows * term, near.any(1).float() * term + shift), term,
            int(rows.sum()))


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
    from spann3r_torch.config import set_tf32_policy
    set_tf32_policy()
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
    from spann3r_torch.models.vit import patch_positions
    from spann3r_torch.ops import attention, memory_read, rope

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    randn = lambda *s, dtype: torch.randn(*s, generator=g, device=dev).to(dtype)
    failures = []

    def rope_qk_plain(q, k, qpos, kpos, sign=1.0):
        return (rope.rope_2d_plain(q, qpos, 100.0, sign),
                rope.rope_2d_plain(k, kpos, 100.0, sign))

    def planted(label, wrong, want, tol, extra=0.0):
        """A wrong result, planted, against the plain one: the check must
        reject it."""
        ok, max_abs, _, n_over = compare(label, wrong, want, tol, extra)
        ok_unit, _, _, n_unit = compare(label, wrong, want, tol, extra,
                                        unit_scale=True)
        log(f"[faults] {label}: max_abs={max_abs:.3e} elements past tol "
            f"{n_over} of {want.numel()}: {'MISSED' if ok else 'caught'}; "
            f"the tol*(1+|plain|) bound: {n_unit}, "
            f"{'missed' if ok_unit else 'caught'}")
        if ok:
            failures.append(f"planted fault not caught: {label}")

    def case(kernel, label, dtype, run_kernel, run_plain, main, work,
             extra=(), note="", time_it=True, run_library=None,
             library_minus=None):
        """work: (flops, bytes) the function needs on these inputs; extra:
        the added bound of each output (none by default); library_minus:
        a call whose time the library time leaves out (the forward of a
        forward + backward). Returns the case's record."""
        tol = TOL.get((kernel, dtype), TOL_BF16)
        outs_k, outs_p = run_kernel(), run_plain()
        if not isinstance(outs_k, tuple):
            outs_k, outs_p = (outs_k,), (outs_p,)
        torch.cuda.synchronize()
        ok, max_abs, max_rel, n_over = True, 0.0, 0.0, 0
        for i, (a, b) in enumerate(zip(outs_k, outs_p)):
            o, ab, rl, no = compare(f"{kernel} {label} out{i}", a, b, tol,
                                    extra[i] if extra else 0.0)
            ok, max_abs, max_rel = ok and o, max(max_abs, ab), max(max_rel, rl)
            n_over += no
        nan = float("nan")
        ms = cuda_ms(run_kernel) if time_it else nan
        pms = cuda_ms(run_plain) if time_it else nan
        lms = cuda_ms(run_library) if time_it and run_library else None
        if lms is not None and library_minus is not None:
            lms -= cuda_ms(library_minus)
        bms, bound_by = bound(*work, PEAK_BF16_FLOPS if dtype == torch.bfloat16
                              else PEAK_FP32_FLOPS)
        dt = "bf16" if dtype == torch.bfloat16 else "fp32"
        lib_s = f"{lms:.4f}" if lms is not None else "null"
        log(f"[kernels] {kernel:11s} {label:34s} {dt} max_abs={max_abs:.3e} "
            f"max_rel={max_rel:.3e} tol={tol:g}*(rms+|plain|){note} "
            f"(elements past tol: {n_over}) {'ok' if ok else 'FAIL'} "
            f"kernel_ms={ms:.4f} plain_ms={pms:.4f} library_ms={lib_s} "
            f"bound_ms={bms:.4f} ({bound_by})")
        if not ok:
            failures.append(f"{kernel} {label} {dt}")
        rec = {"max_abs_err": max_abs, "ms": ms, "plain_ms": pms,
               "bound_ms": bms, "bound_by": bound_by, "library_ms": lms,
               "shape": label}
        if main:
            src, rep = SOURCES[kernel]
            records[kernel] = {"name": kernel, "route": "cuda", "source": src,
                               "replaces": rep, **rec}
            if kernel in BACKWARD_OF:
                records[kernel]["backward_of"] = BACKWARD_OF[kernel]
            if kernel in ALSO_REPLACES:
                records[kernel]["also_replaces"] = ALSO_REPLACES[kernel]
        return rec

    # the positions as the model builds them: int32 (y, x) of the 512x384
    # patch grid, expanded over the batch with stride 0
    grid = patch_positions(HW_512[0] // 16, HW_512[1] // 16, dev)
    for dtype in (torch.bfloat16, torch.float32):
        main = dtype == torch.bfloat16
        esize = torch.finfo(dtype).bits // 8
        # K3 on q and k of one attention: encoder (16 frames, 16 heads) and
        # decoder self-attention (12 heads) as strided slices of one qkv
        # projection, sharing their positions; cross-attention with q and k
        # split from separate projections, each with its own positions
        # (768 tokens each, and a ragged 196 / 300)
        for (label, b, h, nq, nk) in (("encoder", 16, 16, 768, 768),
                                      ("decoder", 1, 12, 768, 768),
                                      ("encoder B=8", 8, 16, 768, 768),
                                      ("decoder B=8", 8, 12, 768, 768),
                                      *((f"candidates B={c}", c, 12, 768, 768)
                                        for c in CANDIDATE_BATCHES),
                                      ("decoder cross", 1, 12, 768, 768),
                                      ("cross ragged", 1, 12, 196, 300)):
            if "cross" in label:
                q, k = (randn(b, n, h, 64, dtype=dtype).transpose(1, 2)
                        for n in (nq, nk))
                qpos, kpos = (torch.randint(0, 32, (b, n, 2), generator=g,
                                            device=dev, dtype=torch.int32)
                              if nq != nk else grid[None].clone()
                              for n in (nq, nk))
            else:
                qkv = randn(b, nq, 3, h, 64, dtype=dtype).permute(2, 0, 3, 1, 4)
                q, k = qkv[0], qkv[1]
                qpos = kpos = grid[None].expand(b, -1, -1)
            pos_bytes = sum({p.data_ptr(): p.untyped_storage().nbytes()
                             for p in (qpos, kpos)}.values())
            work = (3.0 * (q.numel() + k.numel()),
                    2.0 * (q.numel() + k.numel()) * esize + pos_bytes)
            shape = f"q ({b},{h},{nq},64) k ({b},{h},{nk},64)"
            timed = "cross" not in label and "candidates" not in label
            rec = case("rope2d", f"{label} {shape}", dtype,
                       lambda: rope.rope_2d_qk_cuda(q, k, qpos, kpos),
                       lambda: rope_qk_plain(q, k, qpos, kpos),
                       main and label == "encoder", work, time_it=timed)
            if main and label == "decoder":
                rope_decoder = rec
            if main and label == "decoder B=8":
                rope_offline = rec
            if main and label == "encoder B=8":
                rope_offline_encoder = rec
            if timed:
                case("rope2d", f"{label} inverse, contiguous", dtype,
                     lambda: rope.rope_2d_qk_cuda(q.contiguous(), k.contiguous(),
                                                  qpos, kpos, sign=-1.0),
                     lambda: rope_qk_plain(q, k, qpos, kpos, -1.0),
                     False, work, time_it=False)
            if dtype == torch.bfloat16 and timed:
                # planted fault: the last head of k left unrotated
                want = rope.rope_2d_plain(k, kpos, 100.0)
                wrong = want.clone()
                wrong[:, -1] = k[:, -1]
                planted(f"rope2d {label} {shape} with the last head of k "
                        f"unrotated", wrong, want, TOL_ROPE_BF16)
        # K2: q, k, v as strided slices of a qkv projection (the decoder's
        # cross-attention reads them the same way): encoder self-attention
        # (16 frames), decoder self and cross (12 heads), value encoder
        # (16 heads), and ragged 224x224 shapes
        for (b, h, n, m, label) in ((16, 16, 768, 768, "encoder"),
                                    (1, 12, 768, 768, "decoder"),
                                    (8, 16, 768, 768, "encoder B=8"),
                                    (8, 12, 768, 768, "decoder B=8"),
                                    *((c, 12, 768, 768, f"candidates B={c}")
                                      for c in CANDIDATE_BATCHES),
                                    (1, 16, 768, 768, "value encoder"),
                                    (1, 16, 196, 196, "self N=196"),
                                    (1, 12, 196, 300, "cross N!=M")):
            q = randn(b, n, 3, h, 64, dtype=dtype).permute(2, 0, 3, 1, 4)[0]
            kv = randn(b, m, 3, h, 64, dtype=dtype).permute(2, 0, 3, 1, 4)
            k, v = kv[1], kv[2]
            work = (4.0 * b * h * n * m * 64, esize * 2.0 * b * h * (n + m) * 64)
            rec = case("sdpa", f"{label} ({b},{h},{n},{m})", dtype,
                       lambda: attention.sdpa_cuda(q, k, v, 0.125),
                       lambda: attention.sdpa_plain(q, k, v, 0.125),
                       main and b == 16, work,
                       time_it="candidates" not in label,
                       run_library=lambda: torch.nn.functional.scaled_dot_product_attention(
                           q, k, v, scale=0.125))
            if main and label == "decoder B=8":
                sdpa_offline = rec
            if main and label == "encoder B=8":
                sdpa_offline_encoder = rec
            if dtype == torch.bfloat16 and label in ("encoder", "decoder",
                                                     "encoder B=8",
                                                     "decoder B=8"):
                # planted fault: the PV of the last key tile left out
                p = torch.softmax(torch.matmul(q.float(), k.float().transpose(
                    -1, -2)) * 0.125, dim=-1).to(dtype).float()
                p[..., -64:] = 0.0
                planted(f"sdpa {label} ({b},{h},{n},{m}) without its last "
                        f"key tile", torch.matmul(p, v.float()).to(dtype),
                        attention.sdpa_plain(q, k, v, 0.125), TOL_BF16)
        # K1: 512x384 bank (P=768, C=8704, D=1024), one stream at the
        # sizes the slice reads, then two streams of unequal sizes
        p_, c_, d_ = 768, 8704, 1024
        banks = {nb: (randn(nb, p_, d_, dtype=dtype), randn(nb, c_, d_, dtype=dtype),
                      randn(nb, c_, d_, dtype=dtype)) for nb in (1, 2)}
        for sizes in ((768,), (4000,), (8704,), (768, 8704)):
            nb = len(sizes)
            q, k, v = banks[nb]
            sz = torch.tensor(sizes, dtype=torch.int32, device=dev)
            work = (4.0 * p_ * sum(sizes) * d_,
                    esize * (2.0 * nb * p_ * d_ + 2.0 * sum(sizes) * d_)
                    + 4.0 * nb * c_)
            label = ("size=" + "+".join(map(str, sizes))
                     + (f" B={nb}" if nb > 1 else ""))
            for thr in (5e-4, 0.0):
                extra, note = (), ""
                if thr > 0:
                    extra, term, rows = flip_allowance(q, k, v, sizes, thr)
                    note = f" + {term:.2e} on {rows} rows"
                case("memory_read", f"{label} thresh={thr:g}", dtype,
                     lambda: memory_read.memory_read_attention_cuda(q, k, v, sz, thr),
                     lambda: memory_read.memory_read_attention_plain(q, k, v, sz, thr),
                     main and sizes == (8704,) and thr > 0, work, extra=extra,
                     note=note)
                if dtype == torch.bfloat16 and sizes == (8704,):
                    # planted faults: the first of the readout's four slot
                    # ranges left out (whole 64-slot tiles, as the kernel
                    # splits them), and the last 64-slot tile left out
                    want = memory_read.memory_read_attention_plain(
                        q, k, v, sz, thr)[0]
                    for what, cut in (("first slot range",
                                       slice(0, 64 * ((c_ // 64 + 3) // 4))),
                                      ("last slot tile", slice(c_ - 64, c_))):
                        a = plain_weights(q, k, sizes, thr)[0]
                        a[..., cut] = 0.0
                        planted(f"memory_read size=8704 thresh={thr:g} "
                                f"without its {what}",
                                torch.matmul(a, v.float()).to(dtype), want,
                                TOL_BF16, extra[0] if extra else 0.0)
        backward_cases(case, planted, dtype, randn, records)
        head_dim_32_cases(case, planted, dtype, randn, records)
        pretrain_cases(case, planted, dtype, randn, records)
        stereoflow_cases(case, planted, dtype, randn, records)
    records["rope2d"]["decoder"] = rope_decoder
    records["rope2d"]["offline"] = rope_offline
    records["sdpa"]["offline"] = sdpa_offline
    records["rope2d"]["offline_encoder"] = rope_offline_encoder
    records["sdpa"]["offline_encoder"] = sdpa_offline_encoder
    failures += [f"sdpa_bwd allowance {label}" for label, c in
                 records["sdpa_bwd"]["allowance"].items() if not c["ok"]]
    if failures:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{failures}")


# the backwards at the training shapes (224x224: 196 tokens; encoder on
# B*T = 10 frames, decoder and value encoder on B = 2 streams) and at the
# 512x384 encoder's
BWD_SHAPES = (("train encoder", 10, 16, 196), ("train decoder", 2, 12, 196),
              ("train value encoder", 2, 16, 196), ("encoder 512", 16, 16, 768))


def sdpa_bwd_without_tails(q, k, v, dout, lse, scale):
    """sdpa_backward_plain's dq with the last 64 keys' terms left out and
    its dv with the last 64 queries' terms left out: the faults of a sweep
    that skips its last tile."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    ds = p * (dp - (p * dp).sum(-1, keepdim=True)) * scale
    ds = ds.to(q.dtype).float()
    ds[..., -64:] = 0.0
    pr = p.to(v.dtype).float()
    pr[..., -64:, :] = 0.0
    return (torch.matmul(ds, k.float()).to(q.dtype),
            torch.matmul(pr.transpose(-1, -2), dout.float()).to(q.dtype))


def bwd_flip_allowance(q, k, v, dout, lse, scale):
    """The rounding-flip term of K2's bf16 backward against
    sdpa_backward_plain: (extra for dq, dk, dv) and the count of entries
    that may flip. Both sides round P (for dv) and dS (for dq and dk) to
    bf16 from fp32 values that differ by fp32 rounding: the logits' and
    dP = dO v^T's sums in another order, exp2f of log2 units against exp,
    the row term D summed in another order. Where the interval that holds
    both fp32 values (`bwd_rounding_intervals`) spans a bf16 rounding
    boundary, the two sides may round the entry to neighbouring bf16
    values: a step that moves dv by it times |dO|, dq by it times |k| and
    dk by it times |q|. One such step of a peaked row's dS (~0.5, a step of
    2^-8) times |k| ~ 1 is 4e-3, past 2e-2 * (rms + |dq|) where dq is near
    0 (rms ~0.07 at 196 tokens): one element of 38.5 million did so at the
    v2 encoder's (64,16,196,196). The term is zero elsewhere, and in fp32,
    which rounds neither."""
    if q.dtype != torch.bfloat16:
        return (0.0, 0.0, 0.0), 0
    p, d_p, ds, d_ds = bwd_rounding_intervals(q, k, v, dout, lse, scale)

    def steps(x, dx):
        return ((x + dx).to(torch.bfloat16).float()
                - (x - dx).to(torch.bfloat16).float()).abs()

    f_ds, f_p = steps(ds, d_ds), steps(p, d_p)
    flipped = int((f_ds > 0).sum()) + int((f_p > 0).sum())
    return ((torch.matmul(f_ds, k.float().abs()),
             torch.matmul(f_ds.transpose(-1, -2), q.float().abs()),
             torch.matmul(f_p.transpose(-1, -2), dout.float().abs())),
            flipped)


def bwd_rounding_intervals(q, k, v, dout, lse, scale):
    """sdpa_backward_plain's fp32 P and dS before their rounding, each with
    the half-width of an interval that holds the kernel's value too: (P,
    wP, dS, wdS), (B, H, N, M) each. Worst-case bounds from fp32's unit
    roundoff g = 2^-24, for both sides (a sum of n terms lies within n * g
    of the sum of its terms' magnitudes): the exponent within 2 * Dh * g *
    scale * |q||k|^T + 8 * g * (|s| + |lse| + 1) (exp, exp2f and the log2
    scaling, a few ulps each), so wP = P times that; dP within wdP = 2 * Dh
    * g * |dO||v|^T; D within sum_j (wP |dP| + P wdP) + 2 * M * g * sum_j
    P |dP|; dS = scale * P (dP - D) within scale * (wP |dP - D| + P (wdP +
    wD)) + 4 * g * |dS|."""
    g = 2.0 ** -24
    dh, m = q.shape[-1], k.shape[2]
    qf, kf, vf, dof = (t.float() for t in (q, k, v, dout))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None])
    dx = torch.matmul(qf.abs(), kf.abs().transpose(-1, -2)) * (
        2 * dh * g * scale) + 8 * g * (s.abs() + lse.abs()[..., None] + 1)
    del s
    d_p = p * dx
    del dx
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    d_dp = torch.matmul(dof.abs(), vf.abs().transpose(-1, -2)) * (2 * dh * g)
    row = (p * dp).sum(-1, keepdim=True)
    d_row = ((d_p * dp.abs() + p * d_dp).sum(-1, keepdim=True)
             + 2 * m * g * (p * dp.abs()).sum(-1, keepdim=True))
    ds = p * (dp - row) * scale
    d_ds = scale * (d_p * (dp - row).abs() + p * (d_dp + d_row)) \
        + 4 * g * ds.abs()
    return p, d_p, ds, d_ds


# C2: the flip term rests on the argument above; the library's backward
# (F.scaled_dot_product_attention under autograd, which rounds P and dS to
# bf16 too) is held to the same plain bound on the same inputs, and the
# kernel may lie past the plain bound on at most ALLOWANCE_MARGIN elements
# more than the library does
ALLOWANCE_MARGIN = 4


def past_plain_bound(outs, plains, extras, tol=TOL_BF16):
    """(elements of outs past tol * (rms + |plain|), compare's bound
    without its extra; how many of them lie past the extra allowance too;
    the largest excess over the plain bound, 0 where none)."""
    n = beyond = 0
    worst = 0.0
    for got, want, extra in zip(outs, plains, extras):
        got, want = got.float(), want.float()
        scale = want.pow(2).mean(dim=tuple(range(1, want.dim())),
                                 keepdim=True).sqrt()
        over = (got - want).abs() - tol * (scale + want.abs())
        n += int((over > 0).sum())
        beyond += int((over > extra).sum())
        worst = max(worst, float(over.max()))
    return n, beyond, worst


def allowance_ok(kernel_n, library_n, margin=ALLOWANCE_MARGIN):
    return kernel_n <= library_n + margin


def allowance_census(label, q, k, v, dout, lse, scale, flip, records):
    """C2 for one bf16 backward shape: the kernel's and the library's dq,
    dk, dv against sdpa_backward_plain, each counted by past_plain_bound;
    prints one line and records it under the sdpa_bwd record's
    "allowance"."""
    import torch.nn.functional as F

    from spann3r_torch.ops import attention

    plain = attention.sdpa_backward_plain(q, k, v, dout, lse, scale)
    kern = attention.sdpa_backward_cuda(q, k, v, dout, lse, scale)
    ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    lib = torch.autograd.grad(F.scaled_dot_product_attention(
        ql, kl, vl, scale=scale), (ql, kl, vl), dout)
    kn, kb, kx = past_plain_bound(kern, plain, flip)
    ln, lb, lx = past_plain_bound(lib, plain, flip)
    ok = allowance_ok(kn, ln) and kb == 0
    log(f"[kernels] sdpa_bwd    allowance {label}: past the plain bound "
        f"{TOL_BF16:g}*(rms+|plain|): kernel {kn} (largest excess {kx:.3e}, "
        f"{kb} past the allowance), library {ln} (largest excess {lx:.3e}, "
        f"{lb} past the allowance); kernel <= library + {ALLOWANCE_MARGIN}: "
        f"{'ok' if ok else 'FAIL'}")
    records["sdpa_bwd"].setdefault("allowance", {})[label] = {
        "kernel": kn, "kernel_max_excess": kx, "library": ln,
        "library_past_allowance": lb, "library_max_excess": lx, "ok": ok}


def backward_cases(case, planted, dtype, randn, records):
    """K2's backward kernel against sdpa_backward_plain and K3 at sign -1
    on gradients against rope_2d_plain, on the card, with the layouts
    training gives them: q, k, v strided slices of a qkv projection, dO
    and the RoPE gradients (B, H, N, 64) views of (B, N, H, 64) buffers
    (what the SDPA backward and the merged heads write), lse from the
    forward kernel. The library time of K2's backward is
    F.scaled_dot_product_attention forward + backward minus its forward.
    K3 takes no RoPE in the value encoder (mem_pos_enc off). The bf16
    records of every shape go under the main record's "by_shape". The
    forwards of K2 and K3 at the training shapes, which training launches
    again when it recomputes a block, are checked and timed too; their bf16
    records go under the forward records' "train_by_shape"."""
    import torch.nn.functional as F

    from spann3r_torch.models.vit import patch_positions
    from spann3r_torch.ops import attention, rope

    main = dtype == torch.bfloat16
    esize = torch.finfo(dtype).bits // 8
    for label, b, h, n in BWD_SHAPES:
        qkv = randn(b, n, 3, h, 64, dtype=dtype).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        dout = randn(b, n, h, 64, dtype=dtype).transpose(1, 2)
        _, lse = attention.sdpa_cuda(q, k, v, 0.125, with_lse=True)
        want_lse = torch.logsumexp(torch.matmul(q.float(), k.float().transpose(
            -1, -2)) * 0.125, dim=-1)
        lse_err = float((lse - want_lse).abs().max())
        if lse_err > 1e-4 * (1.0 + float(want_lse.abs().max())):
            raise AssertionError(f"sdpa {label} logsumexp off by {lse_err}")
        if label.startswith("train"):
            rec = case(
                "sdpa", f"{label} forward ({b},{h},{n},{n})", dtype,
                lambda: attention.sdpa_cuda(q, k, v, 0.125),
                lambda: attention.sdpa_plain(q, k, v, 0.125), False,
                (4.0 * b * h * n * n * 64, esize * 4.0 * b * h * n * 64),
                run_library=lambda: F.scaled_dot_product_attention(
                    q, k, v, scale=0.125))
            if main:
                records["sdpa"].setdefault("train_by_shape", {})[label] = rec
        ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
        lib_fwd = lambda: F.scaled_dot_product_attention(ql, kl, vl, scale=0.125)
        work = (10.0 * b * h * n * n * 64,
                esize * 7.0 * b * h * n * 64 + 4.0 * b * h * n)
        shape = f"({b},{h},{n},{n})"
        flip, flipped = bwd_flip_allowance(q, k, v, dout, lse, 0.125)
        rec = case(
            "sdpa_bwd", f"{label} {shape} lse max err {lse_err:.1e}", dtype,
            lambda: attention.sdpa_backward_cuda(q, k, v, dout, lse, 0.125),
            lambda: attention.sdpa_backward_plain(q, k, v, dout, lse, 0.125),
            main and label == "train encoder", work, extra=flip,
            note=f" + flips of {flipped} P/dS entries",
            run_library=lambda: torch.autograd.grad(lib_fwd(), (ql, kl, vl),
                                                    dout),
            library_minus=lib_fwd)
        if main:
            records["sdpa_bwd"].setdefault("by_shape", {})[label] = rec
            allowance_census(f"{label} {shape}", q, k, v, dout, lse, 0.125,
                             flip, records)
            # planted faults, one in each output: dq without the last key
            # tile's terms, dk of the last key tile left out, dv without
            # the last query tile's terms
            want = attention.sdpa_backward_plain(q, k, v, dout, lse, 0.125)
            wrong_dq, wrong_dv = sdpa_bwd_without_tails(q, k, v, dout, lse,
                                                        0.125)
            wrong_dk = want[1].clone()
            wrong_dk[..., -64:, :] = 0.0
            for what, wrong, i in (
                    ("dq without its last key tile", wrong_dq, 0),
                    ("dk without its last key tile", wrong_dk, 1),
                    ("dv without its last query tile", wrong_dv, 2)):
                planted(f"sdpa_bwd {label} {shape}: {what}", wrong, want[i],
                        TOL_BF16, flip[i])
            del want, wrong_dq, wrong_dk, wrong_dv
        del flip
        if "value" in label:
            continue
        grid = (patch_positions(14, 14, q.device) if n == 196 else
                patch_positions(HW_512[0] // 16, HW_512[1] // 16, q.device))
        pos = grid[None].expand(b, -1, -1)
        if label.startswith("train"):
            work = (3.0 * (q.numel() + k.numel()),
                    2.0 * (q.numel() + k.numel()) * esize
                    + grid.untyped_storage().nbytes())
            rec = case(
                "rope2d", f"{label} forward q+k ({b},{h},{n},64)", dtype,
                lambda: rope.rope_2d_qk_cuda(q, k, pos, pos),
                lambda: (rope.rope_2d_plain(q, pos, 100.0),
                         rope.rope_2d_plain(k, pos, 100.0)), False, work)
            if main:
                records["rope2d"].setdefault("train_by_shape", {})[label] = rec
        dq, dk = (randn(b, n, h, 64, dtype=dtype).transpose(1, 2)
                  for _ in range(2))
        work = (3.0 * (dq.numel() + dk.numel()),
                2.0 * (dq.numel() + dk.numel()) * esize
                + grid.untyped_storage().nbytes())
        rec = case(
            "rope2d_bwd", f"{label} dq+dk ({b},{h},{n},64)", dtype,
            lambda: tuple(rope._launch([(dq, pos), (dk, pos)], 100.0, -1.0,
                                       counter="rope2d_bwd")),
            lambda: (rope.rope_2d_plain(dq, pos, 100.0, -1.0),
                     rope.rope_2d_plain(dk, pos, 100.0, -1.0)),
            main and label == "train encoder", work)
        if main:
            records["rope2d_bwd"].setdefault("by_shape", {})[label] = rec
            want = rope.rope_2d_plain(dk, pos, 100.0, -1.0)
            wrong = want.clone()
            wrong[:, -1] = dk[:, -1]
            planted(f"rope2d_bwd {label}: the last head of dk unrotated",
                    wrong, want, TOL_ROPE_BF16)


# K2 and its backward at head dim 32: the CroCoNet() decoder's
# self-attention (512 wide, 16 heads, 196 tokens at 224, the pretraining
# CLI's batch of 64), and as extra coverage, on no path of the port, a
# ragged 20-token tile and N != M
DH32_SHAPES = (("CroCoNet() decoder", 64, 16, 196, 196),
               ("extra: ragged", 64, 16, 20, 20),
               ("extra: N!=M", 64, 16, 20, 196))


def head_dim_32_cases(case, planted, dtype, randn, records):
    """K2 and its backward at head dim 32 against their plain versions, q,
    k and v strided slices of one packed qkv projection (so the 32 columns
    past a head's are the next head's: the kernel's loads must be masked by
    column), dO a (B, N, H, 32) view. Planted faults, bf16: the forward as
    if the logits had read 64 columns (the next head's 32 with them), its
    output's columns 16-31 a copy of 0-15, and its last key tile's PV left
    out; the backward's dq with columns 16-31 a copy of 0-15, dk with them
    left out, dv with them doubled, and the three last-tile faults of
    `backward_cases`. Records (bf16) under "head_dim_32" of the sdpa and
    sdpa_bwd records."""
    import torch.nn.functional as F

    from spann3r_torch.ops import attention

    main = dtype == torch.bfloat16
    esize = torch.finfo(dtype).bits // 8
    d, scale = 32, 32 ** -0.5
    for label, b, h, n, m in DH32_SHAPES:
        rows = max(n, m)
        buf = randn(b, rows, 3, h, d, dtype=dtype)
        qkv = buf.permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0, :, :, :n], qkv[1, :, :, :m], qkv[2, :, :, :m]
        shape = f"({b},{h},{n},{m},32)"
        rec = case("sdpa", f"head dim 32 {label} {shape}", dtype,
                   lambda: attention.sdpa_cuda(q, k, v, scale),
                   lambda: attention.sdpa_plain(q, k, v, scale), False,
                   (4.0 * b * h * n * m * d, esize * 2.0 * b * h * (n + m) * d),
                   run_library=lambda: F.scaled_dot_product_attention(
                       q, k, v, scale=scale))
        if main:
            records["sdpa"].setdefault("head_dim_32", {})[label] = rec
            want = attention.sdpa_plain(q, k, v, scale)
            # the logits over 64 columns: each head's 32 and the next 32 of
            # the projection's row (the next head, or k's first after q's
            # last, zero past the row's end)
            flat = torch.cat([buf.reshape(b, rows, -1),
                              buf.new_zeros(b, rows, d)], -1)
            wide = lambda part, r: torch.stack(
                [flat[:, :r, (part * h + i) * d:(part * h + i) * d + 2 * d]
                 for i in range(h)], 1).float()
            p = torch.softmax(torch.matmul(wide(0, n), wide(1, m).transpose(
                -1, -2)) * scale, -1).to(dtype).float()
            planted(f"sdpa head dim 32 {label} {shape}: logits over 64 "
                    f"columns", torch.matmul(p, v.float()).to(dtype), want,
                    TOL_BF16)
            dup = want.clone()
            dup[..., 16:] = want[..., :16]
            planted(f"sdpa head dim 32 {label} {shape}: columns 16-31 a copy "
                    f"of 0-15", dup, want, TOL_BF16)
            p = torch.softmax(torch.matmul(q.float(), k.float().transpose(
                -1, -2)) * scale, dim=-1).to(dtype).float()
            p[..., 64 * ((m - 1) // 64):] = 0.0
            planted(f"sdpa head dim 32 {label} {shape}: without its last key "
                    f"tile", torch.matmul(p, v.float()).to(dtype), want,
                    TOL_BF16)
        dout = randn(b, n, h, d, dtype=dtype).transpose(1, 2)
        _, lse = attention.sdpa_cuda(q, k, v, scale, with_lse=True)
        ql, kl, vl = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        lib_fwd = lambda: F.scaled_dot_product_attention(ql, kl, vl,
                                                         scale=scale)
        flip, flipped = bwd_flip_allowance(q, k, v, dout, lse, scale)
        rec = case(
            "sdpa_bwd", f"head dim 32 {label} {shape}", dtype,
            lambda: attention.sdpa_backward_cuda(q, k, v, dout, lse, scale),
            lambda: attention.sdpa_backward_plain(q, k, v, dout, lse, scale),
            False, (10.0 * b * h * n * m * d,
                    esize * (3.0 * n + 4.0 * m) * b * h * d + 4.0 * b * h * n),
            extra=flip, note=f" + flips of {flipped} P/dS entries",
            run_library=lambda: torch.autograd.grad(lib_fwd(), (ql, kl, vl),
                                                    dout),
            library_minus=lib_fwd)
        if main:
            records["sdpa_bwd"].setdefault("head_dim_32", {})[label] = rec
            allowance_census(f"head dim 32 {label} {shape}", q, k, v, dout,
                             lse, scale, flip, records)
            want = attention.sdpa_backward_plain(q, k, v, dout, lse, scale)
            wrong_dq, wrong_dv = sdpa_bwd_without_tails(q, k, v, dout, lse,
                                                        scale)
            wrong_dk = want[1].clone()
            wrong_dk[..., -64:, :] = 0.0
            faults = [("dq without its last key tile", wrong_dq, 0),
                      ("dk without its last key tile", wrong_dk, 1),
                      ("dv without its last query tile", wrong_dv, 2)]
            for i, (what, fill) in enumerate((
                    ("columns 16-31 a copy of 0-15", lambda g: g[..., :16]),
                    ("columns 16-31 left out", lambda g: 0.0),
                    ("columns 16-31 doubled", lambda g: 2 * g[..., 16:]))):
                wrong = want[i].clone()
                wrong[..., 16:] = fill(want[i])
                faults.append((f"{'dq dk dv'.split()[i]} with {what}", wrong,
                               i))
            for what, wrong, i in faults:
                planted(f"sdpa_bwd head dim 32 {label} {shape}: {what}",
                        wrong, want[i], TOL_BF16, flip[i])
            del want, wrong_dq, wrong_dk, wrong_dv
        del flip


# the pretraining path's other attention shapes (phase 13's two
# configurations at 224, B = 64, mask ratio 0.9: 20 visible tokens of 196):
# (label, B, H, N, M, head dim, layout, RoPE). CroCoNet() (cosine
# positions): the encoder, 768 wide with 12 heads, on the visible tokens and
# on image 2's, and the decoder's cross-attention, 512 wide with 16 heads
# (its self-attention is DH32_SHAPES' first). The v2 ViT-L / Base decoder
# (RoPE100): the encoder, 1024 wide with 16 heads, and the decoder, 768 wide
# with 12 heads, self and cross. "self": q, k, v strided slices of one qkv
# projection; "cross": q, k, v (B, N, H, Dh) views of separate projections;
# with RoPE, K3 rotates q and k first (the visible tokens at the positions
# the mask gathers) and K2 takes its outputs
PRETRAIN_SHAPES = (
    ("CroCoNet() encoder visible", 64, 12, 20, 20, 64, "self", False),
    ("CroCoNet() encoder", 64, 12, 196, 196, 64, "self", False),
    ("CroCoNet() decoder cross", 64, 16, 196, 196, 32, "cross", False),
    ("v2 encoder visible", 64, 16, 20, 20, 64, "self", True),
    ("v2 encoder", 64, 16, 196, 196, 64, "self", True),
    ("v2 decoder self", 64, 12, 196, 196, 64, "self", True),
    ("v2 decoder cross", 64, 12, 196, 196, 64, "cross", True))


def sdpa_unmasked_padding(q, k, v, scale):
    """sdpa_plain as if the keys that pad the last key tile to 64 counted,
    each with a zero logit and a zero value: the fault of a ragged tile
    whose padding is not masked."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    pad = -k.shape[2] % 64
    p = torch.softmax(torch.cat([s, s.new_zeros(*s.shape[:-1], pad)], -1), -1)
    return torch.matmul(p[..., :k.shape[2]].to(v.dtype).float(),
                        v.float()).to(v.dtype)


def pretrain_cases(case, planted, dtype, randn, records):
    """K3 (with RoPE), K2 and their backwards at PRETRAIN_SHAPES against
    their plain versions, in the layouts the pretraining path gives them;
    the visible tokens' positions gathered from the patch grid as
    `croco_forward` gathers them under a `random_mask` (`path_cases` holds
    each shape). Timed in bf16, the path's type under --amp 1; records
    (bf16) under "pretrain_by_shape"."""
    from spann3r_torch.models.croco_pretrain import random_mask
    from spann3r_torch.models.vit import patch_positions

    grid = patch_positions(14, 14, torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    for label, b, h, n, m, d, layout, with_rope in PRETRAIN_SHAPES:
        full = grid[None].expand(b, -1, -1)
        gathered = None
        if n < 196:
            mask = random_mask(gen, b, 196, 0.9, "cuda")
            order = torch.argsort(mask.to(torch.int32), dim=1, stable=True)
            qpos = torch.take_along_dim(full, order[:, :n, None], dim=1)
            gathered = full[:, :n]
        else:
            qpos = full
        kpos = qpos if layout == "self" else full
        path_cases(case, planted, dtype, randn, records, "pretrain",
                   (label, b, h, n, m, d, layout, with_rope), qpos, kpos,
                   ungathered=gathered)


def path_cases(case, planted, dtype, randn, records, path, shape_rec, qpos,
               kpos, backward=True, ungathered=None):
    """One attention shape of a training path: K3 on q and k (with RoPE),
    K2 on its outputs, K2's backward and K3's backward against their plain
    versions, in the path's layout ("self": q, k, v strided slices of one
    qkv projection; "cross": (B, N, H, Dh) views of separate projections)
    at the positions given. Planted faults, bf16: K3 with the last head of
    k unrotated (and, where `ungathered` is given, at those positions, not
    the gathered ones), its backward rotating forward and leaving the last
    head of dk unrotated; K2 counting the padding keys of its last tile and
    without its last key tile; its backward's three last-tile faults of
    `backward_cases`. `backward` False holds the forwards only (an
    inference path). Records (bf16) under "<path>_by_shape"."""
    import torch.nn.functional as F

    from spann3r_torch.ops import attention, rope

    label, b, h, n, m, d, layout, with_rope = shape_rec
    main = dtype == torch.bfloat16
    esize = torch.finfo(dtype).bits // 8
    key = f"{path}_by_shape"
    shape = f"({b},{h},{n},{m},{d})"
    scale = d ** -0.5
    if layout == "self":
        qkv = randn(b, n, 3, h, d, dtype=dtype).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
    else:
        q = randn(b, n, h, d, dtype=dtype).transpose(1, 2)
        k, v = (randn(b, m, h, d, dtype=dtype).transpose(1, 2)
                for _ in range(2))
    pos_bytes = sum({t.untyped_storage().data_ptr():
                     t.untyped_storage().nbytes()
                     for t in (qpos, kpos)}.values())
    if with_rope:
        work = (3.0 * (q.numel() + k.numel()),
                2.0 * (q.numel() + k.numel()) * esize + pos_bytes)
        rec = case("rope2d", f"{path} {label} q+k {shape}", dtype,
                   lambda: rope.rope_2d_qk_cuda(q, k, qpos, kpos),
                   lambda: (rope.rope_2d_plain(q, qpos, 100.0),
                            rope.rope_2d_plain(k, kpos, 100.0)),
                   False, work, time_it=main)
        if main:
            records["rope2d"].setdefault(key, {})[label] = rec
            want = rope.rope_2d_plain(k, kpos, 100.0)
            wrong = want.clone()
            wrong[:, -1] = k[:, -1]
            planted(f"rope2d {path} {label}: the last head of k unrotated",
                    wrong, want, TOL_ROPE_BF16)
            if ungathered is not None:
                want = rope.rope_2d_plain(q, qpos, 100.0)
                planted(f"rope2d {path} {label}: the first {n} positions, "
                        f"not the gathered ones",
                        rope.rope_2d_plain(q, ungathered, 100.0), want,
                        TOL_ROPE_BF16)
        q, k = rope.rope_2d_qk_cuda(q, k, qpos, kpos)
    rec = case("sdpa", f"{path} {label} {shape}", dtype,
               lambda: attention.sdpa_cuda(q, k, v, scale),
               lambda: attention.sdpa_plain(q, k, v, scale), False,
               (4.0 * b * h * n * m * d, esize * 2.0 * b * h * (n + m) * d),
               time_it=main, run_library=lambda: F.scaled_dot_product_attention(
                   q, k, v, scale=scale))
    if main:
        records["sdpa"].setdefault(key, {})[label] = rec
        want = attention.sdpa_plain(q, k, v, scale)
        planted(f"sdpa {path} {label} {shape}: the padding keys of the last "
                f"tile counted", sdpa_unmasked_padding(q, k, v, scale), want,
                TOL_BF16)
        p = torch.softmax(torch.matmul(q.float(), k.float().transpose(
            -1, -2)) * scale, dim=-1).to(dtype).float()
        p[..., 64 * ((m - 1) // 64):] = 0.0
        planted(f"sdpa {path} {label} {shape}: without its last key tile",
                torch.matmul(p, v.float()).to(dtype), want, TOL_BF16)
        del want, p
    if not backward:
        return
    dout = randn(b, n, h, d, dtype=dtype).transpose(1, 2)
    _, lse = attention.sdpa_cuda(q, k, v, scale, with_lse=True)
    ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    lib_fwd = lambda: F.scaled_dot_product_attention(ql, kl, vl, scale=scale)
    flip, flipped = bwd_flip_allowance(q, k, v, dout, lse, scale)
    rec = case(
        "sdpa_bwd", f"{path} {label} {shape}", dtype,
        lambda: attention.sdpa_backward_cuda(q, k, v, dout, lse, scale),
        lambda: attention.sdpa_backward_plain(q, k, v, dout, lse, scale),
        False, (10.0 * b * h * n * m * d,
                esize * (3.0 * n + 4.0 * m) * b * h * d + 4.0 * b * h * n),
        extra=flip, note=f" + flips of {flipped} P/dS entries", time_it=main,
        run_library=lambda: torch.autograd.grad(lib_fwd(), (ql, kl, vl), dout),
        library_minus=lib_fwd)
    if main:
        records["sdpa_bwd"].setdefault(key, {})[label] = rec
        allowance_census(f"{path} {label} {shape}", q, k, v, dout, lse, scale,
                         flip, records)
        want = attention.sdpa_backward_plain(q, k, v, dout, lse, scale)
        wrong_dq, wrong_dv = sdpa_bwd_without_tails(q, k, v, dout, lse, scale)
        wrong_dk = want[1].clone()
        wrong_dk[..., -64:, :] = 0.0
        for what, wrong, i in (
                ("dq without its last key tile", wrong_dq, 0),
                ("dk without its last key tile", wrong_dk, 1),
                ("dv without its last query tile", wrong_dv, 2)):
            planted(f"sdpa_bwd {path} {label} {shape}: {what}", wrong,
                    want[i], TOL_BF16, flip[i])
        del want, wrong_dq, wrong_dk, wrong_dv
    del flip
    if not with_rope:
        return
    dq = randn(b, n, h, d, dtype=dtype).transpose(1, 2)
    dk = randn(b, m, h, d, dtype=dtype).transpose(1, 2)
    work = (3.0 * (dq.numel() + dk.numel()),
            2.0 * (dq.numel() + dk.numel()) * esize + pos_bytes)
    rec = case(
        "rope2d_bwd", f"{path} {label} dq+dk {shape}", dtype,
        lambda: tuple(rope._launch([(dq, qpos), (dk, kpos)], 100.0, -1.0,
                                   counter="rope2d_bwd")),
        lambda: (rope.rope_2d_plain(dq, qpos, 100.0, -1.0),
                 rope.rope_2d_plain(dk, kpos, 100.0, -1.0)), False, work,
        time_it=main)
    if main:
        records["rope2d_bwd"].setdefault(key, {})[label] = rec
        want = rope.rope_2d_plain(dk, kpos, 100.0, -1.0)
        wrong = want.clone()
        wrong[:, -1] = dk[:, -1]
        planted(f"rope2d_bwd {path} {label}: the last head of dk unrotated",
                wrong, want, TOL_ROPE_BF16)
        planted(f"rope2d_bwd {path} {label}: dk rotated forward",
                rope.rope_2d_plain(dk, kpos, 100.0, 1.0), want,
                TOL_ROPE_BF16)


# the stereo and flow finetuning path's attention shapes (phase 15's two
# published configurations, the CroCo v2 ViT-L / Base decoder with
# RoPE100): (label, B, H, N, M, head dim, layout, RoPE). CroCo-Stereo trains
# at a 352x704 crop, a 22x44 patch grid (968 = 15 * 64 + 8 tokens: a ragged
# 8-row tile), B = 6 pairs: the encoder on both images (2B = 12, 16 heads),
# the decoder (12 heads) self and cross on image 1's; CroCo-Flow at
# 320x384, a 20x24 grid (480 tokens), B = 8; the tiled test at the stereo
# crop in chunks of tile_batch = 8 (forward only). Positions: the grid's,
# stride 0 over the batch
STEREOFLOW_GRID = {968: (22, 44), 480: (20, 24)}
STEREOFLOW_SHAPES = (
    ("stereo encoder", 12, 16, 968, 968, 64, "self", True),
    ("stereo decoder self", 6, 12, 968, 968, 64, "self", True),
    ("stereo decoder cross", 6, 12, 968, 968, 64, "cross", True),
    ("flow encoder", 16, 16, 480, 480, 64, "self", True),
    ("flow decoder self", 8, 12, 480, 480, 64, "self", True),
    ("flow decoder cross", 8, 12, 480, 480, 64, "cross", True),
    ("tiled encoder", 16, 16, 968, 968, 64, "self", True),
    ("tiled decoder self", 8, 12, 968, 968, 64, "self", True),
    ("tiled decoder cross", 8, 12, 968, 968, 64, "cross", True))


def stereoflow_cases(case, planted, dtype, randn, records):
    """K3, K2 and (but for the tiled test's) their backwards at
    STEREOFLOW_SHAPES (`path_cases`); records (bf16) under
    "stereoflow_by_shape"."""
    from spann3r_torch.models.vit import patch_positions

    for shape_rec in STEREOFLOW_SHAPES:
        label, b, _, n = shape_rec[:4]
        pos = patch_positions(*STEREOFLOW_GRID[n], torch.device("cuda"))[
            None].expand(b, -1, -1)
        path_cases(case, planted, dtype, randn, records, "stereoflow",
                   shape_rec, pos, pos,
                   backward=not label.startswith("tiled"))


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


def check_preds(label, preds, t, hw):
    """The reference contract of t frames: preds[0] {'pts3d', 'conf'}, the
    rest {'pts3d_in_other_view', 'conf'}, (1, H, W, 3) and (1, H, W),
    finite, conf >= 1."""
    h, w = hw
    if len(preds) != t:
        raise AssertionError(f"{label}: expected {t} preds, got {len(preds)}")
    for i, pr in enumerate(preds):
        key = "pts3d" if i == 0 else "pts3d_in_other_view"
        if set(pr) != {key, "conf"}:
            raise AssertionError(f"{label}: pred {i} keys {sorted(pr)}")
        if pr[key].shape != (1, h, w, 3) or pr["conf"].shape != (1, h, w):
            raise AssertionError(f"{label}: pred {i} shapes {pr[key].shape} "
                                 f"{pr['conf'].shape}")
        if not (np.isfinite(pr[key]).all() and np.isfinite(pr["conf"]).all()):
            raise AssertionError(f"{label}: pred {i} is not finite")
        if not (pr["conf"] >= 1.0).all():
            raise AssertionError(f"{label}: pred {i} has conf < 1")


def build_model():
    """The full-width model on the card, random weights from SEED."""
    from spann3r_torch import config
    from spann3r_torch.models import spann3r as sp

    cfg = config.Spann3RConfig()
    t0 = time.perf_counter()
    model = sp.build_spann3r(cfg, "cuda", torch.Generator().manual_seed(SEED))
    log(f"[model] Spann3RConfig() built in {time.perf_counter() - t0:.1f} s, "
        f"{sum(p.numel() for p in model.parameters())} params")
    return cfg, model


def phase_slice(records, cfg, model, card, profile_out=None):
    from spann3r_torch import api, config
    from spann3r_torch.models import memory as mem_mod
    from spann3r_torch.models import spann3r as sp
    from spann3r_torch.ops import _kernels, rope

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

    # K3 calls by stage: the encoder rotates a chunk of frames (B > 1), the
    # decoder one frame
    rope_calls = {"encoder": 0, "decoder": 0}
    orig_rope = rope._launch

    def tallying_rope(ops, *a, **kw):
        rope_calls["encoder" if ops[0][0].shape[0] > 1 else "decoder"] += 1
        return orig_rope(ops, *a, **kw)

    mem_mod.memory_prune = counting_prune
    sp.InferenceEngine.run_video = run_video_recording
    rope._launch = tallying_rope
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
        rope._launch = orig_rope
    log(f"[slice] launches {counts} memory_reads={reads['memory_reads']} "
        f"rope2d by stage {rope_calls} prunes={prunes['n']} final bank "
        f"size={reads['size']} wm={reads['wm']} lm={reads['lm']}")

    h, w = HW_512
    if order != list(range(FRAMES_512)):
        raise AssertionError(f"streaming frame order {order}")
    check_preds("slice", preds, FRAMES_512, HW_512)
    for name in _kernels.KERNELS:
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the main path")
    if counts["memory_read"] != reads["memory_reads"]:
        raise AssertionError(f"memory_read launches {counts['memory_read']} != "
                             f"memory reads {reads['memory_reads']}")
    # one K3 launch per attention with RoPE: every encoder block once per
    # chunk, every block of both decoders twice (self and cross) per frame
    # after the first
    chunks = -(-FRAMES_512 // 16)
    want = (cfg.dust3r.enc.depth * chunks
            + cfg.dust3r.dec.depth * 2 * 2 * (FRAMES_512 - 1))
    if counts["rope2d"] != want or sum(rope_calls.values()) != want:
        raise AssertionError(f"rope2d launches {counts['rope2d']} (by stage "
                             f"{rope_calls}), expected {want}")
    mcfg = cfg.memory
    p_tokens = (h // 16) * (w // 16)
    if prunes["n"] < 1:
        raise AssertionError("the bank was never pruned")
    log(f"[slice] preds ok: {len(preds)} x (1,{h},{w},3) finite, conf >= 1; "
        f"lm after prunes follows long_mem_size - wm*P = "
        f"{mcfg.long_mem_size - reads['wm'] * p_tokens} (+k*P)")
    records["rope2d"]["launches_per_run_encoder"] = rope_calls["encoder"]
    records["rope2d"]["decoder"]["launches_per_run"] = rope_calls["decoder"]
    for name in _kernels.KERNELS:
        rec = records[name]
        rec["launches"] = rec["launches_per_run"] = counts[name]
        lib_s = f"{rec['library_ms']:.4f}" if rec["library_ms"] is not None \
            else "null"
        log(f"[kernels] {name:11s} record {rec['shape']}: kernel_ms="
            f"{rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} library_ms={lib_s}"
            f" bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']}) "
            f"launches_per_run={counts[name]}")
    dec = records["rope2d"]["decoder"]
    log(f"[kernels] rope2d      record {dec['shape']}: kernel_ms="
        f"{dec['ms']:.4f} plain_ms={dec['plain_ms']:.4f} library_ms=null "
        f"bound_ms={dec['bound_ms']:.4f} ({dec['bound_by']}) "
        f"launches_per_run={dec['launches_per_run']} (encoder "
        f"{rope_calls['encoder']})")

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
    if profile_out:
        write_profile(f"one 512x384 BF16 {FRAMES_512}-frame run",
                      lambda: api.reconstruct_video(model, cfg, frames,
                                                    config.BF16, chunk=16),
                      FRAMES_512 / statistics.median(fps) * 1e3, card,
                      profile_out)


def device_profile(run):
    """One call of run() under torch.profiler: (device busy ms, the union
    of the kernel intervals; profiled wall ms; {kernel name: (ms,
    launches)}; device events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch_profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    spans = []
    for e in dev_events:
        tot, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us() / 1e3, cnt + 1)
        spans.append((e.time_range.start, e.time_range.end))
    spans.sort()
    busy_us, cur_s, cur_e = 0.0, None, None
    for a, b in spans:
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    return busy_us / 1e3, prof_wall_ms, by_name, len(dev_events)


def write_profile(what, run, wall_ms, card, out):
    """One run under torch.profiler: device time and launches by kernel
    name, and the union of the device intervals against the profiled run's
    wall and against `wall_ms`, the unprofiled median wall."""
    busy_ms, prof_wall_ms, by_name, n_events = device_profile(run)
    lines = [f"profile of {what} on {card}",
             f"device events {n_events}, busy (union) {busy_ms:.3f} ms,"
             f" profiled wall {prof_wall_ms:.3f} ms (busy "
             f"{busy_ms / prof_wall_ms:.3f}), unprofiled median wall "
             f"{wall_ms:.3f} ms (busy {busy_ms / wall_ms:.3f}, idle "
             f"{1 - busy_ms / wall_ms:.3f})", "ms\tlaunches\tkernel"]
    for name, (tot, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        lines.append(f"{tot:.3f}\t{cnt}\t{name}")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        f.write("\n".join(lines) + "\n")
    for ln in lines[:2] + lines[3:28]:
        log(f"[profile] {ln[:200]}")


# ---------------------------------------------------------------------------
# phases 5-7: offline mode, the frame-at-a-time engine, the serving modes
# ---------------------------------------------------------------------------

def offline_launches(cfg, n, n_pairs, chunk=8):
    """Kernel launches of one offline reconstruction of n frames over
    n_pairs pairs: K3 and K2 by stage, K1 in all. The encoder runs once on
    all n frames; a decode (both decoders, self and cross attention in
    every block) runs per pairwise chunk, for the first pair, and twice a
    greedy round (candidate scoring, then the chosen pair); the value
    encoder after each pair (RoPE there only with mem_pos_enc); one memory
    read a round."""
    rounds = n - 2
    decodes = -(-n_pairs // chunk) + 1 + 2 * rounds
    dec = 4 * cfg.dust3r.dec.depth
    val = cfg.value_enc_depth * (1 + rounds)
    return {"rope2d": {"encoder": cfg.dust3r.enc.depth, "decoder": dec * decodes,
                       "value encoder": val if cfg.mem_pos_enc else 0},
            "sdpa": {"encoder": cfg.dust3r.enc.depth, "decoder": dec * decodes,
                     "value encoder": val},
            "memory_read": rounds}


class ShapeTally:
    """Counts K3 and K2 launches by the (batch, heads) of their first
    operand while it is entered."""

    def __enter__(self):
        from spann3r_torch.ops import attention, rope
        self.mods = (rope, attention)
        self.orig = (rope._launch, attention.sdpa_cuda)
        self.counts = {"rope2d": {}, "sdpa": {}}

        def add(kernel, t):
            key = tuple(t.shape[:2])
            self.counts[kernel][key] = self.counts[kernel].get(key, 0) + 1

        def rope_launch(ops, *a, **kw):
            add("rope2d", ops[0][0])
            return self.orig[0](ops, *a, **kw)

        def sdpa_cuda(q, *a, **kw):
            add("sdpa", q)
            return self.orig[1](q, *a, **kw)

        rope._launch, attention.sdpa_cuda = rope_launch, sdpa_cuda
        return self

    def __exit__(self, *exc):
        self.mods[0]._launch, self.mods[1].sdpa_cuda = self.orig

    def by_stage(self, kernel, cfg, n):
        """Launches by stage: the decoders have their own head count; of
        the rest, the encoder runs on all n frames, the value encoder on
        one."""
        out = {"encoder": 0, "decoder": 0, "value encoder": 0}
        for (b, h), c in self.counts[kernel].items():
            stage = ("decoder" if h == cfg.dust3r.dec.num_heads else
                     "encoder" if b == n else "value encoder")
            out[stage] += c
        return out


def phase_offline(records, cfg, model, card, profile_out=None):
    from spann3r_torch import api, config
    from spann3r_torch.models.pairs import make_pairs
    from spann3r_torch.ops import _kernels

    n = FRAMES_OFFLINE
    frames = make_frames(n, HW_512, seed=SEED + 2).astype(np.float32)
    frames = frames / 127.5 - 1.0
    run = lambda: api.reconstruct_video(model, cfg, frames, config.BF16,
                                        offline=True, scene_graph="complete")
    with ShapeTally() as tally:
        torch.cuda.synchronize()
        _kernels.reset_launches()
        preds, order, _ = run()
        torch.cuda.synchronize()
        counts = _kernels.launch_counts()
    check_preds("offline", preds, n, HW_512)
    if sorted(order) != list(range(n)):
        raise AssertionError(f"offline frame order {order} is not a "
                             f"permutation of 0..{n - 1}")
    want = offline_launches(cfg, n, len(make_pairs(n, "complete")))
    stages = {k: tally.by_stage(k, cfg, n) for k in ("rope2d", "sdpa")}
    log(f"[offline] {n} frames 512x384 BF16, complete graph: order {order}; "
        f"launches {counts}; by stage {stages}; by (batch, heads) "
        f"{tally.counts}")
    for k in ("rope2d", "sdpa"):
        if stages[k] != want[k] or counts[k] != sum(want[k].values()):
            raise AssertionError(f"offline {k} launches {counts[k]} by stage "
                                 f"{stages[k]}, expected {want[k]}")
    if counts["memory_read"] != want["memory_read"]:
        raise AssertionError(f"offline memory_read launches "
                             f"{counts['memory_read']}, expected "
                             f"{want['memory_read']}")
    # the pairwise scan's decoder chunks of 8, and the encoder on all n
    for field, key in (("offline", (8, cfg.dust3r.dec.num_heads)),
                       ("offline_encoder", (n, cfg.dust3r.enc.num_heads))):
        for name in ("rope2d", "sdpa"):
            rec = records[name][field]
            rec["launches_per_run"] = tally.counts[name].get(key, 0)
            lib_s = ("null" if rec["library_ms"] is None
                     else f"{rec['library_ms']:.4f}")
            log(f"[kernels] {name:11s} record {rec['shape']}: kernel_ms="
                f"{rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} library_ms="
                f"{lib_s} bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']}) "
                f"launches_per_run={rec['launches_per_run']} (offline run)")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    log(f"[offline] preds ok: {n} x (1,{HW_512[0]},{HW_512[1]},3) finite, "
        f"conf >= 1; wall per clip median {statistics.median(walls):.3f} ms "
        f"over 3 runs after a first one {[round(x, 3) for x in walls]}")
    if profile_out:
        root, ext = os.path.splitext(profile_out)
        write_profile(f"one 512x384 BF16 {n}-frame offline run", run,
                      statistics.median(walls), card,
                      f"{root}_offline{ext or '.txt'}")


def phase_engine(cfg, model):
    """The frame-at-a-time engine against the chunked run on 8 frames."""
    from spann3r_torch import config
    from spann3r_torch.models import spann3r as sp
    from spann3r_torch.ops import _kernels

    n = FRAMES_ENGINE
    frames = make_frames(n, HW_512, seed=SEED + 3)
    engine = sp.InferenceEngine(model, cfg, HW_512, config.BF16)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    out = engine.run(frames)
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    preds = [{k: v.float().cpu().numpy() for k, v in p.items()} for p in out]
    check_preds("engine", preds, n, HW_512)
    if not counts["memory_read"] == engine.stats["memory_reads"] == n - 2 \
            or min(counts[k] for k in _kernels.KERNELS) <= 0:
        raise AssertionError(f"engine launches {counts}, memory reads "
                             f"{engine.stats['memory_reads']}")
    video = sp.InferenceEngine(model, cfg, HW_512, config.BF16).run_video(frames)
    worst, ratio = 0.0, 0.0
    for i, (a, b) in enumerate(zip(preds, video)):
        for k in b:
            err = np.abs(a[k] - b[k])
            worst = max(worst, float(err.max()))
            ratio = max(ratio, float((err / (ENGINE_TOL * (1 + np.abs(b[k]))))
                                     .max()))
    log(f"[engine] run (a frame at a time) vs run_video, {n} frames 512x384 "
        f"BF16: launches {counts}; max abs diff {worst:.3e}, "
        f"{ratio:.3f} of the bound {ENGINE_TOL}*(1+|run_video|)")
    if ratio > 1.0:
        raise AssertionError("engine run disagrees with run_video")


def phase_serving(cfg, model, card):
    """The slice under the serving settings, against the plain BF16 one."""
    import copy

    from spann3r_torch import api, config
    from spann3r_torch.ops import quant

    frames = make_frames(FRAMES_512, HW_512)

    def run(m, prec):
        return api.reconstruct_video(m, cfg, frames, prec, chunk=16)[0]

    def wall_ms(m, prec):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(m, prec)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def measure(label, m, prec):
        """Preds of a first run, then walls of 3 runs taken in turns with 3
        plain BF16 runs (P S S P P S; the host's pace drifts within a call),
        and one profiled run."""
        preds = run(m, prec)
        check_preds(f"serving {label}", preds, FRAMES_512, HW_512)
        walls = {"P": [], "S": []}
        for who in "PSSPPS":
            walls[who].append(wall_ms(*((model, config.BF16) if who == "P"
                                        else (m, prec))))
        busy, _, by_name, _ = device_profile(lambda: run(m, prec))
        cast = [(ms, c) for name, (ms, c) in by_name.items()
                if "copy" in name.lower()]
        return preds, (f"device busy {busy:.3f} ms per run, copy kernels "
                       f"{sum(x[0] for x in cast):.3f} ms "
                       f"({sum(x[1] for x in cast)} launches), wall median "
                       f"{statistics.median(walls['S']):.3f} ms "
                       f"{[round(x, 3) for x in walls['S']]} against plain "
                       f"BF16 {statistics.median(walls['P']):.3f} ms "
                       f"{[round(x, 3) for x in walls['P']]} in turns")

    def diff(preds, ref):
        """max |a - b| and the median of |a - b| / mean|b| of the
        pointmaps."""
        rel, worst = [], 0.0
        for a, b in zip(preds, ref):
            for k in b:
                worst = max(worst, float(np.abs(a[k] - b[k]).max()))
                if k != "conf":
                    rel.append((np.abs(a[k] - b[k]) / np.abs(b[k]).mean()).ravel())
        return worst, float(np.median(np.concatenate(rel)))

    plain, line = measure("bf16", model, config.BF16)
    run_to_run = diff(run(model, config.BF16), plain)[0]
    log(f"[serving] plain BF16: {line}; two plain runs differ by at most "
        f"{run_to_run:.3e}")
    # the port's TF32 policy is off; what TF32 on (the fp32 DPT heads'
    # convolutions and the fp32 products) would change in the pointmaps
    try:
        config.set_tf32_policy(True)
        tf32 = run(model, config.BF16)
    finally:
        config.set_tf32_policy()
    worst, rel = diff(tf32, plain)
    log(f"[serving] TF32 on: vs the TF32-off slice max abs diff "
        f"{worst:.3e}, median rel pts3d diff {rel:.3e} ({FRAMES_512} frames "
        f"512x384 BF16; two TF32-off runs differ by {run_to_run:.3e}) on "
        f"{card}")
    settings = (
        ("cast_serving_weights_", lambda: quant.cast_serving_weights_(
            copy.deepcopy(model)), config.BF16),
        ("BF16_FAST", lambda: model, config.BF16_FAST),
        ("int8 weight-only", lambda: quant.quantize_linear_weights_(
            copy.deepcopy(model)), config.BF16),
        ("int8 weights + activations", lambda: quant.quantize_linear_weights_(
            copy.deepcopy(model), act_min_rows=quant.INT8_ACT_ROWS),
         config.BF16))
    for label, make, prec in settings:
        m = make()
        preds, line = measure(label, m, prec)
        worst, rel = diff(preds, plain)
        log(f"[serving] {label}: {quant.count_quantized(m)} int8 matrices; "
            f"{FRAMES_512} preds finite, conf >= 1; vs plain BF16 max abs "
            f"diff {worst:.3e}, median rel pts3d diff {rel:.3e}; {line} on "
            f"{card}")
        if label.startswith("int8") and quant.count_quantized(m) == 0:
            raise AssertionError(f"{label}: no matrix was quantised")
        if label == "cast_serving_weights_" and worst > run_to_run:
            raise AssertionError(
                f"bf16-stored weights changed the outputs by {worst:.3e}, "
                f"more than two plain runs differ ({run_to_run:.3e})")
        if m is not model:
            del m
            torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 8: the entry points
# ---------------------------------------------------------------------------

def missing_host_packages():
    """Which of the image packages the datasets and PnP import (PIL, cv2)
    this host lacks."""
    import importlib.util
    return [m for m in ("PIL", "cv2") if importlib.util.find_spec(m) is None]


def boxroom_batch(n, hw, seed=SEED):
    """One collated scene {'img', 'pts3d', 'valid_mask', 'camera_pose'},
    each (n, 1, ...), from BoxRoomBackend renders at hw: a camera orbiting
    a target in a checkerboard room, images normalised to [-1, 1], world
    points from the exact depth and pose. numpy only: the views of
    SynthRoom without its PIL resampling."""
    from spann3r_torch.habitat_gen.backends import BoxRoomBackend
    from spann3r_torch.habitat_gen.geometry import (
        UP, compute_camera_intrinsics, compute_camera_pose_opencv_convention,
        look_at_for_habitat)
    from spann3r_torch.utils.geometry import (
        depthmap_to_absolute_camera_coordinates)

    h, w = hw
    rng = np.random.default_rng(seed)
    backend = BoxRoomBackend(resolution=hw, hfov=60.0, size=(6.0, 3.0, 7.0),
                             checker=0.6, seed=seed)
    f, cu, cv = compute_camera_intrinsics(h, w, 60.0)
    k = np.array([[f, 0, cu], [0, f, cv], [0, 0, 1]], np.float32)
    target = np.array([3.0, 1.5, -3.5])
    theta0 = rng.uniform(0.0, 2 * np.pi)
    out = {"img": [], "pts3d": [], "valid_mask": [], "camera_pose": []}
    for t in np.linspace(0.0, 1.0, n):
        ang = theta0 + np.deg2rad(90.0) * t
        eye = np.array([target[0] + 1.5 * np.cos(ang), 1.4 + 0.3 * t,
                        target[2] + 1.5 * np.sin(ang)])
        orientation, _ = look_at_for_habitat(eye, target, UP)
        obs = backend.render(eye, orientation)
        r, tr = compute_camera_pose_opencv_convention(eye, orientation)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3], pose[:3, 3] = r, tr
        pts, valid = depthmap_to_absolute_camera_coordinates(obs["depth"], k,
                                                             pose)
        out["img"].append((obs["color"].astype(np.float32) / 255.0 - 0.5) / 0.5)
        out["pts3d"].append(pts)
        out["valid_mask"].append(valid)
        out["camera_pose"].append(pose)
    return {key: np.stack(v)[:, None] for key, v in out.items()}


def check_bench_line(line):
    """The bench's JSON line: bench.py's keys and the card's name, FPS > 0,
    0 < mfu_pct < 100."""
    if set(line) != BENCH_KEYS:
        raise AssertionError(f"bench line keys {sorted(line)}, expected "
                             f"{sorted(BENCH_KEYS)}")
    if not line["value"] > 0:
        raise AssertionError(f"bench FPS {line['value']}")
    if line["mfu_pct"] is None or not 0 < line["mfu_pct"] < 100:
        raise AssertionError(f"bench mfu_pct {line['mfu_pct']}")
    if line["tf32"] != {"matmul": False, "conv": False}:
        raise AssertionError(f"bench TF32 policy {line['tf32']}")


def launched(label, fn):
    """fn() with every kernel's count set to 0 just before it and read just
    after: (its result, the counts); fails if a kernel never launched."""
    from spann3r_torch.ops import _kernels

    torch.cuda.synchronize()
    _kernels.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    if min(counts[k] for k in _kernels.KERNELS) <= 0:
        raise AssertionError(f"{label}: a kernel was never launched: {counts}")
    return out, counts


def subsampled(scene_metrics, n):
    """scene_metrics on n of a scene's masked points, the same n of the
    prediction and of the GT, drawn at random from SEED."""
    def run(pts_m, gts_m, threshold):
        keep = np.random.default_rng(SEED).choice(
            len(pts_m), min(n, len(pts_m)), replace=False)
        return scene_metrics(pts_m[keep], gts_m[keep], threshold)
    return run


def phase_entry(cfg, model, card):
    """bench, demo and eval through their entry points on the full-width
    model (its weights cast for serving by the bench, as the CLIs cast
    them under BF16)."""
    import tempfile
    from unittest import mock

    from spann3r_torch import bench, config, demo
    from spann3r_torch import eval as eval_cli
    from spann3r_torch.datasets import SynthRoom
    from spann3r_torch.utils.export import read_ply
    from spann3r_torch.utils.geometry import estimate_focal_weiszfeld

    t_phase = time.perf_counter()
    missing = missing_host_packages()
    if missing:
        raise AssertionError(f"[entry] the demo and eval CLIs need "
                             f"{', '.join(missing)}, missing on this host")
    import cv2
    log("[entry] host packages PIL, cv2: present")
    loaded = lambda args: (model, cfg, config.BF16)

    # 1. the bench, in process
    t0 = time.perf_counter()
    line, counts = launched("bench", lambda: bench.run(
        bench.get_args_parser().parse_args(BENCH_FLAGS), cfg, model))
    check_bench_line(line)
    flops_t = bench.transformer_flops_per_frame(cfg, HW_512, 1)
    flops_h = bench.head_flops_per_frame(model, cfg, HW_512, 1, config.BF16)
    log(f"[entry] bench {json.dumps(line)}")
    log(f"[entry] bench launches {counts}; FLOPs per frame: transformer "
        f"stacks + memory read {flops_t:.4e}, head {flops_h:.4e}; "
        f"{time.perf_counter() - t0:.1f} s on {card}")

    with tempfile.TemporaryDirectory() as tmp:
        # 2. demo.main on an 8-frame folder at --resolution 512
        folder = os.path.join(tmp, "frames", "entry_scene")
        os.makedirs(folder)
        for i, f in enumerate(make_frames(FRAMES_DEMO, (480, 640),
                                          seed=SEED + 4)[:, 0]):
            cv2.imwrite(os.path.join(folder, f"{i:03d}.jpg"), f[..., ::-1])
        demo_args = demo.get_args_parser().parse_args(
            ["--demo_path", folder, "--save_path", os.path.join(tmp, "demo"),
             "--resolution", "512", "--kf_every", "1"])
        t0 = time.perf_counter()
        with mock.patch.object(demo, "load_model", loaded):
            (out_dir, focal, fps), counts = launched(
                "demo", lambda: demo.main(demo_args))
        wall = time.perf_counter() - t0
        plys = [f for f in os.listdir(out_dir) if f.endswith(".ply")]
        pts, cols = read_ply(os.path.join(out_dir, plys[0]))
        with open(os.path.join(out_dir, "transforms.json")) as fh:
            n_tj = len(json.load(fh)["frames"])
        npy = [f for f in os.listdir(out_dir) if f.endswith(".npy")][0]
        pts0 = np.load(os.path.join(out_dir, npy), allow_pickle=True).item()[
            "pts_all"][:1]
        h, w = pts0.shape[1:3]
        # the focal estimator's plain run on the CPU, on the same pointmap
        focal_cpu = float(estimate_focal_weiszfeld(
            torch.from_numpy(pts0), torch.tensor([[w / 2.0, h / 2.0]]))[0])
        if not (len(pts) > 0 and np.isfinite(pts).all() and n_tj == FRAMES_DEMO
                and np.isfinite(focal) and focal >= 0
                and abs(focal - focal_cpu) <= 1e-4 * (1.0 + abs(focal_cpu))):
            raise AssertionError(f"demo: {len(pts)} PLY points, {n_tj} "
                                 f"transforms.json frames, focal {focal} "
                                 f"(CPU {focal_cpu})")
        log(f"[entry] demo {w}x{h} BF16 {FRAMES_DEMO} frames: wall "
            f"{wall:.3f} s (reconstruction {fps:.3f} FPS), focal {focal:.4f} "
            f"on the card, {focal_cpu:.4f} on the CPU (the estimator clips "
            f"at 0), PLY {len(pts)} points read back, transforms.json {n_tj} "
            f"frames; launches {counts}")

        # 3. eval.main on two SynthRoom scenes at 224, its metrics on a
        # subsample of each scene's points
        eval_args = eval_cli.get_args_parser().parse_args(
            ["--exp_path", tmp, "--exp_name", "eval", "--datasets", "synth",
             "--resolution", "224", "--synth_seq_len", str(EVAL_SEQ_LEN)])
        synth = SynthRoom(num_seq=EVAL_SCENES, resolution=224,
                          seq_len=EVAL_SEQ_LEN, kf_every=EVAL_KF_EVERY,
                          full_video=True, scene_seed=9)
        t0 = time.perf_counter()
        with mock.patch.multiple(
                eval_cli, load_model=loaded,
                build_eval_datasets=lambda a: {"synth": synth},
                scene_metrics=subsampled(eval_cli.scene_metrics,
                                         EVAL_METRIC_POINTS)):
            res, counts = launched(
                "eval", lambda: eval_cli.main(eval_args)["synth"])
    metrics = np.asarray(res["metrics"], np.float64)
    if len(res["seconds"]) != EVAL_SCENES or not np.isfinite(metrics).all():
        raise AssertionError(f"eval: {len(res['seconds'])} scenes, metrics "
                             f"{metrics}")
    log(f"[entry] eval 224x224 BF16, {EVAL_SCENES} scenes of "
        f"{EVAL_SEQ_LEN // EVAL_KF_EVERY} frames: acc {metrics[0]:.4f} comp "
        f"{metrics[1]:.4f} nc1 {metrics[2]:.4f} nc2 {metrics[3]:.4f}; seconds "
        f"per scene (reconstruction, ICP + metrics on {EVAL_METRIC_POINTS} "
        f"of the scene's points) "
        f"{[(round(a, 3), round(b, 3)) for a, b in res['seconds']]}; wall "
        f"{time.perf_counter() - t0:.1f} s with the warm-up; launches "
        f"{counts}")
    log(f"[entry] phase took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 14: global alignment of pairwise pointmaps
# ---------------------------------------------------------------------------

# (a) DUSt3R's demo defaults on the full-width model: 8 frames, the complete
# symmetric graph (56 pairs), pairwise inference at batch 8, then 300 Adam
# steps at lr 0.01 from the MST init
ALIGN_FRAMES = 8
ALIGN_BATCH = 8
ALIGN_NITER, ALIGN_LR = 300, 0.01
# (b) the synthetic consistent scene of tests/test_global_align.py at
# 512x384 with 8 cameras: its bounds on the final loss and on the
# correlation of the scale-normalised distances between the same pixels of
# the first and the last view; and the largest distance of the aligned
# points from the ground truth after a best-fit similarity, as a fraction
# of the scene's extent (1.1e-4 to 3.7e-4 on the CPU at 16x16 to 128x96)
ALIGN_LOSS_BOUND = 2e-3
ALIGN_CORR_BOUND = 0.8
ALIGN_FIT_BOUND = 2e-3
# (c) card against CPU on the scene at 64x48 with 4 cameras and seeded
# noise of ALIGN_NOISE on the pairwise pointmaps (so that the energy's
# minimum is not 0: on the exact scene the final loss is at its noise floor,
# where one ulp of one parameter moves the JAX package's own final loss by
# 6%, tests/test_torch_align.py): the final loss within 1e-3 relative and
# the points within 1e-3 of the scene's extent
ALIGN_PARITY_HW, ALIGN_PARITY_N, ALIGN_NOISE = (48, 64), 4, 0.01
ALIGN_PARITY_TOL = 1e-3


def pairwise_launches(cfg, n_pairs, batch=ALIGN_BATCH):
    """K3 and K2 launches of models.inference.inference over n_pairs pairs,
    by stage: the encoder once on all the frames, both decoders (self and
    cross attention in every block) once a batch of pairs; no memory read."""
    dec = 4 * cfg.dust3r.dec.depth * -(-n_pairs // batch)
    stages = {"encoder": cfg.dust3r.enc.depth, "decoder": dec,
              "value encoder": 0}
    return {"rope2d": dict(stages), "sdpa": dict(stages), "memory_read": 0}


def align_scene(n, hw, noise=0.0, seed=SEED):
    """tests/test_global_align.py's consistent scene at n cameras and hw
    (the focal and the depth surface scaled with the image from the test's
    16x16): camera i turned 0.15 i about y and moved by i (0.3, 0.05, -0.1),
    each pointmap its own smooth depth surface; exact pairwise predictions
    over the complete symmetric graph, conf 3, plus seeded Gaussian noise
    of `noise` on both pointmaps. Returns (inference-style output, the
    ground-truth points (n, H, W, 3))."""
    from spann3r_torch.models.pairs import make_pairs

    h, w = hw
    f = 20.0 * w / 16
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    poses, world = [], []
    for i in range(n):
        ang = 0.15 * i
        pose = np.eye(4)
        pose[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                        [-np.sin(ang), 0, np.cos(ang)]]
        pose[:3, 3] = [0.3 * i, 0.05 * i, -0.1 * i]
        depth = 2.0 + 0.3 * np.sin(u * 4.0 / w + i) * np.cos(v * 4.0 / h)
        cam = np.stack([(u - w / 2) * depth / f, (v - h / 2) * depth / f,
                        depth], -1)
        poses.append(pose)
        world.append(cam @ pose[:3, :3].T + pose[:3, 3])
    pairs = make_pairs(n, "complete", symmetrize=True)
    rng = np.random.default_rng(seed)
    pred = {1: [], 2: []}
    for a, b in pairs:
        inv = np.linalg.inv(poses[a])
        pred[1].append(world[a] @ inv[:3, :3].T + inv[:3, 3])
        pred[2].append(world[b] @ inv[:3, :3].T + inv[:3, 3])
    p1, p2 = (np.stack(pred[k]).astype(np.float32) for k in (1, 2))
    if noise:
        p1 += noise * rng.standard_normal(p1.shape).astype(np.float32)
        p2 += noise * rng.standard_normal(p2.shape).astype(np.float32)
    conf = np.full((len(pairs), h, w), 3.0, np.float32)
    return ({"view1": {"idx": [a for a, _ in pairs]},
             "view2": {"idx": [b for _, b in pairs]},
             "pred1": {"pts3d": p1, "conf": conf},
             "pred2": {"pts3d_in_other_view": p2, "conf": conf.copy()}},
            np.stack(world))


def swapped_edges(output):
    """The planted fault of (b): the first two edges' pred_j swapped."""
    out = {k: dict(v) for k, v in output.items()}
    pj = output["pred2"]["pts3d_in_other_view"].copy()
    pj[[0, 1]] = pj[[1, 0]]
    out["pred2"]["pts3d_in_other_view"] = pj
    return out


def align_errors(aligner, world, seed=SEED):
    """(the correlation of tests/test_global_align.py on 4096 pixels: the
    distances between the same pixels of the first and the last view, each
    divided by its median; the largest and the median distance of the
    aligned points from the ground truth after a best-fit similarity, each
    over the scene's extent)."""
    from spann3r_torch.models.global_align import rigid_points_registration

    pts = aligner.get_pts3d()
    n = pts.shape[0]
    a, g = pts.reshape(n, -1, 3), world.reshape(n, -1, 3)
    sel = np.random.default_rng(seed).integers(0, a.shape[1], 4096)
    da = np.linalg.norm(a[0][sel] - a[-1][sel], axis=-1)
    dg = np.linalg.norm(g[0][sel] - g[-1][sel], axis=-1)
    corr = float(np.corrcoef(da / np.median(da), dg / np.median(dg))[0, 1])
    a, g = a.reshape(-1, 3), g.reshape(-1, 3)
    s, rot, t = rigid_points_registration(a, g, np.ones(len(a)))
    dist = np.linalg.norm(s * a @ rot.T.astype(np.float64) + t - g, axis=-1)
    extent = float(np.ptp(g, axis=0).max())
    return corr, float(dist.max()) / extent, float(np.median(dist)) / extent


def align_ok(loss, corr, fit):
    return (loss < ALIGN_LOSS_BOUND and corr > ALIGN_CORR_BOUND
            and fit <= ALIGN_FIT_BOUND)


def timed_optimize(aligner, niter=ALIGN_NITER, lr=ALIGN_LR):
    """aligner.optimize(niter, lr) with a CUDA-event pair around each Adam
    step: (final loss, the steps' ms, the whole call's s)."""
    events = []
    step = aligner._step

    def timed(*a):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = step(*a)
        ev[1].record()
        events.append(ev)
        return out

    aligner._step = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = aligner.optimize(niter, lr)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del aligner._step
    return loss, [s.elapsed_time(e) for s, e in events], wall


def check_aligned(label, aligner, n, hw, anchor=0):
    """The accessors: finite, of their shapes; the anchor image (image 0
    but for PairViewer's) at the identity."""
    h, w = hw
    outs = {"pts3d": (aligner.get_pts3d(), (n, h, w, 3)),
            "poses": (aligner.get_im_poses(), (n, 4, 4)),
            "focals": (aligner.get_focals(), (n,)),
            "depthmaps": (aligner.get_depthmaps(), (n, h, w)),
            "masks": (aligner.get_masks(), (n, h, w))}
    for name, (x, shape) in outs.items():
        if x.shape != shape or not np.isfinite(x).all():
            raise AssertionError(f"[align] {label} {name}: shape {x.shape} "
                                 f"(want {shape}) or not finite")
    if not (outs["focals"][0] > 0).all() or not (outs["depthmaps"][0] > 0).all():
        raise AssertionError(f"[align] {label}: focals or depths not > 0")
    if not np.allclose(outs["poses"][0][anchor], np.eye(4), atol=1e-6):
        raise AssertionError(f"[align] {label}: image {anchor} not at the "
                             f"identity")
    return outs


def phase_align(records, cfg, model, card):
    """(a) pairwise inference and global alignment at full width, (b) the
    synthetic scene and its planted fault, (c) card against CPU, (d)
    forward_mixed against forward."""
    import tempfile

    from spann3r_torch import config
    from spann3r_torch.models import dust3r as d3
    from spann3r_torch.models.global_align import (MODE_PAIR_VIEWER,
                                                   global_aligner)
    from spann3r_torch.models.inference import inference
    from spann3r_torch.models.pairs import make_pairs
    from spann3r_torch.ops import _kernels
    from spann3r_torch.utils.export import read_glb

    t_phase = time.perf_counter()
    n, (h, w) = ALIGN_FRAMES, HW_512
    frames = make_frames(n, HW_512, seed=SEED + 5).astype(np.float32)
    frames = frames / 127.5 - 1.0
    views = [{"img": frames[i], "idx": i} for i in range(n)]
    pairs = make_pairs(views, "complete", symmetrize=True)

    # (a) the main path: counts set to 0 just before, read just after
    with ShapeTally() as tally:
        torch.cuda.synchronize()
        _kernels.reset_launches()
        t0 = time.perf_counter()
        output = inference(pairs, model.dust3r, cfg.dust3r, ALIGN_BATCH,
                           config.BF16, verbose=False)
        torch.cuda.synchronize()
        infer_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        # random weights give confidences below the demo's min_conf_thr of
        # 3 (the masks would keep no point): the median confidence instead
        thr = float(np.median(output["pred1"]["conf"]))
        t0 = time.perf_counter()
        aligner = global_aligner(output, min_conf_thr=thr, device="cuda")
        init_s = time.perf_counter() - t0
        loss, step_ms, align_s = timed_optimize(aligner)
        peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
        torch.cuda.synchronize()
        counts = _kernels.launch_counts()
    want = pairwise_launches(cfg, len(pairs))
    stages = {k: tally.by_stage(k, cfg, n) for k in ("rope2d", "sdpa")}
    log(f"[align] {n} frames 512x384 BF16, {len(pairs)} pairs (complete, "
        f"symmetric), batch {ALIGN_BATCH}: pairwise inference "
        f"{infer_ms:.1f} ms; launches {counts} by stage {stages} (expected "
        f"{want}); host init (MST) {init_s:.2f} s; {ALIGN_NITER} Adam steps "
        f"at lr {ALIGN_LR}: {statistics.median(step_ms):.3f} ms a step "
        f"(median; min {min(step_ms):.3f}, max {max(step_ms):.3f}), "
        f"{align_s:.2f} s in all, final loss {loss:.6f}; peak "
        f"{peak:.3f} GiB over the {held / 2 ** 30:.3f} GiB held before; "
        f"{card}")
    for k in ("rope2d", "sdpa"):
        if stages[k] != want[k] or counts[k] != sum(want[k].values()):
            raise AssertionError(f"[align] {k} launches {counts[k]} by stage "
                                 f"{stages[k]}, expected {want[k]}")
    if counts["memory_read"] != 0:
        raise AssertionError(f"[align] memory_read launched "
                             f"{counts['memory_read']} times")
    for k in ("rope2d", "sdpa"):
        records[k]["align_launches"] = counts[k]
    if not np.isfinite(loss):
        raise AssertionError(f"[align] final loss {loss}")
    outs = check_aligned("full width", aligner, n, HW_512)
    imgs = [(f[0] + 1.0) / 2.0 for f in frames]
    with tempfile.TemporaryDirectory(prefix="spann3r_align_") as tmp:
        glb = read_glb(aligner.show(imgs=imgs, path=os.path.join(tmp,
                                                                 "scene.glb")))
    modes = sorted(p["mode"] for p in glb["primitives"])
    pts = next((p for p in glb["primitives"] if p["mode"] == 0), None)
    n_mask = int(outs["masks"][0].sum())
    if (n_mask == 0 or modes != [0, 4] or pts is None
            or len(pts["positions"]) != n_mask):
        raise AssertionError(f"[align] GLB primitives {modes}, points "
                             f"{None if pts is None else len(pts['positions'])}"
                             f" (want {n_mask})")
    log(f"[align] outputs ok: pts3d ({n},{h},{w},3), poses, focals "
        f"{np.round(outs['focals'][0], 1).tolist()}, depthmaps finite; masks "
        f"at min_conf_thr {thr:.4f} (the median confidence) keep {n_mask} "
        f"of {n * h * w} points; show() wrote a GLB of {n_mask} points and "
        f"the camera frusta, read back")
    if "cv2" in missing_host_packages():
        log("[align] cv2 missing on this host: mask_sky and PairViewer "
            "skipped")
    else:
        sky = aligner.mask_sky(imgs).get_masks()
        # PairViewer solves a pair directly (PnP): on the synthetic scene's
        # first two cameras, where the relative pose is known (random
        # weights give no pose to check)
        pv = global_aligner(align_scene(2, HW_512)[0], mode=MODE_PAIR_VIEWER,
                            device="cuda")
        check_aligned("PairViewer", pv, 2, HW_512, pv.anchor)
        ang = 0.15
        gt = np.eye(4)
        gt[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                      [-np.sin(ang), 0, np.cos(ang)]]
        gt[:3, 3] = [0.3, 0.05, -0.1]
        gt = np.linalg.inv(gt) if pv.anchor == 1 else gt
        pose_err = float(np.abs(pv.get_im_poses()[1 - pv.anchor] - gt).max())
        log(f"[align] mask_sky keeps {int(sky.sum())} of {n_mask} points; "
            f"PairViewer on the synthetic scene's cameras 0, 1: anchor "
            f"{pv.anchor}, relative pose off the truth by {pose_err:.3e} "
            f"(bound 2e-2, tests/test_global_align.py's)")
        if pose_err > 2e-2:
            raise AssertionError("[align] PairViewer's pose is off")
    del aligner, output
    torch.cuda.empty_cache()

    # (b) the synthetic scene, then its planted fault
    res = {}
    for name, fault in (("scene", False), ("swapped pred_j", True)):
        out, world = align_scene(n, HW_512)
        if fault:
            out = swapped_edges(out)
        al = global_aligner(out, device="cuda")
        l0 = float(al._loss(al.params, al._data()))
        loss = al.optimize(ALIGN_NITER, ALIGN_LR)
        corr, fit, fit_med = align_errors(al, world)
        res[name] = align_ok(loss, corr, fit)
        log(f"[align] synthetic {name} ({n} cameras, 512x384): loss "
            f"{l0:.3e} at the MST init -> {loss:.3e} (bound "
            f"{ALIGN_LOSS_BOUND:g}), correlation {corr:.6f} (bound "
            f"{ALIGN_CORR_BOUND:g}), after a best-fit similarity largest "
            f"distance {fit:.3e} of the extent (bound {ALIGN_FIT_BOUND:g}), "
            f"median {fit_med:.3e}: "
            f"{('caught' if not res[name] else 'MISSED') if fault else ('ok' if res[name] else 'FAIL')}")
        del al
    if not res["scene"] or res["swapped pred_j"]:
        raise AssertionError(f"[align] synthetic scene checks {res}")

    # (c) card against CPU on the noisy scene
    out, world = align_scene(ALIGN_PARITY_N, ALIGN_PARITY_HW, ALIGN_NOISE)
    runs = {}
    for dev in ("cuda", "cpu"):
        al = global_aligner(out, device=dev)
        runs[dev] = (al.optimize(ALIGN_NITER, ALIGN_LR), al.get_pts3d())
    extent = float(np.ptp(world.reshape(-1, 3), axis=0).max())
    dl = abs(runs["cuda"][0] - runs["cpu"][0]) / abs(runs["cpu"][0])
    dp = float(np.abs(runs["cuda"][1] - runs["cpu"][1]).max()) / extent
    ok = dl <= ALIGN_PARITY_TOL and dp <= ALIGN_PARITY_TOL
    log(f"[align] card against CPU ({ALIGN_PARITY_N} cameras, 64x48, noise "
        f"{ALIGN_NOISE}, {ALIGN_NITER} steps): final loss {runs['cuda'][0]:.6f}"
        f" / {runs['cpu'][0]:.6f}, rel {dl:.3e}; points {dp:.3e} of the "
        f"extent (bound {ALIGN_PARITY_TOL:g}): {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("[align] card and CPU disagree")

    # (d) forward_mixed on a landscape and a portrait pair against forward
    img1 = np.concatenate([frames[0], frames[2]])
    img2 = np.concatenate([frames[1], frames[3]])
    shapes = np.array([[h, w], [w, h]], np.int32)
    r1, r2 = d3.forward_mixed(model.dust3r, img1, img2, shapes, shapes,
                              cfg.dust3r, config.BF16)
    same = True
    for i, tr in ((0, lambda a: a), (1, lambda a: a.swapaxes(1, 2))):
        f1, f2 = d3.forward(model.dust3r, torch.from_numpy(np.ascontiguousarray(
            tr(img1[i:i + 1]))).cuda(), torch.from_numpy(np.ascontiguousarray(
                tr(img2[i:i + 1]))).cuda(), cfg.dust3r, config.BF16)
        for got, ref in ((r1, f1), (r2, f2)):
            for k, x in ref.items():
                same = same and np.array_equal(
                    got[k][i], tr(x.cpu().numpy())[0])
    log(f"[align] forward_mixed (landscape, portrait) at 512x384 against "
        f"forward on each pair, the portrait one transposed: "
        f"{'the same bits' if same else 'DIFFERS'}")
    if not same:
        raise AssertionError("[align] forward_mixed differs from forward")
    log(f"[align] phase took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 10: training at full width
# ---------------------------------------------------------------------------

# the training phase: the CLI's defaults (B = 2 clips of T = 5 frames at
# 224, BF16: bf16 gradients against a bf16 working copy, bf16 Adam moments,
# memory dropout), the peak LR of the CLI's schedule held constant
TRAIN_B, TRAIN_T, TRAIN_LR, TRAIN_STEPS, TRAIN_FIXED_STEPS = 2, 5, 5e-5, 8, 5
TRAIN_DATASET = ("SynthRoom(num_seq=16, num_frames=5, resolution=224, "
                 "seq_len=24, min_thresh=1, max_thresh=3, seed=777)")
# the remat settings the phase also steps: (remat, remat_scan), each for
# TRAIN_REMAT_STEPS steps after the settings-off run
REMAT_SETTINGS = {"off": (False, False), "remat": (True, False),
                  "remat_scan": (True, True)}
TRAIN_REMAT_STEPS = 3
# the gradients of the remat settings against remat off, on one batch with
# memory dropout on (the same draws): the settings run the same operations
# on the same inputs, so 1e-6 of the largest |grad|
REMAT_GRAD_TOL = 1e-6


def train_launches_by_stage(cfg, t, remat=False, remat_scan=False,
                           remat_enc=None):
    """Kernel launches of one train step on clips of t frames, by kernel
    and stage ('encoder' on B * t frames, 'decoder' and 'value encoder' on
    B streams): the encoder once on all frames (each block one K3 and one
    K2), then per pair (t - 1) both decoders (each block self and cross
    attention: K3 and K2 each) and the value encoder (K2 per block; K3 only
    with mem_pos_enc); no K1 (the training read is plain PyTorch). Each
    backward is launched as often as its forward but in the last pair's
    value encoder, whose tokens go into a bank that nothing reads after
    them.

    Rematerialisation adds the recomputed forwards; the backwards stay as
    they are. `remat` recomputes each encoder block (unless `remat_enc` is
    False: SPANN3R_NO_REMAT_ENC), each decoder block and each value-encoder
    block whose backward runs, so not the last pair's. `remat_scan`
    recomputes each pair's whole body, the last pair's value encoder
    included: the recompute runs until every tensor its forward saved is
    back. With both, a block inside the body runs a third time when its
    own backward recomputes it."""
    pairs = t - 1
    enc, dec = cfg.dust3r.enc.depth, 4 * cfg.dust3r.dec.depth
    val = cfg.value_enc_depth
    val_rope = val if cfg.mem_pos_enc else 0
    remat_enc = remat if remat_enc is None else remat and remat_enc
    enc_runs = 1 + int(remat_enc)
    dec_runs = pairs * (1 + int(remat) + int(remat_scan))
    val_runs = pairs * (1 + int(remat_scan)) + int(remat) * (pairs - 1)

    def stages(e, d, v):
        return {"encoder": e, "decoder": d, "value encoder": v}

    return {"rope2d": stages(enc * enc_runs, dec * dec_runs,
                             val_rope * val_runs),
            "sdpa": stages(enc * enc_runs, dec * dec_runs, val * val_runs),
            "sdpa_bwd": stages(enc, dec * pairs, val * (pairs - 1)),
            "rope2d_bwd": stages(enc, dec * pairs, val_rope * (pairs - 1))}


def train_launches(cfg, t, remat=False, remat_scan=False, remat_enc=None):
    """The launches of train_launches_by_stage, by kernel."""
    out = {k: sum(v.values()) for k, v in train_launches_by_stage(
        cfg, t, remat, remat_scan, remat_enc).items()}
    return {"rope2d": out["rope2d"], "sdpa": out["sdpa"], "memory_read": 0,
            "sdpa_bwd": out["sdpa_bwd"], "rope2d_bwd": out["rope2d_bwd"]}


def phase_train(records, card):
    """The published width at 224 (the training CLI's default
    configuration), random weights from SEED, make_train_step on SynthRoom
    batches through the trainer's dataset, sampler and loader: the launches
    of one step against train_launches, every step's loss and grad norm
    finite, the weights moved by the first step, the median step time and
    the peak memory; the same with remat and with remat_scan (their
    launches, step time and peak memory); then steps on one fixed batch at
    constant LR without dropout, whose last loss must be below the first;
    then the gradients of the three remat settings on one batch with
    dropout on (remat_gradients)."""
    from spann3r_torch import config, training
    from spann3r_torch.models import spann3r as sp
    from spann3r_torch.ops import _kernels

    t_phase = time.perf_counter()
    cfg = config.Spann3RConfig(dust3r=config.DUSt3RConfig(img_size=HW_224,
                                                          head_type="dpt"))
    model = sp.build_spann3r(cfg, "cuda", torch.Generator().manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    batches = train_batches(TRAIN_STEPS)
    opt = training.make_optimizer(0.05, moment_dtype=torch.bfloat16)
    opt_state = opt.init(dict(model.named_parameters()))
    step = training.make_train_step(cfg, config.BF16, opt, grads_bf16=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    watch = model.dust3r.enc_blocks[0].attn.qkv.weight
    before = watch.detach().clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, gnorms, walls = [], [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        if i == 0:
            _kernels.reset_launches()
        t0 = time.perf_counter()
        opt_state, m = step(model, opt_state, batches[i], gen, TRAIN_LR, 0.4)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            counts = _kernels.launch_counts()
            moved = float((watch.detach() - before).abs().max())
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    peak = torch.cuda.max_memory_allocated()
    want = train_launches(cfg, TRAIN_T)
    log(f"[train] {n_params} params, 224x224 BF16 (bf16 grads and moments, "
        f"dropout {cfg.memory.mem_dropout}), B={TRAIN_B} T={TRAIN_T}, lr "
        f"{TRAIN_LR}: launches of step 1 {counts}, expected {want}")
    log(f"[train] loss by step {[round(x, 4) for x in losses]}; grad norm "
        f"{[round(x, 4) for x in gnorms]}; step 1 moved the first qkv weight "
        f"by up to {moved:.3e}")
    steady = walls[3:]
    log(f"[train] step ms {[round(x, 1) for x in walls]}: median of steps "
        f"4-{TRAIN_STEPS} {statistics.median(steady):.1f} ms "
        f"({TRAIN_B * TRAIN_T / statistics.median(steady) * 1e3:.2f} frames/s)"
        f"; peak memory {peak / 2**30:.2f} GiB "
        f"(max_memory_allocated) on {card}")
    if counts != want:
        raise AssertionError(f"train launches {counts}, expected {want}")
    if not all(np.isfinite(losses)) or not all(np.isfinite(gnorms)):
        raise AssertionError("a train step's loss or grad norm is not finite")
    if not moved > 0:
        raise AssertionError("the first train step left the weights as they were")
    by_setting = {"off": (statistics.median(steady), peak)}
    for name, (remat, scan) in REMAT_SETTINGS.items():
        if name == "off":
            continue
        rstep = training.make_train_step(cfg, config.BF16, opt,
                                         grads_bf16=True, remat=remat,
                                         remat_scan=scan)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rwalls = []
        for i in range(TRAIN_REMAT_STEPS):
            if i == 0:
                _kernels.reset_launches()
            t0 = time.perf_counter()
            opt_state, m = rstep(model, opt_state, batches[i], gen, TRAIN_LR,
                                 0.4)
            torch.cuda.synchronize()
            rwalls.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                rcounts = _kernels.launch_counts()
            if not np.isfinite(float(m["loss"])):
                raise AssertionError(f"{name}: a train step's loss is not "
                                     f"finite")
        rpeak = torch.cuda.max_memory_allocated()
        rwant = train_launches(cfg, TRAIN_T, remat, scan)
        by_setting[name] = (statistics.median(rwalls[1:]), rpeak)
        log(f"[train] {name} (remat={int(remat)} remat_scan={int(scan)}): "
            f"launches of step 1 {rcounts}, expected {rwant}; step ms "
            f"{[round(x, 1) for x in rwalls]}, median of steps 2-"
            f"{TRAIN_REMAT_STEPS} {by_setting[name][0]:.1f} ms; peak memory "
            f"{rpeak / 2**30:.2f} GiB")
        if rcounts != rwant:
            raise AssertionError(f"{name} train launches {rcounts}, expected "
                                 f"{rwant}")
    log(f"[train] remat at B={TRAIN_B} T={TRAIN_T} 224 BF16 on {card}: "
        + "; ".join(f"{k} {ms:.1f} ms/step, peak {pk / 2**30:.2f} GiB"
                    for k, (ms, pk) in by_setting.items()))
    for name, (remat, scan) in REMAT_SETTINGS.items():
        log(f"[train] launches per step by stage, {name}: "
            f"{train_launches_by_stage(cfg, TRAIN_T, remat, scan)}")
    fixed = []
    for _ in range(TRAIN_FIXED_STEPS):
        opt_state, m = step(model, opt_state, batches[0], None, TRAIN_LR, 0.4)
        fixed.append(float(m["loss"]))
    log(f"[train] one fixed batch, constant lr {TRAIN_LR}, no dropout: loss "
        f"{[round(x, 4) for x in fixed]}")
    if not fixed[-1] < fixed[0]:
        raise AssertionError("on one fixed batch the loss did not fall")
    for name in _kernels.BACKWARD_KERNELS:
        records[name]["launches"] = counts[name]
    mixture_steps(model, cfg, opt_state, step, gen, card)
    del opt_state, step
    torch.cuda.empty_cache()
    remat_gradients(model, cfg, batches[0])
    del model
    torch.cuda.empty_cache()
    log(f"[train] phase took {time.perf_counter() - t_phase:.1f} s")
    return by_setting["off"][0]


# the training mixture of the reference's recipe over the six datasets that
# read files, each on a fixture tree in its own layout (one scene of
# MIX_FRAMES frames at its raw capture sizes; Habitat: MIX_CLIPS box-room
# clips of 5 views at 128 x 128), MIX_EACH items of each, B = 2 clips of
# TRAIN_T frames at 224
MIX_KINDS = ("Co3d", "BlendMVS", "Scannet", "Scannetpp", "ArkitScene",
             "habitat")
MIX_FRAMES, MIX_CLIPS, MIX_EACH, MIX_STEPS = 20, 4, 2, 3


def mixture_trees(root):
    """Write the fixture trees under root: {kind: the dataset's kwargs}."""
    from spann3r_torch.tools import dataset_fixtures as fx

    return {kind: fx.write_tree(kind, os.path.join(root, kind), seed=SEED + i,
                                frames=MIX_CLIPS if kind == "habitat"
                                else MIX_FRAMES,
                                shrink=2 if kind == "habitat" else 1)
            for i, kind in enumerate(MIX_KINDS)}


def mixture_expr(trees, each):
    """The mixture in the reference's expression form, `each` items of
    every dataset, clips of TRAIN_T frames at 224."""
    from spann3r_torch.tools import dataset_fixtures as fx

    return " + ".join(fx.expression(kind, kw, each, 224, num_frames=TRAIN_T)
                      for kind, kw in trees.items())


def mixture_steps(model, cfg, opt_state, step, gen, card):
    """MIX_STEPS train steps of phase 10's model and optimizer on batches of
    the six-dataset mixture: launches of each step equal to
    train_launches, finite losses, the loader's clips/s beside the step
    time; then `python -m spann3r_torch.train` at the CLI's defaults on one
    item of each dataset (one epoch: 3 steps of 2 clips)."""
    import shutil
    import tempfile

    from spann3r_torch.ops import _kernels

    t_part = time.perf_counter()
    root = tempfile.mkdtemp(prefix="spann3r_mix_")
    try:
        t0 = time.perf_counter()
        trees = mixture_trees(root)
        expr = mixture_expr(trees, MIX_EACH)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        batches = train_batches(MIX_STEPS, dataset=expr)
        load_s = time.perf_counter() - t0
        clips = MIX_STEPS * TRAIN_B
        log(f"[train] mixture: {expr}")
        log(f"[train] mixture fixtures written in {write_s:.1f} s; loader: "
            f"{clips} clips of {TRAIN_T} frames in {load_s:.2f} s "
            f"({clips / load_s:.2f} clips/s, 2 workers)")
        want = train_launches(cfg, TRAIN_T)
        walls, losses = [], []
        for b in batches:
            torch.cuda.synchronize()
            _kernels.reset_launches()
            t0 = time.perf_counter()
            opt_state, m = step(model, opt_state, b, gen, TRAIN_LR, 0.4)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            counts = _kernels.launch_counts()
            losses.append(float(m["loss"]))
            if counts != want:
                raise AssertionError(f"mixture step launches {counts}, "
                                     f"expected {want}")
        log(f"[train] mixture steps: loss {[round(x, 4) for x in losses]}, "
            f"step ms {[round(x, 1) for x in walls]} (median "
            f"{statistics.median(walls):.1f}; the loader "
            f"{TRAIN_B / (clips / load_s) * 1e3:.1f} ms a batch) on {card}; "
            f"launches of each step = train_launches {want}")
        if not all(np.isfinite(losses)):
            raise AssertionError("a mixture step's loss is not finite")
        t0 = time.perf_counter()
        out = os.path.join(root, "train_out")
        cmd = [sys.executable, "-m", "spann3r_torch.train", "--epochs", "1",
               "--save_freq", "0", "--num_workers", "1", "--train_dataset",
               mixture_expr(trees, 1), "--output_dir", out]
        proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(
            __file__)), capture_output=True, text=True,
            timeout=DIST_WORKER_TIMEOUT)
        lines = (proc.stdout + proc.stderr).splitlines()
        steps = len(MIX_KINDS) // TRAIN_B
        done = [x for x in lines if x.startswith(f"E0 it0/{steps} loss=")]
        if proc.returncode != 0 or not done:
            raise AssertionError("python -m spann3r_torch.train on the "
                                 "mixture failed:\n" + "\n".join(lines[-60:]))
        log(f"[train] python -m spann3r_torch.train --train_dataset "
            f"'<the mixture, 1 item each>' (the CLI's defaults: one epoch of "
            f"{steps} steps at B={TRAIN_B}): '{done[0].strip()}' in "
            f"{time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[train] mixture part took {time.perf_counter() - t_part:.1f} s")


def remat_gradients(model, cfg, batch):
    """The loss and the gradients of one batch with memory dropout on, the
    same draws (a generator from SEED) under each remat setting, against
    remat off: within REMAT_GRAD_TOL of the largest |grad|. FP32 on the
    fp32 weights, so that the only difference a setting could make is the
    recompute's (a bf16 activation would turn the run-to-run rounding of
    atomic sums in the fp32 heads' backward into whole bf16 ulps)."""
    from spann3r_torch import config, training

    dev_batch = training.batch_to_device(batch, "cuda")
    out = {}
    for name, (remat, scan) in REMAT_SETTINGS.items():
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _, grads = training.value_and_grad(
            model, cfg, config.FP32, dev_batch, gen, 0.4, remat=remat,
            remat_scan=scan)
        torch.cuda.synchronize()
        if name == "off":
            ref_loss, ref, gmax = float(loss), grads, max(
                float(g.abs().max()) for g in grads.values())
            out[name] = (0.0, 0.0, time.perf_counter() - t0)
            continue
        worst = max(float((grads[k] - ref[k]).abs().max()) for k in ref)
        out[name] = (abs(float(loss) - ref_loss), worst,
                     time.perf_counter() - t0)
        del grads
    log(f"[train] FP32 gradients with dropout on, B={TRAIN_B} T={TRAIN_T}: "
        f"max |grad| {gmax:.3e}; against remat off: "
        + "; ".join(f"{k} loss diff {dl:.3e}, grads max abs diff {dg:.3e} "
                    f"= {dg / gmax:.3e} of max |grad| ({sec:.2f} s)"
                    for k, (dl, dg, sec) in out.items() if k != "off")
        + f" (bound {REMAT_GRAD_TOL:g})")
    for k, (dl, dg, _) in out.items():
        if dl > REMAT_GRAD_TOL * (1.0 + abs(ref_loss)) or \
                dg > REMAT_GRAD_TOL * gmax:
            raise AssertionError(f"the {k} gradients differ from remat off")


# ---------------------------------------------------------------------------
# phase 11: a miniature of the convergence gate and the serving gates
# ---------------------------------------------------------------------------

# the convergence gate's recipe (spann3r_torch.tools.convergence_gate) cut
# to 2 epochs of 15 steps at B = 8; its serving gates on the checkpoint-best
GATE_RES, GATE_EPOCHS, GATE_STEPS, GATE_B = 112, 2, 15, 8


def phase_gate(card):
    """run_gate on the gate's small configuration at 112 x 112 (remat on,
    BF16, random init from seed 0): the held-out eval loss must fall; the
    chamfer before and after and every kernel's launches are printed. Then
    the int8 gate (weight-only, min_dim 256), the int8 gate with
    activations (256 rows) and the BF16_FAST gate on the run's
    checkpoint-best: their relative chamfer changes are printed, not held
    to the gates' bound (30 steps do not make the gate's model)."""
    import shutil
    import tempfile

    from spann3r_torch.ops import _kernels
    from spann3r_torch.tools import bf16fast_gate, convergence, int8_gate
    from spann3r_torch.tools import convergence_gate as cg

    t_phase = time.perf_counter()
    out = tempfile.mkdtemp(prefix="spann3r_gate_")
    try:
        args = cg.gate_args(GATE_RES, GATE_EPOCHS, GATE_B, GATE_STEPS, 3e-4,
                            out, fp32=False, device="cuda",
                            per_epoch_last=False)
        _kernels.reset_launches()
        art = convergence.run_gate(args, cg.small_cfg(GATE_RES),
                                   cg.chamfer_expr(GATE_RES),
                                   n_chamfer_scenes=3)
        counts = _kernels.launch_counts()
        b, a = art["before"], art["after"]
        log(f"[gate] {GATE_EPOCHS} epochs x {GATE_STEPS} steps, B={GATE_B}, "
            f"{GATE_RES}x{GATE_RES}, remat={int(art['remat'])}: eval loss_med "
            f"{b['eval']['loss_med']:.4f} -> {a['eval']['loss_med']:.4f}; "
            f"chamfer {b['chamfer']['chamfer']:.4f} -> "
            f"{a['chamfer']['chamfer']:.4f} (acc {b['chamfer']['acc']:.4f} -> "
            f"{a['chamfer']['acc']:.4f}, comp {b['chamfer']['comp']:.4f} -> "
            f"{a['chamfer']['comp']:.4f}); {art['wall_s']:.1f} s on "
            f"{art['device']}; launches {counts}")
        if not art["eval_improved"]:
            raise AssertionError("gate miniature: the eval loss did not fall")
        if not all(counts[k] > 0 for k in ("rope2d", "sdpa", "memory_read",
                                           "sdpa_bwd", "rope2d_bwd")):
            raise AssertionError(f"gate miniature: a kernel was not launched: "
                                 f"{counts}")
        ckpt = os.path.join(out, "checkpoint-best.pth")
        for label, mod, extra in (("int8", int8_gate, ["--act", "0"]),
                                  ("int8 + act 256", int8_gate,
                                   ["--act", "256"]),
                                  ("BF16_FAST", bf16fast_gate, [])):
            g = mod.run(mod.get_args_parser().parse_args(
                ["--ckpt", ckpt, "--device", "cuda", *extra]))
            arm = "bf16_fast" if mod is bf16fast_gate else "int8"
            nq = (f", {g['quantized_matrices']} int8 matrices"
                  if arm == "int8" else "")
            log(f"[gate] {label} on checkpoint-best: chamfer "
                f"{g['bf16']['chamfer']:.4f} (BF16) -> {g[arm]['chamfer']:.4f}"
                f", relative change {g['chamfer_rel_delta']:+.4%}{nq} "
                f"(reported, not gated); {g['wall_s']:.1f} s")
            if g["ckpt"] != ckpt:
                raise AssertionError(f"{label}: the checkpoint was not read")
    finally:
        shutil.rmtree(out, ignore_errors=True)
    log(f"[gate] phase took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 9: card against CPU, end to end
# ---------------------------------------------------------------------------

def phase_parity():
    """Streaming and offline, on the card (kernels) and on the CPU (plain
    versions), the same weights: the same frame order, preds within
    E2E_TOL."""
    from spann3r_torch import api, config
    from spann3r_torch.models import offline
    from spann3r_torch.models import spann3r as sp
    from spann3r_torch.tools.eval_pipeline import evaluate_scene

    cfg = config.Spann3RConfig()
    frames = make_frames(4, HW_224, seed=SEED + 1)
    eval_s = []
    normed = frames.astype(np.float32) / 127.5 - 1.0
    # the greedy scores of each round, to tell a near tie from a fault
    scores = []
    orig_score = offline._score_candidates

    def recording(*a, **kw):
        out = orig_score(*a, **kw)
        scores.append(out.float().cpu().numpy())
        return out

    eval_batch = boxroom_batch(4, HW_224, seed=SEED + 20)

    def both(model):
        t0 = time.perf_counter()
        aligned = evaluate_scene(model, cfg, config.FP32, eval_batch)
        eval_s.append(time.perf_counter() - t0)
        video = api.reconstruct_video(model, cfg, frames, config.FP32)
        offline._score_candidates = recording
        try:
            scores.clear()
            off = api.reconstruct_video(model, cfg, normed, config.FP32,
                                        offline=True)
        finally:
            offline._score_candidates = orig_score
        return video, off, [np.sort(x)[-2:] for x in scores], aligned

    model_gpu = sp.build_spann3r(cfg, "cuda", torch.Generator().manual_seed(SEED))
    runs_gpu = both(model_gpu)
    del model_gpu
    torch.cuda.empty_cache()
    model_cpu = sp.build_spann3r(cfg, "cpu", torch.Generator().manual_seed(SEED))
    t0 = time.perf_counter()
    runs_cpu = both(model_cpu)
    log(f"[parity] CPU runs took {time.perf_counter() - t0:.1f} s")
    for label, (preds_gpu, order_gpu, _), (preds_cpu, order_cpu, _) in (
            ("streaming", runs_gpu[0], runs_cpu[0]),
            ("offline", runs_gpu[1], runs_cpu[1])):
        if order_gpu != order_cpu:
            raise AssertionError(
                f"{label}: card frame order {order_gpu} != CPU {order_cpu}; "
                f"best two scores a round: card {runs_gpu[2]} CPU "
                f"{runs_cpu[2]}")
        if len(preds_cpu) != len(preds_gpu):
            raise AssertionError(f"{label}: card and CPU give different pred "
                                 f"counts")
        worst = 0.0
        for i, (a, b) in enumerate(zip(preds_gpu, preds_cpu)):
            if set(a) != set(b):
                raise AssertionError(f"{label} pred {i}: keys {sorted(a)} vs "
                                     f"{sorted(b)}")
            for key in a:
                err = np.abs(a[key] - b[key])
                worst = max(worst, float(err.max()))
                if not (err <= E2E_TOL * (1.0 + np.abs(b[key]))).all():
                    raise AssertionError(f"{label} pred {i} {key}: card vs "
                                         f"CPU max err {float(err.max()):.3e}"
                                         f" > {E2E_TOL}")
        log(f"[parity] {label} 224x224 FP32 4 frames: card (kernels) vs CPU "
            f"(plain) frame order {order_gpu} on both, max abs err "
            f"{worst:.3e} <= {E2E_TOL} ok")
    # the eval pipeline: the aligned points and GT of the same scene, in
    # the same frame order
    (pts_g, gt_g, *_, order_g, _), (pts_c, gt_c, *_, order_c, _) = \
        runs_gpu[3], runs_cpu[3]
    if list(order_g) != list(order_c):
        raise AssertionError(f"eval parity: frame order {order_g} vs {order_c}")
    worst = 0.0
    for what, a, b in (("aligned points", pts_g, pts_c), ("GT", gt_g, gt_c)):
        err = np.abs(a - b)
        worst = max(worst, float(err.max()))
        if not (err <= E2E_TOL * (1.0 + np.abs(b))).all():
            raise AssertionError(f"eval parity {what}: card vs CPU max err "
                                 f"{float(err.max()):.3e} > {E2E_TOL}")
    log(f"[entry] eval parity 224x224 FP32 4 frames (evaluate_scene on a "
        f"BoxRoomBackend scene): card vs CPU aligned points max abs err "
        f"{worst:.3e} <= {E2E_TOL} ok; evaluate_scene {eval_s[0]:.3f} s on "
        f"the card, {eval_s[1]:.3f} s on the CPU")
    gaps = [float(t[-1] - t[-2]) for t in runs_gpu[2] if len(t) > 1]
    log(f"[parity] offline best-two score gaps a round (card): "
        f"{[f'{g:.3e}' for g in gaps]}")


# the narrow configuration of the train-step parity: head dim 64 in the
# encoder, the decoders and the value encoder, so that K2 runs, at 224
PARITY_TRAIN_T = 3


def parity_train_cfg():
    from spann3r_torch import config as C
    return C.Spann3RConfig(
        dust3r=C.DUSt3RConfig(img_size=HW_224, head_type="dpt",
                              enc=C.ViTConfig(dim=256, depth=2, num_heads=4),
                              dec=C.ViTConfig(dim=192, depth=2, num_heads=3)),
        value_enc_depth=2, value_enc_dim=256, value_enc_heads=4,
        attn_head_in=256 + 192, attn_head_out=256)


def phase_parity_train():
    """One FP32 train step's loss and gradients, the card (kernels, forward
    and backward) against the CPU (plain versions under autograd), on the
    same weights and batch, dropout off: loss within E2E_TOL relative,
    every gradient within E2E_TOL of the largest |grad|. Then the step
    itself on the card: finite, and the weights move."""
    from spann3r_torch import config, training
    from spann3r_torch.models import spann3r as sp
    from spann3r_torch.ops import _kernels

    cfg = parity_train_cfg()
    rng = np.random.default_rng(SEED + 30)
    t, b = PARITY_TRAIN_T, 2
    frames = make_frames(t * b, HW_224, seed=SEED + 31).reshape(
        t, b, *HW_224, 3).astype(np.float32) / 127.5 - 1.0
    batch = {"img": frames,
             "pts3d": (rng.standard_normal((t, b, *HW_224, 3)) + 2.0).astype(
                 np.float32),
             "valid_mask": rng.random((t, b, *HW_224)) > 0.2,
             "camera_pose": np.broadcast_to(np.eye(4, dtype=np.float32),
                                            (t, b, 4, 4)).copy()}
    out = {}
    for dev in ("cuda", "cpu"):
        model = sp.build_spann3r(cfg, dev, torch.Generator().manual_seed(SEED))
        t0 = time.perf_counter()
        if dev == "cuda":
            _kernels.reset_launches()
        loss, _, grads = training.value_and_grad(
            model, cfg, config.FP32, training.batch_to_device(batch, dev),
            None, 0.4)
        out[dev] = (float(loss), {k: g.float().cpu() for k, g in grads.items()},
                    time.perf_counter() - t0)
        if dev == "cuda":
            counts = _kernels.launch_counts()
            opt = training.make_optimizer(0.05)
            st = opt.init(dict(model.named_parameters()))
            w0 = model.value_out.weight.detach().clone()
            st, m = training.make_train_step(cfg, config.FP32, opt)(
                model, st, batch, None, 1e-4, 0.4)
            if not (np.isfinite(float(m["loss"])) and
                    float((model.value_out.weight.detach() - w0).abs().max())
                    > 0):
                raise AssertionError("the FP32 train step on the card failed")
        del model
    (lg, gg, sg), (lc, gc, sc) = out["cuda"], out["cpu"]
    gmax = max(float(v.abs().max()) for v in gc.values())
    worst = max(float((gg[k] - gc[k]).abs().max()) for k in gc)
    worst_name = max(gc, key=lambda k: float((gg[k] - gc[k]).abs().max()))
    log(f"[parity] one FP32 train step 224x224, B={b} T={t}, enc 256/4 heads, "
        f"dec 192/3 heads (head dim 64): loss card {lg:.6f} CPU {lc:.6f}; "
        f"grads max abs err {worst:.3e} ({worst_name}) = {worst / gmax:.3e} "
        f"of max |grad| {gmax:.3e} (bound {E2E_TOL}); launches on the card "
        f"{counts}, expected {train_launches(cfg, t)}; {sg:.2f} s on the "
        f"card, {sc:.2f} s on the CPU")
    if counts != train_launches(cfg, t):
        raise AssertionError("train-step parity: launches differ from the code")
    if abs(lg - lc) > E2E_TOL * (1.0 + abs(lc)) or worst > E2E_TOL * gmax:
        raise AssertionError("train-step parity: card and CPU disagree")


# ---------------------------------------------------------------------------
# phase 12: multi-process training
# ---------------------------------------------------------------------------

# (a) world 1 over NCCL: steps of phase 10's configuration under each
# --fsdp, from the same weights and dropout seed, against the one-process
# step on the same batches; one-process runs before and after, to tell the
# card's run-to-run rounding from a fault
DIST_STEPS = 3
# (b) two ranks on the one card over gloo (NCCL refuses two ranks on one
# device): the narrow FP32 configuration of phase 9, B = 1 a rank, the
# global batch's clips with uneven valid shares; each layout's loss and
# gradients against the one-process step on the global batch: data
# parallel runs the same operations but for the sums over the ranks and
# the batch of each product, so 1e-5 of the largest |grad|; tensor
# parallel also splits each row-parallel product's sum in two and sums the
# input gradients of the two halves of the heads, which at FP32 moved
# the gradients by 1.396e-5 to 1.430e-5 of the largest on an H100 (where
# the card and the CPU differ by 1.3e-5 on this configuration, phase 9),
# so about twice that: in float64 the split gives the one-process
# gradients within 1e-12 (tests/test_torch_distributed.py), and a wrong
# head or column moves them by O(1)
DIST_KEEP = (0.9, 0.35)
DIST_TOL = 1e-5
DIST_TP_TOL = 3e-5
# the layouts: (model axis, fsdp); their split and slice threshold takes
# the encoder and value encoder (256 wide, 4 heads) and leaves the
# decoders (192, 3 heads) whole
GLOO_LAYOUTS = {"data 2": (1, False), "data 2 fsdp": (1, True),
                "model 2": (2, False)}
DIST_MIN_DIM = 256
# (c) two full-width ranks at 224, B = 1 x T = 5 each, BF16 with bf16
# gradients and moments: peak memory per rank under --fsdp 0 and 1
MEM_STEPS = 2
DIST_WORKER_TIMEOUT = 600
# (d) multi-stream serving over ranks: B = 4 streams of 8 frames at 224,
# FP32, the full-width model, dealt by make_mesh_for_batch (world 1 over
# NCCL: one rank takes all four; two ranks over gloo: two each), the
# gathered results against four one-stream runs within the bound of
# tests/test_sharded_inference.py
STREAMS_B, STREAMS_T = 4, 8
STREAMS_ATOL, STREAMS_RTOL = 2e-4, 1e-4


def rank_part(batch, rank, n):
    """A data rank's clips of a (T, B, ...) global batch: rows
    [rank * B / n, (rank + 1) * B / n), as the trainer's sampler deals
    them and forward_train cuts the dropout draw."""
    b = batch["img"].shape[1] // n
    return {k: v[:, rank * b:(rank + 1) * b] for k, v in batch.items()}


def uneven_batch(t, b, hw, keep, seed):
    """A global FP32 batch whose clip i keeps keep[i] of its pixels."""
    rng = np.random.default_rng(seed)
    frames = make_frames(t * b, hw, seed=seed).reshape(t, b, *hw, 3)
    mask = rng.random((t, b, *hw)) < np.asarray(keep)[None, :, None, None]
    return {"img": frames.astype(np.float32) / 127.5 - 1.0,
            "pts3d": (rng.standard_normal((t, b, *hw, 3)) + 2.0).astype(
                np.float32),
            "valid_mask": mask,
            "camera_pose": np.broadcast_to(np.eye(4, dtype=np.float32),
                                           (t, b, 4, 4)).copy()}


def grads_agree(loss, grads, ref_loss, ref_grads, gmax, tol=DIST_TOL):
    """(ok, loss relative error, worst gradient error / gmax): the loss
    within tol relative and every gradient within tol of the largest
    |grad| of the reference (`ref_grads` cut to the same parts)."""
    dl = abs(loss - ref_loss) / max(abs(ref_loss), 1e-30)
    worst = max(float((g.float() - ref_grads[k].float()).abs().max())
                for k, g in grads.items())
    return dl <= tol and worst <= tol * gmax, dl, worst / gmax


def state_bytes(shapes, sliced, n, moment_bytes):
    """Bytes of the training state one rank holds before a step: each
    parameter's fp32 master and two moments, a sliced one as
    ceil(numel / n) elements."""
    total = 0
    for name, shape in shapes.items():
        numel = int(np.prod(shape))
        if name in sliced:
            numel = -(-numel // n)
        total += numel * (4 + 2 * moment_bytes)
    return total


def _dist_env(rank, world, port, local_rank=None):
    return dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world),
                LOCAL_RANK=str(rank if local_rank is None else local_rank),
                MASTER_ADDR="localhost", MASTER_PORT=str(port),
                CUBLAS_WORKSPACE_CONFIG=":4096:8")


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_ranks(name, world, local_rank=None):
    """This script's `--dist-worker name` as `world` ranks; their output
    printed; fails unless every rank exits 0 within the timeout."""
    here = os.path.dirname(os.path.abspath(__file__))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dist-worker", name],
        cwd=here, env=_dist_env(r, world, port, local_rank),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DIST_WORKER_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        for line in out.splitlines():
            if line.startswith("[dist]"):
                log(line)
        if p.returncode != 0:
            raise AssertionError(f"[dist] {name} rank {r} failed (rc "
                                 f"{p.returncode}):\n{out[-6000:]}")


def phase_dist(card, train_ms):
    """(a) world 1 over NCCL in a subprocess (`dist_world1`), then the
    torchrun entry on a small SynthRoom set at the CLI's defaults; (b) and
    (c) two ranks on the card over gloo (`dist_gloo2`)."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    log(f"[dist] phase 10's median step {train_ms:.1f} ms (one process, "
        f"B={TRAIN_B} T={TRAIN_T} 224 BF16) on {card}")
    _run_ranks("world1", 1)
    t0 = time.perf_counter()
    import tempfile
    with tempfile.TemporaryDirectory(prefix="spann3r_dist_") as out:
        here = os.path.dirname(os.path.abspath(__file__))
        cmd = [sys.executable, "-m", "torch.distributed.run",
               "--nproc_per_node", "1", "--master_port", str(_free_port()),
               "-m", "spann3r_torch.train", "--epochs", "1", "--save_freq",
               "0", "--num_workers", "1", "--train_dataset",
               "2 @ " + TRAIN_DATASET.replace("num_seq=16", "num_seq=2"),
               "--output_dir", out]
        # a process group of its own, so that a timeout stops torchrun's
        # worker too
        proc = subprocess.Popen(cmd, cwd=here, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                start_new_session=True)
        try:
            out = proc.communicate(timeout=DIST_WORKER_TIMEOUT)[0]
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.communicate()
        lines = out.splitlines()
        if proc.returncode != 0 or not any(
                x.startswith("E0 it0/1 loss=") for x in lines) or not any(
                "process 0/1" in x for x in lines):
            raise AssertionError("torchrun -m spann3r_torch.train failed:\n"
                                 + "\n".join(lines[-60:]))
        step = next(x for x in lines if x.startswith("E0 it0/1 loss="))
    log(f"[dist] python -m torch.distributed.run --nproc_per_node 1 -m "
        f"spann3r_torch.train (224 DPT BF16, B={TRAIN_B}, one step): "
        f"'{step.strip()}' in {time.perf_counter() - t0:.1f} s")
    _run_ranks("gloo2", 2, local_rank=0)
    log(f"[dist] phase took {time.perf_counter() - t_phase:.1f} s")


def _dist_steps(model, cfg, mesh, fsdp, batches):
    """DIST_STEPS BF16 train steps from a copy of `model` (the trainer's
    defaults: bf16 gradients and moments, dropout from SEED), under a
    layout unless `fsdp` is None: losses, grad norms, step ms, the launches
    of step 1 and the full weights after."""
    import copy

    from spann3r_torch import config, training
    from spann3r_torch.ops import _kernels
    from spann3r_torch.parallel import sharding

    m = copy.deepcopy(model)
    layout = None
    if fsdp is not None:
        layout = sharding.Layout(m, cfg, mesh, fsdp)
        layout.shard_model_(m)
    opt = training.make_optimizer(0.05, moment_dtype=torch.bfloat16)
    st = opt.init(dict(m.named_parameters()))
    step = training.make_train_step(cfg, config.BF16, opt, grads_bf16=True,
                                    layout=layout)
    gen = torch.Generator(device=next(m.parameters()).device).manual_seed(SEED)
    losses, gnorms, walls = [], [], []
    for i, b in enumerate(batches):
        torch.cuda.synchronize()
        if i == 0:
            _kernels.reset_launches()
        t0 = time.perf_counter()
        st, mt = step(m, st, b, gen, TRAIN_LR, 0.4)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            counts = _kernels.launch_counts()
        losses.append(float(mt["loss"]))
        gnorms.append(float(mt["grad_norm"]))
    params = dict(m.named_parameters())
    if layout is not None:
        params = layout.full_tensors(params)
    params = {k: v.detach().clone() for k, v in params.items()}
    desc = "one process" if layout is None else layout.describe()
    del m, st, step
    torch.cuda.empty_cache()
    return losses, gnorms, walls, counts, params, desc


def dist_world1():
    """(a): phase 10's configuration at world 1 over NCCL: one process,
    --fsdp 0, --fsdp 1, one process again, on the same batches; then (d)
    at world 1."""
    import torch.distributed as dist

    from spann3r_torch import config
    from spann3r_torch.models import spann3r as sp
    from spann3r_torch.parallel import mesh as pmesh

    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    pmesh.init_distributed("cuda")
    if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        raise AssertionError(f"world 1 over NCCL: got {dist.get_backend()} "
                             f"at {dist.get_world_size()}")
    mesh = pmesh.make_mesh(1)
    cfg = config.Spann3RConfig(dust3r=config.DUSt3RConfig(img_size=HW_224,
                                                          head_type="dpt"))
    model = sp.build_spann3r(cfg, "cuda", torch.Generator().manual_seed(SEED))
    batches = train_batches(DIST_STEPS)
    want = train_launches(cfg, TRAIN_T)
    runs = {name: _dist_steps(model, cfg, mesh, fsdp, batches)
            for name, fsdp in (("one process", None), ("fsdp 0", False),
                               ("fsdp 1", True), ("one process again", None))}
    ref = runs["one process"]

    def diff(a, b):
        return (max(abs(x - y) for x, y in zip(a[0], b[0])),
                max(float((a[4][k] - b[4][k]).abs().max()) for k in a[4]))

    same_ref = diff(ref, runs["one process again"]) == (0.0, 0.0)
    for name, (losses, gnorms, walls, counts, params, desc) in runs.items():
        bits = (losses == ref[0] and gnorms == ref[1] and all(
            torch.equal(params[k], ref[4][k]) for k in ref[4]))
        dl, dp = diff(runs[name], ref)
        print(f"[dist] world 1 NCCL {name} ({desc}): loss {losses}, grad norm "
              f"{gnorms}; step ms {[round(x, 1) for x in walls]}; launches "
              f"of step 1 {counts} (expected {want}); against the first "
              f"one-process run: {'the same bits' if bits else 'differs'}"
              f" (loss {dl:.3e}, weights {dp:.3e})", flush=True)
        if counts != want:
            raise AssertionError(f"{name}: launches {counts}, expected {want}")
        if same_ref and not bits:
            raise AssertionError(f"world 1 {name}: not the one-process bits")
    if not same_ref:
        raise AssertionError("two one-process runs on the card differ: the "
                             "bit check cannot be made")
    del model, runs, ref
    torch.cuda.empty_cache()
    dist_streams(torch.device("cuda"), "world 1 over NCCL")
    dist.destroy_process_group()


def dist_streams(dev, label):
    """(d): the streams through parallel.streams.scan_streams over the
    mesh of make_mesh_for_batch; on rank 0, against each stream alone."""
    import torch.distributed as dist

    from spann3r_torch import config
    from spann3r_torch.models import spann3r as sp
    from spann3r_torch.parallel import mesh as pmesh
    from spann3r_torch.parallel.streams import scan_streams

    cfg = config.Spann3RConfig(dust3r=config.DUSt3RConfig(img_size=HW_224,
                                                          head_type="dpt"))
    model = sp.build_spann3r(cfg, dev, torch.Generator().manual_seed(SEED))
    frames = make_frames(STREAMS_T * STREAMS_B, HW_224, seed=SEED + 50)
    frames = frames.reshape(STREAMS_T, STREAMS_B, *HW_224, 3)
    mesh = pmesh.make_mesh_for_batch(STREAMS_B)
    run = lambda f, m: scan_streams(model, cfg, f, HW_224, config.FP32, m,
                                    chunk=STREAMS_T)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = run(frames, mesh)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    if dist.get_rank() != 0:
        return
    worst = 0.0
    ok = True
    for b in range(STREAMS_B):
        ref = run(frames[:, b:b + 1], None)
        ok = ok and np.array_equal(got["emitted"], ref["emitted"])
        em = ref["emitted"]
        for k, g, r in (("pts3d", got["pts3d"][em, b], ref["pts3d"][em, 0]),
                        ("conf", got["conf"][em, b], ref["conf"][em, 0]),
                        ("pts3d_2", got["pts3d_2"][b], ref["pts3d_2"][0]),
                        ("conf_2", got["conf_2"][b], ref["conf_2"][0])):
            err = np.abs(g - r)
            ok = ok and bool((err <= STREAMS_ATOL + STREAMS_RTOL
                              * np.abs(r)).all())
            worst = max(worst, float(err.max()))
    print(f"[dist] streams {label}: B={STREAMS_B} streams of {STREAMS_T} "
          f"frames at 224 FP32 over {mesh.data} data rank(s), "
          f"{STREAMS_B // mesh.data} each, in {wall:.1f} ms; pts3d, conf, "
          f"emitted and the deferred head 2 against {STREAMS_B} one-stream "
          f"runs: max abs err {worst:.3e} (bound {STREAMS_ATOL:g} abs + "
          f"{STREAMS_RTOL:g} rel) {'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        raise AssertionError(f"streams {label}: the gathered streams differ "
                             f"from the one-stream runs")


def dist_gloo2():
    """(b), (c) and (d): two ranks on the one card over gloo."""
    import torch.distributed as dist

    from spann3r_torch.parallel import mesh as pmesh

    dev = pmesh.init_distributed("cuda", backend="gloo")
    if dist.get_rank() == 0:
        log(f"[dist] two ranks over gloo on CUDA tensors, torch "
            f"{torch.__version__}")
    _gloo_layouts(dev)
    _gloo_memory(dev)
    dist_streams(dev, "two ranks over gloo")
    dist.destroy_process_group()


def _gloo_layouts(dev):
    """(b): each layout on the narrow FP32 configuration against the
    one-process step on the global batch."""
    import torch.distributed as dist

    from spann3r_torch import config, training
    from spann3r_torch.models import spann3r as sp
    from spann3r_torch.parallel import mesh as pmesh
    from spann3r_torch.parallel import sharding

    rank = dist.get_rank()
    cfg = parity_train_cfg()
    batch = uneven_batch(PARITY_TRAIN_T, 2, HW_224, DIST_KEEP, SEED + 40)
    model = sp.build_spann3r(cfg, dev, torch.Generator().manual_seed(SEED))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    loss, _, ref = training.value_and_grad(
        model, cfg, config.FP32, training.batch_to_device(batch, dev), None,
        0.4)
    ref_loss, gmax = float(loss), max(float(g.abs().max())
                                      for g in ref.values())
    for name, (model_axis, fsdp) in GLOO_LAYOUTS.items():
        mesh = pmesh.make_mesh(model_axis)
        m = sp.build_spann3r(cfg, dev)
        m.load_state_dict(init)
        layout = sharding.Layout(m, cfg, mesh, fsdp, DIST_MIN_DIM)
        layout.shard_model_(m)
        local = rank_part(batch, mesh.data_rank, mesh.data)
        l, _, g = training.value_and_grad(
            m, cfg, config.FP32, training.batch_to_device(local, dev), None,
            0.4, layout=layout)
        g = layout.reduce_grads(g)
        want = layout.shard_tensors(ref)
        tol = DIST_TP_TOL if model_axis > 1 else DIST_TOL
        ok, dl, dg = grads_agree(float(l), g, ref_loss, want, gmax, tol)
        fault = ""
        if mesh.data > 1:
            avg = {k: v / mesh.data for k, v in g.items()}
            caught = not grads_agree(float(l), avg, ref_loss, want, gmax,
                                     tol)[0]
            fault = (f"; planted fault (gradients averaged over the data "
                     f"group): {'caught' if caught else 'NOT caught'}")
            ok = ok and caught
        opt = training.make_optimizer(0.05)
        st = opt.init(dict(m.named_parameters()))
        step = training.make_train_step(cfg, config.FP32, opt,
                                        grads_bf16=False, layout=layout)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, _ = step(m, st, local, None, 1e-4, 0.4)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        print(f"[dist] gloo {name} rank {rank} ({layout.describe()}): loss "
              f"rel err {dl:.3e}, grads max err {dg:.3e} of max |grad| "
              f"{gmax:.3e} (bound {tol:g}) {'ok' if ok else 'FAILED'}"
              f"{fault}; FP32 step ms {[round(x, 1) for x in walls]} "
              f"(host-bound gloo, not NCCL)", flush=True)
        if not ok:
            raise AssertionError(f"gloo {name}: the step disagrees with the "
                                 f"one-process step on the global batch")
        del m, st, step, layout
        torch.cuda.empty_cache()


def _gloo_memory(dev):
    """(c): the state and peak memory of two full-width ranks, --fsdp 0
    and 1."""
    import torch.distributed as dist

    from spann3r_torch import config, training
    from spann3r_torch.models import spann3r as sp
    from spann3r_torch.parallel import mesh as pmesh
    from spann3r_torch.parallel import sharding

    rank = dist.get_rank()
    full = config.Spann3RConfig(dust3r=config.DUSt3RConfig(img_size=HW_224,
                                                           head_type="dpt"))
    batch = [rank_part(b, rank, 2) for b in train_batches(MEM_STEPS, 2)]
    mesh = pmesh.make_mesh(1)
    for fsdp in (False, True):
        m = sp.build_spann3r(full, dev, torch.Generator().manual_seed(SEED))
        layout = sharding.Layout(m, full, mesh, fsdp)
        layout.shard_model_(m)
        opt = training.make_optimizer(0.05, moment_dtype=torch.bfloat16)
        st = opt.init(dict(m.named_parameters()))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        predicted = state_bytes(layout.shapes, set(layout.fsdp), 2, 2)
        step = training.make_train_step(full, config.BF16, opt,
                                        grads_bf16=True, layout=layout)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        walls = []
        for b in batch:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, mt = step(m, st, b, gen, TRAIN_LR, 0.4)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        if not np.isfinite(float(mt["loss"])):
            raise AssertionError("full width over gloo: loss not finite")
        print(f"[dist] full width 224 BF16 B=1 x T={TRAIN_T} a rank, "
              f"--fsdp {int(fsdp)}, rank {rank} ({layout.describe()}): state "
              f"held before the step {held / 2**30:.3f} GiB (predicted "
              f"master + moments {predicted / 2**30:.3f} GiB); peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
              f"(max_memory_allocated); step ms "
              f"{[round(x, 1) for x in walls]} (host-bound gloo)", flush=True)
        del m, st, step, layout
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 13: CroCo pretraining
# ---------------------------------------------------------------------------

# two published CroCo configurations at 224: the pretraining CLI's default
# (croco/pretrain.py's --model: encoder 12 x 768 / 12 heads, decoder 8 x 512
# / 16 heads, head dim 32, cosine positions) and the CroCo v2 ViT-L / Base
# decoder that DUSt3R and Spann3R start from (RoPE100); the CLI's batch of
# 64, --amp 1 (bf16), PRETRAIN_STEPS steps on one fixed batch and mask at a
# constant PRETRAIN_LR
PRETRAIN_MODELS = {
    "CroCoNet()": "CroCoNet()",
    "v2 ViT-L/Base": ("CroCoNet(enc_embed_dim=1024, enc_depth=24, "
                      "enc_num_heads=16, dec_embed_dim=768, dec_depth=12, "
                      "dec_num_heads=12, pos_embed='RoPE100')")}
PRETRAIN_B, PRETRAIN_STEPS, PRETRAIN_LR = 64, 5, 1e-4
# the CLI run: box-room pairs at 112 x 112 (the crops of 224 upsample
# them), a short epoch of PRETRAIN_CLI_PAIRS pairs at batch 8
PRETRAIN_CLI_PAIRS, PRETRAIN_CLI_B = 16, 8
# the narrow FP32 configuration of the card-vs-CPU step: head dim 64 in the
# encoder, 32 in the decoder, RoPE100 (K2 at both head dims, K3)
PRETRAIN_PARITY_MODEL = ("CroCoNet(enc_embed_dim=256, enc_depth=2, "
                         "enc_num_heads=4, dec_embed_dim=128, dec_depth=2, "
                         "dec_num_heads=4, pos_embed='RoPE100')")


def pretrain_launches(cfg):
    """Kernel launches of one pretrain step: the encoder twice (image 1's
    visible tokens, image 2 whole), then the decoder blocks, each with a
    self and a cross attention; every attention one K2 forward and one
    backward, and with RoPE one K3 on q and k each way; no K1."""
    attn = 2 * cfg.enc.depth + 2 * cfg.dec.depth
    rope = attn if cfg.enc.rope_base > 0 else 0
    return {"rope2d": rope, "sdpa": attn, "memory_read": 0, "sdpa_bwd": attn,
            "rope2d_bwd": rope}


def phase_pretrain(records, card):
    """(a), (b) each configuration of PRETRAIN_MODELS for PRETRAIN_STEPS
    steps: launches of step 1 against pretrain_launches, finite losses, the
    last below the first, the median step of steps 2-5, peak memory,
    images/s; then the CLI under torchrun on generated box-room pairs, its
    resume and the demo on its checkpoint (pretrain_cli); then the FP32
    step card against CPU (pretrain_parity)."""
    from spann3r_torch import config as C
    from spann3r_torch import pretraining as P
    from spann3r_torch.models import croco_pretrain as cp
    from spann3r_torch.ops import _kernels

    t_phase = time.perf_counter()
    for name, model_str in PRETRAIN_MODELS.items():
        cfg, ratio = cp.parse_croco_model(model_str)
        torch.cuda.empty_cache()
        model = cp.build_croco(cfg, "cuda", torch.Generator().manual_seed(SEED))
        n_params = sum(p.numel() for p in model.parameters())
        g = torch.Generator(device="cuda").manual_seed(SEED)
        img1, img2 = (torch.randn(PRETRAIN_B, *HW_224, 3, generator=g,
                                  device="cuda") for _ in range(2))
        mask = cp.random_mask(g, PRETRAIN_B, P.num_patches(cfg), ratio,
                              "cuda")
        opt = P.make_pretrain_optimizer(0.05)
        state = opt.init(dict(model.named_parameters()))
        step, _, _ = P.make_pretrain_step(ratio, C.BF16, opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls, losses = [], []
        for i in range(PRETRAIN_STEPS):
            torch.cuda.synchronize()
            if i == 0:
                _kernels.reset_launches()
            t0 = time.perf_counter()
            state, loss = step(model, state, img1, img2, mask, PRETRAIN_LR)
            losses.append(float(loss))
            walls.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                counts = _kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        want = pretrain_launches(cfg)
        med = statistics.median(walls[1:])
        log(f"[pretrain] {name}: {n_params} params, enc {cfg.enc.depth} x "
            f"{cfg.enc.dim}/{cfg.enc.num_heads} heads (head dim "
            f"{cfg.enc.head_dim}), dec {cfg.dec.depth} x {cfg.dec.dim}/"
            f"{cfg.dec.num_heads} (head dim {cfg.dec.head_dim}), "
            f"{'RoPE100' if cfg.enc.rope_base > 0 else 'cosine'}, 224, "
            f"B={PRETRAIN_B}, mask {ratio}, BF16: launches of step 1 {counts},"
            f" expected {want}")
        log(f"[pretrain] {name}: loss {[round(x, 4) for x in losses]} on one "
            f"batch and mask at lr {PRETRAIN_LR}; step ms "
            f"{[round(x, 1) for x in walls]}, median of steps 2-"
            f"{PRETRAIN_STEPS} {med:.1f} ms ({PRETRAIN_B / med * 1e3:.1f} "
            f"images/s); peak memory {peak / 2**30:.2f} GiB on {card}")
        if counts != want:
            raise AssertionError(f"pretrain {name}: launches {counts}, "
                                 f"expected {want}")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"pretrain {name}: losses {losses}")
        for k in counts:
            records[k].setdefault("pretrain_launches", {})[name] = counts[k]
        records["sdpa"].setdefault("pretrain", {})[name] = {
            "step_ms": med, "images_per_s": PRETRAIN_B / med * 1e3,
            "peak_gib": peak / 2**30, "params": n_params}
        del model, state, step, opt, img1, img2
    torch.cuda.empty_cache()
    pretrain_cli()
    pretrain_parity()
    log(f"[pretrain] phase took {time.perf_counter() - t_phase:.1f} s")


def pretrain_cli():
    """Box-room pairs from `python -m spann3r_torch.habitat_gen.scripts`,
    their pairs.txt, then `python -m torch.distributed.run --nproc_per_node
    1 -m spann3r_torch.pretrain` (the CLI's defaults: CroCoNet(), crop224 +
    acolor, bf16) for one epoch at batch PRETRAIN_CLI_B, the same command
    again to a second epoch (auto-resume), and `python -m
    spann3r_torch.tools.croco_demo` on its checkpoint."""
    import tempfile

    from spann3r_torch.datasets.pairs import parse_and_cache_all_pairs

    here = os.path.dirname(os.path.abspath(__file__))

    def run(cmd, what):
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=here, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                start_new_session=True)
        try:
            out = proc.communicate(timeout=DIST_WORKER_TIMEOUT)[0]
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.communicate()
        lines = out.splitlines()
        if proc.returncode != 0:
            raise AssertionError(f"{what} failed:\n" + "\n".join(lines[-60:]))
        return lines, time.perf_counter() - t0

    with tempfile.TemporaryDirectory(prefix="spann3r_pretrain_") as root:
        scene = os.path.join(root, "habitat_release", "scene0")
        _, sec = run([sys.executable, "-m", "spann3r_torch.habitat_gen.scripts",
                      "--scene", "__boxroom__", "--output_dir", scene,
                      "--views_count", "2", "--size", str(PRETRAIN_CLI_PAIRS),
                      "--resolution", "112", "112", "--generate_depth", "0"],
                     "habitat_gen.scripts")
        parse_and_cache_all_pairs("habitat_release", root)
        log(f"[pretrain] habitat_gen.scripts --scene __boxroom__: "
            f"{PRETRAIN_CLI_PAIRS} pairs at 112x112 in {sec:.1f} s")
        out = os.path.join(root, "out")
        cmd = [sys.executable, "-m", "torch.distributed.run",
               "--nproc_per_node", "1", "--master_port", str(_free_port()),
               "-m", "spann3r_torch.pretrain", "--data_dir", root,
               "--output_dir", out, "--batch_size", str(PRETRAIN_CLI_B),
               "--epochs", "4", "--warmup_epochs", "1", "--print_freq", "1",
               "--keep_freq", "0"]
        steps = PRETRAIN_CLI_PAIRS // PRETRAIN_CLI_B
        for epoch in (0, 1):
            lines, sec = run(cmd + ["--max_epoch", str(epoch + 1)],
                             f"torchrun pretrain epoch {epoch}")
            done = [x for x in lines if x.startswith(f"E{epoch} it")]
            resumed = any(x.startswith(f"auto-resumed from epoch {epoch}")
                          for x in lines)
            if len(done) != steps or (epoch == 1 and not resumed) or \
                    not any("process 0/1" in x for x in lines):
                raise AssertionError(f"torchrun pretrain epoch {epoch}:\n"
                                     + "\n".join(lines[-40:]))
            log(f"[pretrain] torchrun --nproc_per_node 1 -m "
                f"spann3r_torch.pretrain (CroCoNet(), B={PRETRAIN_CLI_B}) "
                f"epoch {epoch}{' (resumed)' if epoch else ''}: "
                f"{[x.strip() for x in done]} in {sec:.1f} s")
        png = os.path.join(out, "demo.png")
        first = sorted(f for f in os.listdir(scene) if f.endswith("_1.jpeg"))[0]
        _, sec = run([sys.executable, "-m", "spann3r_torch.tools.croco_demo",
                      "--img1", os.path.join(scene, first), "--img2",
                      os.path.join(scene, first.replace("_1.", "_2.")),
                      "--ckpt", out, "--output", png], "croco_demo")
        import PIL.Image
        shape = np.asarray(PIL.Image.open(png)).shape
        log(f"[pretrain] croco_demo on checkpoint-last: {shape} image in "
            f"{sec:.1f} s")
        if shape != (224, 4 * 224, 3):
            raise AssertionError(f"croco_demo wrote a {shape} image")


def pretrain_parity():
    """One FP32 pretrain step's loss and gradients on the card (kernels)
    and on the CPU (plain versions), the same weights, images and mask:
    loss within E2E_TOL relative, every gradient within E2E_TOL of the
    largest |grad|; launches on the card as pretrain_launches."""
    from spann3r_torch import config as C
    from spann3r_torch import pretraining as P
    from spann3r_torch.models import croco_pretrain as cp
    from spann3r_torch.ops import _kernels

    cfg, ratio = cp.parse_croco_model(PRETRAIN_PARITY_MODEL)
    g = torch.Generator().manual_seed(SEED + 40)
    img1, img2 = (torch.randn(2, *HW_224, 3, generator=g) for _ in range(2))
    mask = cp.random_mask(g, 2, P.num_patches(cfg), ratio)
    out = {}
    for dev in ("cuda", "cpu"):
        model = cp.build_croco(cfg, dev, torch.Generator().manual_seed(SEED))
        if dev == "cuda":
            _kernels.reset_launches()
        t0 = time.perf_counter()
        loss, grads = P.pretrain_loss_and_grads(
            model, img1.to(dev), img2.to(dev), mask.to(dev), ratio, C.FP32)
        out[dev] = (float(loss), {k: v.cpu() for k, v in grads.items()},
                    time.perf_counter() - t0)
        if dev == "cuda":
            counts = _kernels.launch_counts()
    (lg, gg, sg), (lc, gc, sc) = out["cuda"], out["cpu"]
    gmax = max(float(v.abs().max()) for v in gc.values())
    worst = max(gc, key=lambda k: float((gg[k] - gc[k]).abs().max()))
    err = float((gg[worst] - gc[worst]).abs().max())
    log(f"[parity] one FP32 pretrain step, {PRETRAIN_PARITY_MODEL} at 224, "
        f"B=2 (head dims {cfg.enc.head_dim} / {cfg.dec.head_dim}): loss card "
        f"{lg:.6f} CPU {lc:.6f}; grads max abs err {err:.3e} ({worst}) = "
        f"{err / gmax:.3e} of max |grad| {gmax:.3e} (bound {E2E_TOL}); "
        f"launches on the card {counts}, expected {pretrain_launches(cfg)}; "
        f"{sg:.2f} s on the card, {sc:.2f} s on the CPU")
    if counts != pretrain_launches(cfg):
        raise AssertionError("pretrain parity: launches differ from the code")
    if abs(lg - lc) > E2E_TOL * abs(lc) or err > E2E_TOL * gmax:
        raise AssertionError("pretrain parity: card and CPU disagree")


# ---------------------------------------------------------------------------
# phase 15: stereo and flow finetuning
# ---------------------------------------------------------------------------

# CroCo-Stereo's and CroCo-Flow's published recipes (croco/stereoflow/
# train.py's defaults: crop, batch, criterion, lr; bf16) on the CroCo v2
# ViT-L / Base decoder with RoPE100 they finetune (PRETRAIN_MODELS' v2), at
# random init from seed 0 (no published weights here): (dataset kind,
# training split, crop, B, criterion, lr, steps) on a fixture tree at the
# dataset's raw size, every step on one fixed batch of augmented crops
STEREOFLOW_MODEL = PRETRAIN_MODELS["v2 ViT-L/Base"]
STEREOFLOW_CELLS = {
    "stereo": ("SceneFlow", "SceneFlow(split='train_finalpass')", (352, 704),
               6, "LaplacianLossBounded2()", 3e-5, 5),
    "flow": ("FlyingChairs", "FlyingChairs(split='train')", (320, 384), 8,
             "LaplacianLossBounded()", 2e-5, 3)}
# the tiled test: a SceneFlow test pair at its raw 540x960, 9 tiles of the
# stereo crop at overlap 0.7 in chunks of tile_batch = 8 (2 chunks)
STEREOFLOW_TILE_BATCH, STEREOFLOW_OVERLAP = 8, 0.7
# the CLIs' model, narrow so that their checkpoints stay small (head dim
# 64, RoPE100: K2 and K3 as at full width), and the card-vs-CPU step's
STEREOFLOW_CLI_MODEL = ("CroCoNet(enc_embed_dim=256, enc_depth=4, "
                        "enc_num_heads=4, dec_embed_dim=256, dec_depth=2, "
                        "dec_num_heads=4, pos_embed='RoPE100')")
STEREOFLOW_PARITY_HW = (64, 96)


def stereoflow_launches(cfg, task, chunks=1):
    """Kernel launches of one stereo or flow train step ("stereo", "flow"):
    the encoder once over both images (one attention a block), the
    decoder's self and cross attention a block, each one K2 forward and
    one backward, with RoPE one K3 on q and k each way; no K1. A tiled
    prediction ("tiled") runs the forward once a chunk of tiles."""
    attn = cfg.enc.depth + 2 * cfg.dec.depth
    rope = attn if cfg.enc.rope_base > 0 else 0
    if task == "tiled":
        return {"rope2d": chunks * rope, "sdpa": chunks * attn,
                "memory_read": 0, "sdpa_bwd": 0, "rope2d_bwd": 0}
    return {"rope2d": rope, "sdpa": attn, "memory_read": 0, "sdpa_bwd": attn,
            "rope2d_bwd": rope}


def stereoflow_batch(task, b, seed=SEED):
    """One batch of the training split through the dataset's augmentor
    (the crop), as numpy (img1, img2, gt)."""
    from spann3r_torch.stereoflow import datasets as sfd
    from spann3r_torch.stereoflow.engine import iterate_batches

    _, dataset, crop = STEREOFLOW_CELLS[task][:3]
    build = (sfd.get_train_dataset_stereo if task == "stereo"
             else sfd.get_train_dataset_flow)
    ds = build(dataset, crop_size=crop, seed=seed)
    return next(iterate_batches(ds, b, np.random.default_rng(seed)))[:3]


def phase_stereoflow(records, card):
    """(a), (b) each cell of STEREOFLOW_CELLS at full width: launches of
    step 1 against stereoflow_launches, finite losses, the last below the
    first, the median step (steps 2 on), pairs/s, peak memory; then the
    tiled prediction of one 540x960 SceneFlow pair at full width (launches
    against stereoflow_launches(.., "tiled", 2), seconds); (c) the CLIs
    (stereoflow_cli); (d) one FP32 step card against CPU
    (stereoflow_parity)."""
    import tempfile

    from spann3r_torch import config as C
    from spann3r_torch.models.croco_downstream import croco_kwargs_from_cfg
    from spann3r_torch.models.croco_pretrain import parse_croco_model
    from spann3r_torch.ops import _kernels
    from spann3r_torch.stereoflow import criterion as sfc
    from spann3r_torch.stereoflow import datasets as sfd
    from spann3r_torch.stereoflow import engine as sfe
    from spann3r_torch.tools import stereoflow_fixtures as fx

    t_phase = time.perf_counter()
    kwargs = croco_kwargs_from_cfg(parse_croco_model(STEREOFLOW_MODEL)[0])
    with tempfile.TemporaryDirectory(prefix="spann3r_stereoflow_") as root:
        t0 = time.perf_counter()
        fx.write_tree("SceneFlow", root, seed=SEED, pairs=6)
        fx.write_tree("FlyingChairs", root, seed=SEED + 1, pairs=10)
        sfd.DATA_ROOT = root
        log(f"[stereoflow] fixture trees: SceneFlow 6 + 1 pairs at "
            f"{fx.RAW_SIZES['SceneFlow']}, FlyingChairs 8 + 2 at "
            f"{fx.RAW_SIZES['FlyingChairs']} in {time.perf_counter() - t0:.1f}"
            f" s")
        for task, (kind, _, crop, b, spec, lr, steps) in \
                STEREOFLOW_CELLS.items():
            cfg = sfe.cfg_from_croco_args(kwargs, crop)
            crit = sfc.build_criterion(spec)
            nc = (1 if task == "stereo" else 2) + int(crit.with_conf)
            torch.cuda.empty_cache()
            model, _ = sfe.init_stereoflow(
                torch.Generator().manual_seed(SEED), cfg, nc, "cuda")
            n_params = sum(p.numel() for p in model.parameters())
            img1, img2, gt = (torch.from_numpy(a).cuda()
                              for a in stereoflow_batch(task, b))
            opt = sfe.make_optimizer(0.05)
            state = opt.init(dict(model.named_parameters()))
            step = sfe.make_train_step(cfg, crit, task, opt, C.BF16)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            walls, losses = [], []
            for i in range(steps):
                torch.cuda.synchronize()
                if i == 0:
                    _kernels.reset_launches()
                t0 = time.perf_counter()
                state, loss, bm = step(model, state, img1, img2, gt, lr)
                losses.append(float(loss))
                walls.append((time.perf_counter() - t0) * 1e3)
                if i == 0:
                    counts = _kernels.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            want = stereoflow_launches(cfg, task)
            med = statistics.median(walls[1:])
            log(f"[stereoflow] {task}: {STEREOFLOW_MODEL}, {n_params} params,"
                f" crop {crop} ({cfg.img_size[0] // 16}x{cfg.img_size[1] // 16}"
                f" tokens), B={b}, {spec}, lr {lr}, BF16: launches of step 1 "
                f"{counts}, expected {want}")
            last = {k: round(float(v), 3) for k, v in bm.items()}
            log(f"[stereoflow] {task}: loss {[round(x, 4) for x in losses]} "
                f"on one batch; metrics of the last step {last}; step ms "
                f"{[round(x, 1) for x in walls]}, median of steps 2-{steps} "
                f"{med:.1f} ms ({b / med * 1e3:.2f} pairs/s); peak memory "
                f"{peak / 2**30:.2f} GiB on {card}")
            if counts != want:
                raise AssertionError(f"stereoflow {task}: launches {counts}, "
                                     f"expected {want}")
            if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
                raise AssertionError(f"stereoflow {task}: losses {losses}")
            for k in counts:
                records[k].setdefault("stereoflow_launches", {})[task] = \
                    counts[k]
            records["sdpa"].setdefault("stereoflow", {})[task] = {
                "step_ms": med, "pairs_per_s": b / med * 1e3,
                "peak_gib": peak / 2**30, "params": n_params}
            del state, step, opt, img1, img2, gt
            if task == "stereo":
                stereoflow_tiled(records, model, cfg, crit, card)
            del model
        torch.cuda.empty_cache()
        stereoflow_cli(root)
    stereoflow_parity()
    log(f"[stereoflow] phase took {time.perf_counter() - t_phase:.1f} s")


def stereoflow_tiled(records, model, cfg, crit, card):
    """One SceneFlow test pair at its raw 540x960 through tiled_pred with
    the test CLI's model function (chunks of tiles on the card), BF16:
    the launches of K2 and K3 against stereoflow_launches, the prediction
    finite and of the pair's size, the seconds a pair (median of 3 after a
    first)."""
    from spann3r_torch import config as C
    from spann3r_torch.ops import _kernels
    from spann3r_torch.stereoflow import datasets as sfd
    from spann3r_torch.stereoflow.engine import make_tile_fn
    from spann3r_torch.stereoflow.tiling import tile_slices, tiled_pred

    img1, img2, gt, _ = sfd.get_test_datasets_stereo(
        "SceneFlow(split='test_finalpass')")[0][0]
    h, w = img1.shape[:2]
    crop = cfg.img_size
    n_tiles = (len(tile_slices(h, crop[0], STEREOFLOW_OVERLAP))
               * len(tile_slices(w, crop[1], STEREOFLOW_OVERLAP)))
    chunks = -(-n_tiles // STEREOFLOW_TILE_BATCH)
    fn = make_tile_fn(model, cfg, C.BF16)

    def run():
        return tiled_pred(fn, None, img1[None], img2[None], gt[None],
                          crop=crop, overlap=STEREOFLOW_OVERLAP,
                          conf_mode="conf_expsigmoid_15_3",
                          with_conf=crit.with_conf,
                          tile_batch=STEREOFLOW_TILE_BATCH)[0]

    torch.cuda.synchronize()
    _kernels.reset_launches()
    pred = run()
    counts = _kernels.launch_counts()
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        secs.append(time.perf_counter() - t0)
    want = stereoflow_launches(cfg, "tiled", chunks)
    log(f"[stereoflow] tiled test: a {h}x{w} pair, {n_tiles} tiles of {crop} "
        f"at overlap {STEREOFLOW_OVERLAP} in {chunks} chunks of "
        f"{STEREOFLOW_TILE_BATCH}: launches {counts}, expected {want}; "
        f"{statistics.median(secs):.3f} s a pair (median of "
        f"{[round(x, 3) for x in secs]}) on {card}")
    if counts != want:
        raise AssertionError(f"stereoflow tiled: launches {counts}, expected "
                             f"{want}")
    if pred.shape != (1, h, w, 1) or not np.isfinite(pred).all():
        raise AssertionError(f"stereoflow tiled: prediction {pred.shape}")
    for k in counts:
        records[k].setdefault("stereoflow_launches", {})["tiled"] = counts[k]
    records["sdpa"].setdefault("stereoflow", {})["tiled_s_per_pair"] = \
        statistics.median(secs)


def stereoflow_cli(root):
    """`python -m spann3r_torch.stereoflow_train stereo` on the SceneFlow
    fixture (STEREOFLOW_CLI_MODEL at the published crop, B = 2, one epoch
    of 4 pairs, tiled validation on the test pair), then `python -m
    spann3r_torch.stereoflow_test --save metrics pred visu` on its output:
    the checkpoints, sidecar and log, finite metrics, the dumps."""
    import pickle
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, SPANN3R_STEREOFLOW_DATA=root)
    out = os.path.join(root, "run")
    val = "SceneFlow(split='test_finalpass')"
    for what, cmd in (
            ("stereoflow_train", [
                "spann3r_torch.stereoflow_train", "stereo", "--output_dir",
                out, "--model", STEREOFLOW_CLI_MODEL, "--dataset",
                STEREOFLOW_CELLS["stereo"][1], "--val_dataset", val,
                "--batch_size", "2", "--img_per_epoch", "4", "--epochs",
                "1"]),
            ("stereoflow_test", [
                "spann3r_torch.stereoflow_test", "--model", out, "--dataset",
                val, "--save", "metrics", "pred", "visu"])):
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", *cmd], cwd=here,
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                start_new_session=True)
        try:
            lines = proc.communicate(timeout=DIST_WORKER_TIMEOUT)[0]
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.communicate()
        lines = lines.splitlines()
        if proc.returncode != 0:
            raise AssertionError(f"{what} failed:\n" + "\n".join(lines[-60:]))
        log(f"[stereoflow] python -m spann3r_torch.{what}: "
            f"{time.perf_counter() - t0:.1f} s; {lines[-1][:300]}")
    files = [f for _, _, fs in os.walk(out) for f in fs]
    metrics = [os.path.join(r, f) for r, _, fs in os.walk(out) for f in fs
               if f == "metrics.pkl"]
    need = ("checkpoint-last.pth", "checkpoint-best.pth",
            "stereoflow_args.json", "log.txt")
    if not all(f in files for f in need) or len(metrics) != 1 or not any(
            f.endswith("_pred.npy") for f in files) or not any(
            f.endswith("_pred.png") for f in files):
        raise AssertionError(f"stereoflow CLIs wrote {sorted(files)}")
    with open(metrics[0], "rb") as f:
        m = pickle.load(f)
    log(f"[stereoflow] stereoflow_test metrics {m}")
    if not all(np.isfinite(v) for v in m.values()):
        raise AssertionError(f"stereoflow_test metrics {m}")


def stereoflow_parity():
    """One FP32 stereo step's loss and gradients on the card (kernels) and
    on the CPU (plain versions), the same weights and batch: loss within
    E2E_TOL relative, every gradient within E2E_TOL of the largest |grad|;
    launches on the card as stereoflow_launches."""
    from spann3r_torch import config as C
    from spann3r_torch.models.croco_downstream import croco_kwargs_from_cfg
    from spann3r_torch.models.croco_pretrain import parse_croco_model
    from spann3r_torch.ops import _kernels
    from spann3r_torch.stereoflow import criterion as sfc
    from spann3r_torch.stereoflow import engine as sfe

    cfg = sfe.cfg_from_croco_args(croco_kwargs_from_cfg(parse_croco_model(
        STEREOFLOW_CLI_MODEL)[0]), STEREOFLOW_PARITY_HW)
    crit = sfc.build_criterion(STEREOFLOW_CELLS["stereo"][4])
    g = torch.Generator().manual_seed(SEED + 50)
    img1, img2 = (torch.randn(2, *STEREOFLOW_PARITY_HW, 3, generator=g)
                  for _ in range(2))
    gt = torch.rand(2, *STEREOFLOW_PARITY_HW, 1, generator=g) * 20
    gt[0, :8] = float("inf")
    out = {}
    for dev in ("cuda", "cpu"):
        model, _ = sfe.init_stereoflow(torch.Generator().manual_seed(SEED),
                                       cfg, 2, dev)
        if dev == "cuda":
            _kernels.reset_launches()
        t0 = time.perf_counter()
        loss, grads, _ = sfe.stereoflow_loss_and_grads(
            model, cfg, crit, img1.to(dev), img2.to(dev), gt.to(dev), C.FP32)
        out[dev] = (float(loss), {k: v.cpu() for k, v in grads.items()},
                    time.perf_counter() - t0)
        if dev == "cuda":
            counts = _kernels.launch_counts()
    (lg, gg, sg), (lc, gc, sc) = out["cuda"], out["cpu"]
    gmax = max(float(v.abs().max()) for v in gc.values())
    worst = max(gc, key=lambda k: float((gg[k] - gc[k]).abs().max()))
    err = float((gg[worst] - gc[worst]).abs().max())
    want = stereoflow_launches(cfg, "stereo")
    log(f"[parity] one FP32 stereo step, {STEREOFLOW_CLI_MODEL} at "
        f"{STEREOFLOW_PARITY_HW}, B=2: loss card {lg:.6f} CPU {lc:.6f}; grads "
        f"max abs err {err:.3e} ({worst}) = {err / gmax:.3e} of max |grad| "
        f"{gmax:.3e} (bound {E2E_TOL}); launches on the card {counts}, "
        f"expected {want}; {sg:.2f} s on the card, {sc:.2f} s on the CPU")
    if counts != want:
        raise AssertionError("stereoflow parity: launches differ from the code")
    if abs(lg - lc) > E2E_TOL * abs(lc) or err > E2E_TOL * gmax:
        raise AssertionError("stereoflow parity: card and CPU disagree")


def train_batches(n, b=TRAIN_B, dataset=TRAIN_DATASET):
    """n batches of b clips of TRAIN_T frames at 224 through the trainer's
    dataset, sampler and loader (phase 10's: SynthRoom by default)."""
    from spann3r_torch.datasets import build_dataset, make_sampler
    from spann3r_torch.datasets.loader import DataLoader

    ds = build_dataset(dataset)
    ds.set_epoch(0)
    ds.set_ratio(1.0)
    sampler = make_sampler(ds, b)
    sampler.set_epoch(0)
    batches = list(DataLoader(ds, b, sampler=sampler, num_workers=2))[:n]
    if len(batches) < n or batches[0]["img"].shape != (TRAIN_T, b, *HW_224,
                                                       3):
        raise AssertionError(f"train batches: {len(batches)} of shape "
                             f"{batches[0]['img'].shape}")
    return batches


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="FILE",
                    help="profile one more slice run with torch.profiler "
                         "and write the summary to FILE, and one more "
                         "offline run to FILE with _offline before its "
                         "extension")
    ap.add_argument("--dist-worker", choices=("world1", "gloo2"),
                    help=argparse.SUPPRESS)   # one rank of phase 12
    args = ap.parse_args()
    if args.dist_worker:
        from spann3r_torch.config import set_tf32_policy
        set_tf32_policy()
        {"world1": dist_world1, "gloo2": dist_gloo2}[args.dist_worker]()
        return
    card = phase_card()
    phase_build()
    records = {}
    phase_kernels(records)
    cfg, model = build_model()
    phase_slice(records, cfg, model, card, args.profile)
    phase_offline(records, cfg, model, card, args.profile)
    phase_engine(cfg, model)
    phase_serving(cfg, model, card)
    phase_entry(cfg, model, card)
    phase_align(records, cfg, model, card)
    del model
    torch.cuda.empty_cache()
    train_ms = phase_train(records, card)
    phase_gate(card)
    phase_dist(card, train_ms)
    phase_parity()
    phase_parity_train()
    phase_pretrain(records, card)
    phase_stereoflow(records, card)
    print(json.dumps({"kernels": [records[k] for k in (
        "rope2d", "sdpa", "memory_read", "sdpa_bwd", "rope2d_bwd")]}))
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
