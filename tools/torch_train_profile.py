#!/usr/bin/env python3
"""Where the time of one train step of the port goes, on one CUDA card.

    python3 tools/torch_train_profile.py [--steps 6] [--conv-autotune]
                                          [--out FILE]

The training phase's setting of chip_smoke.py: the training CLI's default
configuration (224x224 DPT, full published width, random weights from
seed 0), B = 2 SynthRoom clips of T = 5 frames, BF16 with bf16 gradients
and moments, memory dropout, lr 5e-5. After two warm-up steps, each of
--steps steps is taken apart, host clock with torch.cuda.synchronize()
around each part: the batch to the card, the bf16 working copy
(`work_params`), the forward and loss, the backward
(`torch.autograd.grad`), the global norm, the optimizer's update and its
application; the median of each part and of their sum. Then one whole
step under torch.profiler: device time and launches by kernel name and
the device's busy share (the union of the kernel intervals against the
profiled wall), written to FILE (default output/train_profile.txt) and
summarised on stdout; between them, the wall of three whole steps.

--conv-autotune turns on the convolution library's algorithm search
(benchmark mode) for the run, to measure what the algorithm choice of the
fp32 DPT heads costs; the port itself leaves it off.
"""
from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--conv-autotune", action="store_true")
    ap.add_argument("--out", default=os.path.join(REPO, "output",
                                                  "train_profile.txt"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_train_profile: needs a CUDA device")

    import chip_smoke as cs
    from spann3r_torch import config, training
    from spann3r_torch.datasets import build_dataset, make_sampler
    from spann3r_torch.datasets.loader import DataLoader
    from spann3r_torch.models import spann3r as sp

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    config.set_tf32_policy()
    torch.backends.cudnn.benchmark = bool(args.conv_autotune)
    cfg = config.Spann3RConfig(dust3r=config.DUSt3RConfig(img_size=cs.HW_224,
                                                          head_type="dpt"))
    model = sp.build_spann3r(cfg, "cuda", torch.Generator().manual_seed(0))
    ds = build_dataset(cs.TRAIN_DATASET)
    ds.set_epoch(0)
    ds.set_ratio(1.0)
    sampler = make_sampler(ds, cs.TRAIN_B)
    sampler.set_epoch(0)
    batches = list(DataLoader(ds, cs.TRAIN_B, sampler=sampler, num_workers=2))
    opt = training.make_optimizer(0.05, moment_dtype=torch.bfloat16)
    state = opt.init(dict(model.named_parameters()))
    step = training.make_train_step(cfg, config.BF16, opt, grads_bf16=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for i in range(2):
        state, _ = step(model, state, batches[i], gen, cs.TRAIN_LR, 0.4)

    parts = {k: [] for k in ("to_device", "work_params", "forward+loss",
                             "backward", "global_norm", "optimizer",
                             "apply", "sum")}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        parts[name].append((time.perf_counter() - t0) * 1e3)
        return out

    loss_mod = training._TrainLoss(model, cfg, config.BF16, False)
    for i in range(args.steps):
        raw = batches[(2 + i) % len(batches)]
        batch = timed("to_device", lambda: training.batch_to_device(raw, "cuda"))
        wp = timed("work_params", lambda: training.work_params(model,
                                                               config.BF16))

        def forward():
            with torch.enable_grad():
                return torch.func.functional_call(
                    loss_mod, {f"model.{n}": t for n, t in wp.items()},
                    (batch, gen, 0.4), tie_weights=False)[0]
        loss = timed("forward+loss", forward)
        grads = timed("backward", lambda: torch.autograd.grad(
            loss, list(wp.values()), allow_unused=True))
        grads = {n: torch.zeros_like(t) if g is None else g
                 for (n, t), g in zip(wp.items(), grads)}
        timed("global_norm", lambda: training.global_norm_f32(grads.values()))
        params = dict(model.named_parameters())
        updates, state = timed("optimizer", lambda: opt.update(grads, state,
                                                               params))
        timed("apply", lambda: training.apply_updates_(params, updates,
                                                       cs.TRAIN_LR))
        parts["sum"].append(sum(parts[k][-1] for k in parts if k != "sum"))
        del loss, grads, updates, wp
    lines = [f"one train step of the full-width model, 224x224 BF16, B="
             f"{cs.TRAIN_B} T={cs.TRAIN_T}, conv autotune "
             f"{bool(args.conv_autotune)}, on {card}",
             "part\tmedian ms\tall ms"]
    for k, v in parts.items():
        lines.append(f"{k}\t{statistics.median(v):.1f}\t"
                     f"{[round(x, 1) for x in v]}")
    walls = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(model, state, batches[i], gen, cs.TRAIN_LR, 0.4)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    lines.append(f"whole make_train_step ms {[round(x, 1) for x in walls]}, "
                 f"median {statistics.median(walls):.1f}")
    busy_ms, prof_wall, by_name, n_events = cs.device_profile(
        lambda: step(model, state, batches[3], gen, cs.TRAIN_LR, 0.4))
    lines.append(f"profiled step: wall {prof_wall:.1f} ms, device busy "
                 f"(union) {busy_ms:.1f} ms ({busy_ms / prof_wall:.3f}), "
                 f"{n_events} device events")
    lines.append("ms\tlaunches\tkernel")
    for name, (ms, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        lines.append(f"{ms:.3f}\t{cnt}\t{name}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    for ln in lines[:14 + 25]:
        print(ln[:200], flush=True)


if __name__ == "__main__":
    main()
