"""Where the time of one CroCo pretrain step of the port goes, on one CUDA
card.

    python -m spann3r_torch.tools.pretrain_profile [--steps 5] [--out FILE]

chip_smoke.py phase 13's setting (run from the repository's root, which
holds chip_smoke.py): each configuration of PRETRAIN_MODELS (CroCoNet()
and the CroCo v2 ViT-L / Base decoder) at 224, B = 64, --amp 1 (bf16
compute against the fp32 weights), random weights and images from seed 0,
one fixed mask. After two warm-up steps, each of --steps steps is taken
apart, host clock with torch.cuda.synchronize() around each part: the mask
draw, the forward and loss (`croco_forward`, `masked_mse`), the backward
(`torch.autograd.grad`), the optimizer's update and its application; the
median of each part and of their sum. Then --steps steps in a row as the
CLI's loop takes them (a new mask each, each loss read back one step
late, one synchronize at the end), in turns without and with the host
read of the mask's row counts before each step that `croco_forward`'s
check makes, three times each: the mean step of each run. Then one whole
step under torch.profiler: device time and launches by kernel name and the
device's busy share (the union of the kernel intervals against the
profiled wall), written to FILE (default output/pretrain_profile.txt) and
summarised on stdout.
"""
from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default=os.path.join(REPO, "output",
                                                  "pretrain_profile.txt"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("pretrain_profile: needs a CUDA device")

    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from spann3r_torch import config
    from spann3r_torch import pretraining as P
    from spann3r_torch.models import croco_pretrain as cp

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    config.set_tf32_policy()
    lines = []
    for name, model_str in cs.PRETRAIN_MODELS.items():
        cfg, ratio = cp.parse_croco_model(model_str)
        model = cp.build_croco(cfg, "cuda", torch.Generator().manual_seed(0))
        g = torch.Generator(device="cuda").manual_seed(0)
        img1, img2 = (torch.randn(cs.PRETRAIN_B, *cs.HW_224, 3, generator=g,
                                  device="cuda") for _ in range(2))
        n = P.num_patches(cfg)
        mask = cp.random_mask(g, cs.PRETRAIN_B, n, ratio, "cuda")
        opt = P.make_pretrain_optimizer(0.05)
        state = opt.init(dict(model.named_parameters()))
        step, _, _ = P.make_pretrain_step(ratio, config.BF16, opt)
        for _ in range(2):
            state, _ = step(model, state, img1, img2, mask, cs.PRETRAIN_LR)

        parts = {k: [] for k in ("mask", "forward+loss", "backward",
                                 "optimizer", "apply", "sum")}

        def timed(part, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            parts[part].append((time.perf_counter() - t0) * 1e3)
            return out

        params = dict(model.named_parameters())
        for _ in range(args.steps):
            timed("mask", lambda: cp.random_mask(g, cs.PRETRAIN_B, n, ratio,
                                                 "cuda"))

            def forward():
                with torch.enable_grad():
                    pred, m, target = cp.croco_forward(
                        model, img1, img2, mask, ratio, config.BF16,
                        check_mask=False)
                    return cp.masked_mse(pred, m, target, norm_pix_loss=True)
            loss = timed("forward+loss", forward)
            grads = timed("backward", lambda: dict(zip(params, torch.autograd
                                                       .grad(loss, list(
                                                           params.values())))))
            updates, state = timed("optimizer", lambda: opt.update(
                grads, state, params))
            timed("apply", lambda: P.apply_updates_(params, updates,
                                                    cs.PRETRAIN_LR))
            parts["sum"].append(sum(parts[k][-1] for k in parts if k != "sum"))
            del loss, grads, updates
        lines += [f"{name}: one pretrain step, 224, B={cs.PRETRAIN_B}, bf16, "
                  f"{sum(p.numel() for p in params.values())} params, on "
                  f"{card}", "part\tmedian ms\tall ms"]
        for k, v in parts.items():
            lines.append(f"{k}\t{statistics.median(v):.1f}\t"
                         f"{[round(x, 1) for x in v]}")
        n_vis = n - int(ratio * n)

        def in_a_row(check: bool) -> float:
            nonlocal state
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pending = None
            for _ in range(args.steps):
                m = cp.random_mask(g, cs.PRETRAIN_B, n, ratio, "cuda")
                if check:
                    cp._check_mask(m, n, n_vis, ratio)
                state, loss = step(model, state, img1, img2, m,
                                   cs.PRETRAIN_LR)
                if pending is not None:
                    float(pending)
                pending = loss
            float(pending)
            return (time.perf_counter() - t0) * 1e3 / args.steps

        rows = {False: [], True: []}
        for _ in range(3):
            for check in (False, True):
                rows[check].append(in_a_row(check))
        for check in (False, True):
            lines.append(f"{args.steps} steps in a row, loss read one late, "
                         f"{'with' if check else 'without'} the mask's host "
                         f"read: ms a step {[round(x, 1) for x in rows[check]]}")
        busy_ms, prof_wall, by_name, n_events = cs.device_profile(
            lambda: step(model, state, img1, img2, mask, cs.PRETRAIN_LR))
        lines.append(f"profiled step: wall {prof_wall:.1f} ms, device busy "
                     f"(union) {busy_ms:.1f} ms ({busy_ms / prof_wall:.3f}), "
                     f"{n_events} device events")
        lines.append("ms\tlaunches\tkernel")
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
        lines += [f"{ms:.3f}\t{cnt}\t{k}" for k, (ms, cnt) in ranked[:40]]
        del model, state, step, opt, params
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    for ln in lines:
        print(ln[:200], flush=True)


if __name__ == "__main__":
    main()
