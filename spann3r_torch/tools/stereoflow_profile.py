"""Where the time of one stereo or flow finetuning step of the port goes, on
one CUDA card.

    python -m spann3r_torch.tools.stereoflow_profile [--steps 3] [--out FILE]

chip_smoke.py phase 15's setting (run from the repository's root, which
holds chip_smoke.py): each cell of STEREOFLOW_CELLS (CroCo-Stereo at
352x704, B = 6; CroCo-Flow at 320x384, B = 8) on the CroCo v2 ViT-L / Base
decoder with RoPE100, bf16 compute against the fp32 weights, random
weights from seed 0 and one fixed batch of random crops and gt. After two
warm-up steps, each of --steps steps is taken apart, host clock with
torch.cuda.synchronize() around each part: the transformer's forward
(encoder and decoder), the fp32 DPT head's forward and the loss, the
backward (`torch.autograd.grad`), the optimizer's update and its
application; the median of each part and of their sum. Then one whole step
under torch.profiler: device time and launches by kernel name and the
device's busy share (the union of the kernel intervals against the
profiled wall), written to FILE (default output/stereoflow_profile.txt)
and summarised on stdout.
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
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(REPO, "output",
                                                  "stereoflow_profile.txt"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("stereoflow_profile: needs a CUDA device")

    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from spann3r_torch import config
    from spann3r_torch.models.croco_downstream import (croco_kwargs_from_cfg,
                                                       downstream_binocular)
    from spann3r_torch.models.croco_pretrain import parse_croco_model
    from spann3r_torch.stereoflow import criterion as sfc
    from spann3r_torch.stereoflow import engine as sfe
    from spann3r_torch.stereoflow.head import pixelwise_dpt_apply

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    config.set_tf32_policy()
    kwargs = croco_kwargs_from_cfg(parse_croco_model(cs.STEREOFLOW_MODEL)[0])
    lines = []
    for task, (_, _, crop, b, spec, lr, _) in cs.STEREOFLOW_CELLS.items():
        cfg = sfe.cfg_from_croco_args(kwargs, crop)
        crit = sfc.build_criterion(spec)
        nc = (1 if task == "stereo" else 2) + 1
        model, _ = sfe.init_stereoflow(torch.Generator().manual_seed(0), cfg,
                                       nc, "cuda")
        g = torch.Generator(device="cuda").manual_seed(0)
        img1, img2 = (torch.randn(b, *crop, 3, generator=g, device="cuda")
                      for _ in range(2))
        gt = torch.rand(b, *crop, nc - 1, generator=g, device="cuda") * 40
        opt = sfe.make_optimizer(0.05)
        state = opt.init(dict(model.named_parameters()))
        step = sfe.make_train_step(cfg, crit, task, opt, config.BF16)
        for _ in range(2):
            state, _, _ = step(model, state, img1, img2, gt, lr)

        parts = {k: [] for k in ("transformer forward", "head forward+loss",
                                 "backward", "optimizer", "apply", "sum")}

        def timed(part, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            parts[part].append((time.perf_counter() - t0) * 1e3)
            return out

        params = dict(model.named_parameters())
        for _ in range(args.steps):
            with torch.enable_grad():
                states = timed("transformer forward", lambda: (
                    downstream_binocular(model.croco, img1, img2, cfg,
                                         lambda s, hw: s, config.BF16)))

                def head():
                    out = pixelwise_dpt_apply(model.head, states, crop,
                                              cfg.patch_size)
                    return crit(out[..., :-1], gt, out[..., -1])
                loss = timed("head forward+loss", head)
                grads = timed("backward", lambda: dict(zip(
                    params, torch.autograd.grad(
                        loss, list(params.values()), allow_unused=True,
                        materialize_grads=True))))
            updates, state = timed("optimizer", lambda: opt.update(
                grads, state, params))
            timed("apply", lambda: sfe.apply_updates_(params, updates, lr))
            parts["sum"].append(sum(parts[k][-1] for k in parts if k != "sum"))
            del states, loss, grads, updates
        lines += [f"{task}: one step, crop {crop}, B={b}, bf16, "
                  f"{sum(p.numel() for p in params.values())} params, on "
                  f"{card}", "part\tmedian ms\tall ms"]
        for k, v in parts.items():
            lines.append(f"{k}\t{statistics.median(v):.1f}\t"
                         f"{[round(x, 1) for x in v]}")
        busy_ms, prof_wall, by_name, n_events = cs.device_profile(
            lambda: step(model, state, img1, img2, gt, lr))
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
