"""Peak memory, step time and kernel launches of the port's train step with
activation rematerialisation off, on (`--remat 1`) and on over the whole
pair body (`--remat 1 --remat_scan 1`), on the card.

    python -m spann3r_torch.tools.train_memory [--out FILE]

The training CLI's configuration: the published width at 224 x 224 with the
DPT heads, random weights from seed 0, BF16 with bf16 gradients against the
bf16 working copy and bf16 Adam moments, memory dropout on, random batches
of B clips of T frames (numpy, seed 0), at B x T = 2 x 5 (the trainer's
default) and 4 x 10 (the clip length the JAX package sized remat_scan for).
For each clip shape and setting it takes STEPS steps and prints one JSON
line: the peak of
`torch.cuda.max_memory_allocated` over the steps and what it adds to the
memory held before the first step (weights, moments), the median wall time
of the steps after the first (each step synchronised), and the kernel
launches of the first step. A setting that does not fit prints "oom".
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np

SETTINGS = {"off": (False, False), "remat": (True, False),
            "remat_scan": (True, True)}
CLIPS = ((2, 5), (4, 10))
STEPS = 3


def random_batch(b: int, t: int, hw=(224, 224), seed: int = 0):
    """A collated (T, B, ...) batch of random frames and pointmaps."""
    rng = np.random.default_rng(seed)
    return {"img": (rng.standard_normal((t, b, *hw, 3)) * 0.5).astype(np.float32),
            "pts3d": (rng.standard_normal((t, b, *hw, 3)) + 2.0).astype(np.float32),
            "valid_mask": rng.random((t, b, *hw)) > 0.2,
            "camera_pose": np.broadcast_to(np.eye(4, dtype=np.float32),
                                           (t, b, 4, 4)).copy()}


def measure(model, cfg, b: int, t: int, setting: str, steps: int):
    """One clip shape and setting: {'peak_gib', 'added_gib', 'step_ms',
    'launches'} or {'oom': True}."""
    import torch

    from .. import config, training
    from ..ops import _kernels

    remat, scan = SETTINGS[setting]
    opt = training.make_optimizer(0.05, moment_dtype=torch.bfloat16)
    opt_state = opt.init(dict(model.named_parameters()))
    step = training.make_train_step(cfg, config.BF16, opt, grads_bf16=True,
                                    remat=remat, remat_scan=scan)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = training.batch_to_device(random_batch(b, t), "cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    walls, counts = [], None
    try:
        for i in range(steps):
            if i == 0:
                _kernels.reset_launches()
            t0 = time.perf_counter()
            opt_state, m = step(model, opt_state, batch, gen, 1e-6, 0.4)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                counts = _kernels.launch_counts()
            if not np.isfinite(float(m["loss"])):
                raise AssertionError(f"{setting} B={b} T={t}: loss not finite")
    except torch.cuda.OutOfMemoryError:
        del opt_state
        torch.cuda.empty_cache()
        return {"oom": True}
    peak = torch.cuda.max_memory_allocated()
    del opt_state
    return {"peak_gib": peak / 2**30, "added_gib": (peak - held) / 2**30,
            "step_ms": statistics.median(walls[1:] or walls),
            "step_ms_all": walls, "launches": counts}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args(argv)

    import torch

    from .. import config
    from ..models.spann3r import build_spann3r
    from .convergence import device_name

    if not torch.cuda.is_available():
        raise RuntimeError("train_memory: no CUDA device is available")
    config.set_tf32_policy()
    cfg = config.Spann3RConfig(dust3r=config.DUSt3RConfig(
        img_size=(224, 224), head_type="dpt"))
    model = build_spann3r(cfg, "cuda", torch.Generator().manual_seed(0))
    card = device_name("cuda")
    lines = []
    for b, t in CLIPS:
        for setting in SETTINGS:
            rec = {"B": b, "T": t, "setting": setting, "device": card,
                   **measure(model, cfg, b, t, setting, STEPS)}
            print(json.dumps(rec), flush=True)
            lines.append(rec)
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(r) + "\n" for r in lines))
    return lines


if __name__ == "__main__":
    main()
