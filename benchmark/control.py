"""The controls of a cell's comparison, on the cell's own inputs at its own
sizes. Each must fail the cell's limits; the benchmark's runs never run
them.

- `fp8`: the plain reference put in the program's place, with every linear
  layer's and attention product's inputs rounded to float8 e4m3, the
  precision below the configuration's bfloat16 transformer;
- `heads-tf32`: the program with its DPT heads' products in TF32, the
  precision below the configuration's float32 heads (TF32 off);
- `heads-bf16`: the program with its heads in bfloat16, its own serving
  path (`BF16_FAST`).

    python3 benchmark/control.py --workload <cell> --control <name> --seed <n> [--seed <n> ...]

Prints one JSON line a seed: {workload, control, seed, checks {name:
{value, limit}}, fails} where fails says whether the control failed a
limit, as it must.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import common, generate, run  # noqa: E402
from benchmark import weights as bw  # noqa: E402
from benchmark.drivers import pairs, stream_step  # noqa: E402
from benchmark.reference import model as rm  # noqa: E402

CONTROLS = ("fp8", "heads-tf32", "heads-bf16")


def fp8_checks(ctx: common.Ctx) -> dict:
    """The cell's checks with the float8 reference as the program."""
    tr, dev = ctx.traffic, ctx.device
    w = bw.generate(ctx.cfg, ctx.seed, dev)
    exact, low = rm.Ref(w, ctx.cfg), rm.Ref(w, ctx.cfg, lowp=True)
    hw = tuple(tr["hw"])
    with torch.no_grad():
        if tr["driver"] == "stream_step":
            # the yardstick's own float8 run in the program's place
            frames = torch.from_numpy(generate.normalise(generate.room_video(
                ctx.rng(0), tr["frames"], 1, hw, dev))).to(dev)
            head = common.head_rel_err(exact, low.head, frames[0], frames[1])
            del w, exact
            outs, log = [], []
            rm.stream(low, frames, lambda t, p, c: outs.append((p, c)), log=log)
            # the control's own write decisions, which the yardsticks follow
            dups = [None] + [torch.tensor([own for _, own in row]) for row in log]
            numbers = stream_step.yardstick_checks(
                ctx, frames, lambda t, s: (outs[t][0][s], outs[t][1][s]), dups)
        elif tr["driver"] == "pairs":
            scenes = [generate.scene(ctx.rng(s), tr["views"], hw)
                      for s in range(tr["scenes"])]
            ij = pairs.complete_pairs(tr["views"])
            imgs = torch.from_numpy(scenes[0]).to(dev)
            first = ij[:tr["batch"]]
            head = common.head_rel_err(exact, low.head, imgs[[i for i, _ in first]],
                                       imgs[[j for _, j in first]])
            del w, exact
            feats, pos = low.encode(imgs)
            r1s, r2s = [], []
            for i, j in ij:
                s1, s2 = low.decode(feats[i:i + 1], feats[j:j + 1], pos[:1], pos[:1])
                r1s.append(low.head(1, s1, hw))
                r2s.append(low.head(2, s2, hw))
            cat = lambda rs, k: torch.cat([r[k] for r in rs]).cpu().numpy()
            out = {"pred1": {"pts3d": cat(r1s, "pts3d"), "conf": cat(r1s, "conf")},
                   "pred2": {"pts3d_in_other_view": cat(r2s, "pts3d"),
                             "conf": cat(r2s, "conf")}}
            numbers = pairs.check(ctx, scenes, (0, out), ij)
        else:
            raise ValueError(f"no control for driver {tr['driver']!r}")
    return common.limited(ctx, dict(numbers, head_rel_err=head))


@contextlib.contextmanager
def heads_in_tf32():
    """The program's heads with TF32 on for their convolutions and
    products, and off again around them."""
    from spann3r_torch.models import dust3r as d3
    orig = d3.downstream_head

    def tf32_head(*a, **kw):
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return orig(*a, **kw)
        finally:
            common.set_tf32_off()

    d3.downstream_head = tf32_head
    try:
        yield
    finally:
        d3.downstream_head = orig


def program_control(cell: str, control: str, seed: int, seconds: float,
                    device: str) -> dict:
    """A run of the cell with the program's heads in the control's
    precision: its checks {name: (value, limit)} and notes."""
    spec = run.load_spec()
    _, cfg, _ = run.cell_parts(spec, cell)
    if control == "heads-bf16":
        cfg = dict(cfg, precision=dict(cfg["precision"], heads="bfloat16"))
    ctx = heads_in_tf32() if control == "heads-tf32" else contextlib.nullcontext()
    with ctx:
        res = run.execute(cell, seed, seconds, False, device, spec=spec, cfg=cfg,
                          t_start=time.perf_counter())
    return {k: (c["value"], c["limit"]) for k, c in res["checks"].items()}, res["notes"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--control", choices=CONTROLS, default="fp8")
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--seconds", type=float, default=1.0,
                    help="the window of a control that runs the program")
    args = ap.parse_args(argv)
    run._environment()
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    spec = run.load_spec()
    _, cfg, traffic = run.cell_parts(spec, args.workload)
    common.set_tf32_off()
    for seed in args.seed:
        t0 = time.perf_counter()
        if args.control == "fp8":
            ctx = common.Ctx(cfg=cfg, traffic=traffic, seed=seed, seconds=0.0,
                             trace=False, device=torch.device("cuda:0"), t_start=t0,
                             limits=traffic["limits"])
            checks, notes = fp8_checks(ctx), ctx.notes
        else:
            checks, notes = program_control(args.workload, args.control, seed,
                                            args.seconds, "cuda:0")
        print(json.dumps({
            "workload": args.workload, "control": args.control, "seed": seed,
            "notes": notes,
            "checks": {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()},
            "fails": any(not v <= lim for v, lim in checks.values()),
            "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
