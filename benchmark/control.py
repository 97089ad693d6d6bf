"""The two sides of each limit of a cell's comparison, on the cell's own
inputs at its own sizes; the benchmark's runs never run them.

Entries that must pass the cell's limits (where sound runs land):

- `program`: the program, as the benchmark runs it;
- `bf16-twin`: the plain reference put in the program's place with every
  linear layer's and attention product's inputs rounded to bfloat16, the
  configuration's own transformer precision, its heads in fp32 as the
  configuration states: where sound rounding lands with no program code
  involved. In an online cell the twin is also the yardstick, so its
  ratios read 1 by construction: there its bank, dedup and heads are
  judged.

Entries that must fail them:

- `fp8`: the plain reference put in the program's place, with the same
  operands rounded to float8 e4m3, the precision below the configuration's
  bfloat16 transformer;
- `heads-tf32`: the program with its DPT heads' products in TF32, the
  precision below the configuration's float32 heads (TF32 off);
- `heads-bf16`: the program with its heads in bfloat16, its own serving
  path (`BF16_FAST`);
- the faults of the cell's driver (its FAULTS), for the online cells
  (`drivers/stream_step.py`): `tenth-frames`, the program with every tenth pair's
  reference-frame pointmap scaled by 1.5, the fault on a tenth of the
  frames that the spike statistic exists for;
- `dedup-off`: the program with its write never skipped as
  a duplicate, which `dedup_skip_gap` exists for;
- `prune-truncates`: the program's prune keeping the
  bank's first long_mem_size slots, by place alone, in place of the
  young slots first; and `long-term-zeroed`: the tokens
  that spill to long-term memory lost (zeroed) after each write. Faults
  of the bank that sway every frame after a spill or a prune, which
  `bank_slot_gap` exists for.

The cell's model kind gives the reference (benchmark/models/), its driver
judges it (`reference_checks`). A driver may give the program's entries
a run of their own (`program_checks`); the others run the cell's run with
a window of `--seconds`. In an online cell each entry runs every distinct
video of the traffic, as the window of `drivers/stream_step.py` does
(reset, `put_frame` and `step` a frame at a time, each output on the
host, the last frame's target prediction), with no window, and is judged
as a run is, over the frames of all the videos. The references follow
the decisions of what stands in the program's place. In the pairs cell
the program's entries run `drivers/pairs.py` with its window.

    python3 benchmark/control.py --workload <cell> --control <name> [--control <name> ...] --seed <n> [--seed <n> ...] [--per-frame PATH]

Prints one JSON line a seed and entry: {workload, control, seed, checks
{name: {value, limit}}, notes, fails, must_fail, seconds}, where `fails`
says whether the entry failed a limit and `must_fail` whether it has to.
`--per-frame` appends to PATH, for each video of an online entry, the
frame-by-frame relative errors of the entry and of the twin, the dedup
decisions it took, the fp32 reference's own, the bank's counters after
each frame (the program's only) and each replayed transition's slot gap,
for a look at the tails. The calibration of the online limits (PERF.md)
is one such command a process, several processes sharing the card.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import common, run  # noqa: E402
from benchmark import weights as bw  # noqa: E402

MUST_PASS = ("program", "bf16-twin")
# the entries of every cell that must fail; a driver adds its own faults
# (its FAULTS)
MUST_FAIL = ("fp8", "heads-tf32", "heads-bf16")
REFERENCES = {"fp8": dict(lowp=True), "bf16-twin": dict(bf16=True)}


def reference_checks(ctx: common.Ctx, control: str) -> tuple:
    """The cell's numbers with the kind's reference in the control's
    rounding as the program, judged by its driver: (numbers, each video's
    record or None)."""
    w = bw.generate(ctx.cfg, ctx.seed, ctx.device)
    kind = ctx.kind
    exact, low = kind.reference(w, ctx.cfg), kind.reference(w, ctx.cfg, **REFERENCES[control])
    with torch.no_grad():
        return ctx.driver.reference_checks(ctx, exact, low)


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

    return common.patched(d3, "downstream_head", tf32_head)


def faults(ctx: common.Ctx) -> dict:
    """{control: the context manager that plants it}: the heads' TF32, and
    the cell's driver's own faults."""
    return dict({"heads-tf32": heads_in_tf32}, **getattr(ctx.driver, "FAULTS", {}))


def controls(ctx: common.Ctx) -> tuple:
    """Every entry of the cell: those that must pass, then those that must
    fail."""
    return MUST_PASS + MUST_FAIL + tuple(getattr(ctx.driver, "FAULTS", {}))


def program_checks(ctx: common.Ctx, cell: str, control: str, seconds: float) -> tuple:
    """The program, or the program with the control's fault: (numbers,
    each video's record or None). Where the driver gives no entry of its
    own (`program_checks`), the cell's run with a window of `seconds`."""
    entries = [c for c in controls(ctx) if c not in REFERENCES]
    if control not in entries:
        raise ValueError(f"{control!r} is no program entry of {cell}: {entries}")
    if control == "heads-bf16":
        ctx.cfg = dict(ctx.cfg, precision=dict(ctx.cfg["precision"], heads="bfloat16"))
    fault = faults(ctx).get(control, contextlib.nullcontext)()
    with fault:
        own = getattr(ctx.driver, "program_checks", None)
        if own is not None:
            return own(ctx)
        res = run.execute(cell, ctx.seed, seconds, False, str(ctx.device), cfg=ctx.cfg,
                          t_start=time.perf_counter())
    return dict(res["notes"], **{k: c["value"] for k, c in res["checks"].items()}), None


def _rounded(x):
    if isinstance(x, float):
        return float(f"{x:.6g}")
    if isinstance(x, (list, tuple)):
        return [_rounded(y) for y in x]
    if isinstance(x, dict):
        return {k: _rounded(v) for k, v in x.items()}
    return x


def per_frame_line(head: dict, rec: dict) -> dict:
    """One video's frame-by-frame record (stream 0)."""
    errs = {}
    for side, key in (("prog", ""), ("twin", "twin_")):
        errs[key + "pts3d"] = [e[0] for e in rec[side][0]]
        errs[key + "conf"] = [e[1] for e in rec[side][0]]
    return dict(head, **_rounded(dict(
        errs, skip=[None if d is None else bool(d[0]) for d in rec["dups"]],
        slot_gaps=rec["slot_gaps"],
        bank=rec.get("bank"), ref_sim=[row[0][0] for row in rec["log"]],
        ref_skip=[row[0][1] for row in rec["log"]])))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--control", action="append",
                    help="an entry: program, bf16-twin, fp8, heads-tf32, heads-bf16, or "
                         "a fault of the cell's driver (its FAULTS); default fp8")
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--seconds", type=float, default=1.0,
                    help="the window of the program entries of a cell whose "
                         "driver gives no entry of its own (the pairs cell)")
    ap.add_argument("--per-frame", type=Path, default=None)
    args = ap.parse_args(argv)
    run._environment()
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    spec = run.load_spec()
    _, cfg, traffic = run.cell_parts(spec, args.workload)
    common.set_tf32_off()
    new_ctx = lambda seed, t0: common.Ctx(
        cfg=cfg, traffic=traffic, seed=seed, seconds=0.0, trace=False,
        device=torch.device("cuda:0"), t_start=t0, limits=traffic["limits"])
    known = controls(new_ctx(0, 0.0))
    unknown = [c for c in args.control or [] if c not in known]
    if unknown:
        ap.error(f"{unknown} are no entries of {args.workload}: {list(known)}")
    for seed in args.seed:
        for control in args.control or ["fp8"]:
            t0 = time.perf_counter()
            ctx = new_ctx(seed, t0)
            if control in REFERENCES:
                numbers, records = reference_checks(ctx, control)
            else:
                numbers, records = program_checks(ctx, args.workload, control, args.seconds)
            checks = common.limited(ctx, numbers)
            head = {"workload": args.workload, "control": control, "seed": seed}
            print(json.dumps(dict(
                head, checks={k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()},
                notes=ctx.notes, fails=any(not v <= lim for v, lim in checks.values()),
                must_fail=control not in MUST_PASS, seconds=time.perf_counter() - t0)), flush=True)
            if args.per_frame and records:
                with args.per_frame.open("a") as f:
                    for v, rec in enumerate(records):
                        f.write(json.dumps(per_frame_line(dict(head, video=v), rec)) + "\n")
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
