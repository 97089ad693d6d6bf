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
- `tenth-frames` (online cells): the program with every tenth pair's
  reference-frame pointmap scaled by 1.5, the fault on a tenth of the
  frames that the spike statistic exists for;
- `dedup-off` (online cells): the program with its write never skipped as
  a duplicate, which `dedup_skip_gap` exists for;
- `prune-truncates` (online cells): the program's prune keeping the
  bank's first long_mem_size slots, by place alone, in place of the
  young slots first; and `long-term-zeroed` (online cells): the tokens
  that spill to long-term memory lost (zeroed) after each write. Faults
  of the bank that sway every frame after a spill or a prune, which
  `bank_slot_gap` exists for.

In an online cell each entry runs every distinct video of the traffic, as
the window of `drivers/stream_step.py` does (reset, `put_frame` and `step`
a frame at a time, each output on the host, the last frame's target
prediction), with no window, and is judged as a run is, over the frames
of all the videos. The references follow the decisions of what stands in
the program's place. In the pairs cell the program's entries run the
cell's module, `drivers/pairs.py`, with a window of `--seconds`.

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
import itertools
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

MUST_PASS = ("program", "bf16-twin")
MUST_FAIL = ("fp8", "heads-tf32", "heads-bf16", "tenth-frames", "dedup-off",
             "prune-truncates", "long-term-zeroed")
CONTROLS = MUST_PASS + MUST_FAIL
REFERENCES = {"fp8": dict(lowp=True), "bf16-twin": dict(bf16=True)}


def reference_checks(ctx: common.Ctx, control: str) -> tuple:
    """The cell's numbers with the reference in the control's rounding as
    the program, following its own dedup decisions: (numbers, each
    video's record or None). Online, its bank transitions are kept and
    replayed as a run's are."""
    tr, dev = ctx.traffic, ctx.device
    w = bw.generate(ctx.cfg, ctx.seed, dev)
    exact, low = rm.Ref(w, ctx.cfg), rm.Ref(w, ctx.cfg, **REFERENCES[control])
    hw = tuple(tr["hw"])
    with torch.no_grad():
        if tr["driver"] == "stream_step":
            records = []
            for v in range(tr["videos"]):
                frames = torch.from_numpy(generate.normalise(generate.room_video(
                    ctx.rng(v), tr["frames"], 1, hw, dev))).to(dev)
                if v == 0:
                    head = common.head_rel_err(exact, low.head, frames[0], frames[1])
                outs, log = [], []
                bank = stream_step.Transitions(int(ctx.rng(200 + v).integers(1 << 62)))
                rm.stream(low, frames, lambda t, p, c: outs.append((p, c)), log=log,
                          on_step=bank.offer)
                # the control's own write decisions, which the references follow
                dups = [None] + [torch.tensor([own for _, own in row]) for row in log]
                rec = stream_step.yardstick_errors(
                    ctx, w, frames, lambda t, s: (outs[t][0][s], outs[t][1][s]), dups)
                rec["slot_gaps"] = stream_step.slot_gaps(ctx, w, frames, bank.items, dups)
                records.append(rec)
                del frames, outs, bank
            numbers = stream_step.pooled_numbers(records, ctx.cfg["memory"]["sim_thresh"])
            return dict(numbers, head_rel_err=head), records
        if tr["driver"] == "pairs":
            scenes = [generate.scene(ctx.rng(s), tr["views"], hw)
                      for s in range(tr["scenes"])]
            ij = pairs.complete_pairs(tr["views"])
            imgs = torch.from_numpy(scenes[0]).to(dev)
            first = ij[:tr["batch"]]
            head = common.head_rel_err(exact, low.head, imgs[[i for i, _ in first]],
                                       imgs[[j for _, j in first]])
            feats, pos = low.encode(imgs)
            r1s, r2s = [], []
            for i, j in ij:
                s1, s2 = low.decode(feats[i:i + 1], feats[j:j + 1], pos[:1], pos[:1])
                r1s.append(low.head(1, s1, hw))
                r2s.append(low.head(2, s2, hw))
            cat = lambda rs, k: torch.cat([r[k] for r in rs]).cpu().numpy()
            got = {"pred1": {"pts3d": cat(r1s, "pts3d"), "conf": cat(r1s, "conf")},
                   "pred2": {"pts3d_in_other_view": cat(r2s, "pts3d"),
                             "conf": cat(r2s, "conf")}}
            return dict(pairs.check(ctx, scenes, (0, got), ij), head_rel_err=head), None
    raise ValueError(f"no control for driver {tr['driver']!r}")


def program_videos(ctx: common.Ctx) -> tuple:
    """The program over every distinct video of an online cell, after the
    run's warm-up, each as the run's window runs it, then checked as a run
    checks them: (numbers, each video's record, with the bank's counters
    after each frame under `bank`)."""
    from spann3r_torch.models.spann3r import InferenceEngine

    tr, dev = ctx.traffic, ctx.device
    hw, n = tuple(tr["hw"]), tr["frames"]
    model, pcfg, prec = common.build_program_model(ctx)
    engine = InferenceEngine(model, pcfg, hw, prec, batch=1)
    videos = [generate.room_video(ctx.rng(v), n, 1, hw, dev) for v in range(tr["videos"])]

    def run_video(v, video, frames):
        engine.reset()
        outs, written = [], []
        bank = stream_step.Transitions(int(ctx.rng(200 + v).integers(1 << 62)))
        for i in range(frames):
            before = (engine.mem, engine._feat_k2)
            res = engine.step(engine.put_frame(video[i]))
            written.append(None if engine.mem is None else (engine.mem.size, engine.mem.wm))
            if res is not None:
                outs.append((res["res1"]["pts3d"].cpu(), res["res1"]["conf"].cpu()))
            if i == frames - 1:
                t = engine.target_prediction()
                outs.append((t["pts3d"].cpu(), t["conf"].cpu()))
            bank.offer(i, *before, engine.mem)
        return outs, written, bank

    run_video(0, videos[0], tr["warmup_frames"])
    kept = {v: run_video(v, video, n) for v, video in enumerate(videos)}
    first = torch.from_numpy(generate.normalise(videos[0][:2])).to(dev)
    head = common.head_rel_err(rm.Ref(bw.generate(ctx.cfg, ctx.seed, dev), ctx.cfg),
                               common.program_head(model.dust3r, pcfg.dust3r, prec),
                               first[0], first[1])
    del engine, model, first
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    records = []
    numbers = stream_step.check(ctx, videos, kept, hw, records)
    for rec, (_, written, _) in zip(records, (kept[v] for v in sorted(kept))):
        rec["bank"] = [None if w is None else (int(w[0][0]), int(w[1][0])) for w in written]
    return dict(numbers, head_rel_err=head), records


@contextlib.contextmanager
def patched(module, name, fn):
    orig = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, orig)


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

    return patched(d3, "downstream_head", tf32_head)


def tenth_frames():
    """Every tenth pair's reference-frame pointmap, as the pair step
    returns it, scaled by 1.5."""
    import spann3r_torch.models.spann3r as sp
    orig, calls = sp.pair_step, itertools.count()

    def altered(*a, **kw):
        out = orig(*a, **kw)
        if next(calls) % 10 == 9:
            out.res1["pts3d"] = out.res1["pts3d"] * 1.5
        return out

    return patched(sp, "pair_step", altered)


def dedup_off():
    """The write never skipped as a duplicate."""
    import spann3r_torch.models.memory as mem
    return patched(mem, "check_sim", lambda state, k, *a: torch.zeros(
        k.shape[0], dtype=torch.bool, device=k.device))


def prune_truncates():
    """The prune keeping the bank's first long_mem_size slots, by place
    alone."""
    import spann3r_torch.models.memory as mem

    def truncated(state, cfg):
        keep = cfg.long_mem_size
        cut = lambda a: torch.cat([a[:, :keep], torch.zeros_like(a[:, keep:])], 1)
        return state._replace(k=cut(state.k), v=cut(state.v), count=cut(state.count),
                              attn=cut(state.attn), size=torch.full_like(state.size, keep))

    return patched(mem, "memory_prune", truncated)


def long_term_zeroed():
    """The tokens that spill to long-term memory lost: after each write,
    the bank's long-term slots (its first `lm`) hold zeros."""
    import spann3r_torch.models.spann3r as sp
    orig = sp.add_mem_check

    def lost(state, k, v, cfg):
        s = orig(state, k, v, cfg)
        lt = (torch.arange(s.k.shape[1], device=s.k.device)[None] < s.lm[:, None])[..., None]
        return s._replace(k=torch.where(lt, torch.zeros_like(s.k), s.k),
                          v=torch.where(lt, torch.zeros_like(s.v), s.v))

    return patched(sp, "add_mem_check", lost)


FAULTS = {"heads-tf32": heads_in_tf32, "tenth-frames": tenth_frames,
          "dedup-off": dedup_off, "prune-truncates": prune_truncates,
          "long-term-zeroed": long_term_zeroed}
ONLINE_FAULTS = ("tenth-frames", "dedup-off", "prune-truncates", "long-term-zeroed")


def program_checks(ctx: common.Ctx, cell: str, control: str, seconds: float) -> tuple:
    """The program, or the program with the control's fault: (numbers,
    each video's record or None)."""
    if control == "heads-bf16":
        ctx.cfg = dict(ctx.cfg, precision=dict(ctx.cfg["precision"], heads="bfloat16"))
    fault = FAULTS[control]() if control in FAULTS else contextlib.nullcontext()
    with fault:
        if ctx.traffic["driver"] == "stream_step":
            return program_videos(ctx)
        if control in ONLINE_FAULTS:
            raise ValueError(f"{control} is a fault of the online cells")
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
    ap.add_argument("--control", choices=CONTROLS, action="append")
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--seconds", type=float, default=1.0,
                    help="the window of the pairs cell's program entries")
    ap.add_argument("--per-frame", type=Path, default=None)
    args = ap.parse_args(argv)
    run._environment()
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    spec = run.load_spec()
    _, cfg, traffic = run.cell_parts(spec, args.workload)
    common.set_tf32_off()
    for seed in args.seed:
        for control in args.control or ["fp8"]:
            t0 = time.perf_counter()
            ctx = common.Ctx(cfg=cfg, traffic=traffic, seed=seed, seconds=0.0,
                             trace=False, device=torch.device("cuda:0"), t_start=t0,
                             limits=traffic["limits"])
            if control in REFERENCES:
                numbers, records = reference_checks(ctx, control)
            else:
                numbers, records = program_checks(ctx, args.workload, control, args.seconds)
            checks = common.limited(ctx, numbers)
            head = {"workload": args.workload, "control": control, "seed": seed}
            print(json.dumps(dict(
                head, checks={k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()},
                notes=ctx.notes, fails=any(not v <= lim for v, lim in checks.values()),
                must_fail=control in MUST_FAIL, seconds=time.perf_counter() - t0)), flush=True)
            if args.per_frame and records:
                with args.per_frame.open("a") as f:
                    for v, rec in enumerate(records):
                        f.write(json.dumps(per_frame_line(dict(head, video=v), rec)) + "\n")
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
