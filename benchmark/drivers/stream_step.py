"""One live stream, a frame at a time, through `InferenceEngine.step`.

Closed loop: each frame is handed to the engine (`put_frame`, `step`) and
its pair's pointmap and confidence are copied to the host before the next
frame is handed over; at a video's end the target head's prediction of
the last frame too. Videos of `frames` frames follow each other, the
engine reset between them. A frame's latency runs from handing it over
until its outputs are on the host.

Traffic keys: hw, frames (a video), videos (distinct room videos made from
the seed, cycled), warmup_frames, trace_start, trace_frames.
"""
from __future__ import annotations

import gc
import time

import torch

from benchmark import common, generate
from benchmark import weights as bw
from benchmark.counts import flops, kernels
from benchmark.reference import model as rm
from benchmark.trace import Tracer


def run(ctx: common.Ctx) -> dict:
    from spann3r_torch.models.spann3r import InferenceEngine

    tr = ctx.traffic
    hw = tuple(tr["hw"])
    n_frames = tr["frames"]
    model, pcfg, prec = common.build_program_model(ctx)
    engine = InferenceEngine(model, pcfg, hw, prec, batch=1)
    videos = [generate.room_video(ctx.rng(v), n_frames, 1, hw, ctx.device)
              for v in range(tr["videos"])]
    p = flops.tokens(ctx.cfg, hw)
    es = 2 if prec.compute_dtype == torch.bfloat16 else 4
    cap = flops.memory_capacity(ctx.cfg, p)
    d = ctx.cfg["attn_head_out"]

    def one_frame(i, frame, last):
        """Hand frame i over; return its outputs on the host (a list)."""
        out = []
        with tracer.span("bench.engine.step"):
            res = engine.step(engine.put_frame(frame))
        # the bank's counters after the step, read after the window: the
        # write decisions the reference follows
        written.append(None if engine.mem is None else (engine.mem.size, engine.mem.wm))
        if res is not None:
            with tracer.span("bench.to_host"):
                out.append((res["res1"]["pts3d"].cpu(), res["res1"]["conf"].cpu()))
        if last:
            with tracer.span("bench.engine.target_prediction"):
                t = engine.target_prediction()
                out.append((t["pts3d"].cpu(), t["conf"].cpu()))
        return out

    # warm-up: enough frames of one video to fill the bank, spill and prune
    tracer = Tracer(False, 0, 0, ctx.device)
    written = []
    engine.reset()
    for i in range(tr["warmup_frames"]):
        one_frame(i, videos[0][i], i == tr["warmup_frames"] - 1)
    common.sync(ctx.device)
    setup_s = time.perf_counter() - ctx.t_start

    tracer = Tracer(ctx.trace, tr["trace_start"], tr["trace_frames"], ctx.device)
    tracer.warm_up()
    # the last run of each distinct video, which the check compares
    kept = {}
    lat, done, unit = [], 0, 0
    t_close = None
    win = common.Window(ctx.seconds)
    t_open = win.open()
    v = 0
    while t_close is None:
        # a video begun in the window runs to its end; its frames past the
        # window's close are not timed
        engine.reset()
        video = videos[v % len(videos)]
        outs, written = [], []
        for i in range(n_frames):
            tracer.begin(unit)
            if tracer.active:
                # the bank's valid slots that this frame's read sees
                reads0 = engine.stats["memory_reads"]
                size0 = 0 if engine.mem is None else int(engine.mem.size[0])
            t0 = time.perf_counter()
            got = one_frame(i, video[i], i == n_frames - 1)
            t1 = time.perf_counter()
            outs += got
            if t_close is None:
                lat.append(t1 - t0)
                done += len(got)
                if tracer.active:
                    read = engine.stats["memory_reads"] > reads0
                    tracer.add(len(got),
                               sdpa=kernels.stream_step_sdpa(ctx.cfg, 1, p, i > 0, es),
                               memory_read=[[(p, size0, cap, d, es)]] if read else [])
                tracer.end(unit)
                unit += 1
                if win.over:
                    t_close = time.perf_counter()
        kept[v % len(videos)] = (outs, written)
        v += 1
    window_s = t_close - t_open
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    summary = tracer.finish()
    traced = summary["units"] if summary else 0.0
    result = {
        "metrics": {"frames_per_s": done / window_s,
                    "frame_ms_p95": common.percentile(lat, 95) * 1e3,
                    "setup_s": setup_s},
        "attempted": unit, "failed": 0, "memory_peak_bytes": peak,
        "trace": summary,
        "layer": {"flops_per_unit": flops.stream_frame(ctx.cfg, hw),
                  "rate": (done - traced) / (window_s - tracer.spent_s)},
        "notes": {"frames": done, "videos": v, "frame_ms_p50": common.percentile(lat, 50) * 1e3},
    }
    t_ref = time.perf_counter()
    # the heads alone, on the first video's first pair, while the program
    # is alive
    first = torch.from_numpy(generate.normalise(videos[0][:2])).to(ctx.device)
    head = common.head_rel_err(rm.Ref(bw.generate(ctx.cfg, ctx.seed, ctx.device), ctx.cfg),
                               common.program_head(model.dust3r, pcfg.dust3r, prec),
                               first[0], first[1])
    del engine, model, first
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check(ctx, videos, kept, hw)
    result["checks"] = common.limited(ctx, dict(numbers, head_rel_err=head))
    result["notes"]["reference_s"] = time.perf_counter() - t_ref
    return result


def check(ctx, videos, kept, hw, records=None) -> dict:
    """Every output of the last run of each distinct video that the window
    ran (`kept`: {video: (outputs, written)}) against the reference's run of
    the same frames (fp32), in units of the error that float8 rounding
    makes on the same frames, the references taking the program's dedup
    decisions, which are judged on their own (PERF.md says why); the
    numbers are taken over the frames of all those videos. `records`, a
    list, receives each video's record (yardstick_errors)."""
    recs = []
    for vi in sorted(kept):
        outs, written = kept[vi]
        frames = torch.from_numpy(generate.normalise(videos[vi])).to(ctx.device)
        got = [(p.to(ctx.device), c.to(ctx.device)) for p, c in outs]
        recs.append(yardstick_errors(ctx, frames,
                                     lambda t, s: (got[t][0][s], got[t][1][s]),
                                     write_decisions(written)))
        del frames, got
    if records is not None:
        records += recs
    return pooled_numbers(recs, ctx.cfg["memory"]["sim_thresh"])


def write_decisions(written):
    """Per frame, (B,) whether the program skipped the frame's write as a
    duplicate: its bank's valid slots and working frames did not change.
    None before the first pair."""
    dups, prev = [], None
    for w in written:
        if w is None:
            dups.append(None)
            continue
        size, wm = (x.cpu() for x in w)
        before = prev if prev is not None else (torch.zeros_like(size), torch.zeros_like(wm))
        dups.append((size == before[0]) & (wm == before[1]))
        prev = (size, wm)
    return dups


def yardstick_errors(ctx, frames, program, dups) -> dict:
    """Runs the fp32 reference and the float8 one over frames (T, B, H, W,
    3), both taking the decisions `dups` (write_decisions) in place of
    their own dedup decisions, so that a decision flipped by rounding does
    not part their banks from the program's; program(t, s) gives the
    program's (pointmap, confidence) of frame t of stream s. Returns the
    video's record: per stream, each frame's relative L2 error of the
    program and of float8 against fp32 (`prog`, `fp8`: lists of
    (pointmap, confidence)), the fp32 reference's own dedup check (`log`:
    per write, each stream's (similarity, skip)) and `dups`."""
    w = bw.generate(ctx.cfg, ctx.seed, ctx.device)
    exact, log = [], []
    with torch.no_grad():
        rm.stream(rm.Ref(w, ctx.cfg), frames, lambda t, p, c: exact.append((p, c)),
                  dups, log)
    if len(exact) != frames.shape[0]:
        raise RuntimeError(f"the reference made {len(exact)} frames of {frames.shape[0]}")
    b = frames.shape[1]
    errs = {"prog": [[] for _ in range(b)], "fp8": [[] for _ in range(b)]}

    def on_frame(t, p, c):
        for s in range(b):
            gp, gc = program(t, s)
            errs["prog"][s].append((common.rel_err(gp, exact[t][0][s]),
                                    common.rel_err(gc, exact[t][1][s])))
            errs["fp8"][s].append((common.rel_err(p[s], exact[t][0][s]),
                                   common.rel_err(c[s], exact[t][1][s])))

    with torch.no_grad():
        rm.stream(rm.Ref(w, ctx.cfg, lowp=True), frames, on_frame, dups)
    return dict(errs, log=log, dups=dups)


def pooled_numbers(records, thresh: float) -> dict:
    """The numbers compared, each over the frames of all the records
    (videos), the worst stream's:

    - `*_err_over_fp8`: the median frame's relative L2 error of the
      program over the median frame's error of float8, both against fp32,
      so that the stream's own sensitivity to rounding, which varies with
      the weights and the inputs, divides out;
    - `*_p95_err_over_fp8`: the same at the 95th percentile of the frames,
      which a fault on a twentieth of the frames or more moves (a 90th
      percentile is blind to one on a tenth: PERF.md);
    - the program's dedup decisions judged on their own, against the fp32
      reference's own check of the same frames: `dedup_skip_gap` is the
      writes the program skipped less those the reference's check skipped,
      in absolute value, over the decisions; rounding flips decisions both
      ways, a wrong check one way. `dedup_flip_share` (the decisions on
      which the two differ) and `dedup_flip_margin` (the farthest from the
      threshold that they differ) are kept for the record."""
    b = len(records[0]["prog"])
    out = {}
    for i, name in ((0, "pts3d"), (1, "conf")):
        med, p95, mp, mf = [], [], [], []
        for s in range(b):
            ep = [e[i] for r in records for e in r["prog"][s]]
            ef = [e[i] for r in records for e in r["fp8"][s]]
            # the upper median of each side's frames
            mp.append(sorted(ep)[len(ep) // 2])
            mf.append(sorted(ef)[len(ef) // 2])
            med.append(mp[-1] / max(mf[-1], 1e-30))
            p95.append(common.percentile(ep, 95) / max(common.percentile(ef, 95), 1e-30))
        out.update({f"{name}_err_over_fp8": max(med), f"{name}_p95_err_over_fp8": max(p95),
                    f"{name}_rel_err_median": max(mp), f"fp8_{name}_rel_err_median": min(mf)})
    gap, share, margin, skips = [], [], [0.0], [0, 0]
    for s in range(b):
        # log[k] is the write of frame k + 1 (frame 0 writes nothing); with
        # no working memory to compare with (similarity -inf) the frame is
        # written
        rows = [(sim, own, bool(r["dups"][k + 1][s])) for r in records
                for k, row in enumerate(r["log"]) for sim, own in [row[s]]]
        prog_n = sum(pr for _, _, pr in rows)
        own_n = sum(own for _, own, _ in rows)
        flips = [abs(sim - thresh) for sim, own, pr in rows if own != pr]
        n = max(len(rows), 1)
        gap.append(abs(prog_n - own_n) / n)
        share.append(len(flips) / n)
        margin += [f for f in flips if f != float("inf")]
        skips[0] += prog_n
        skips[1] += own_n
    out.update(dedup_skip_gap=max(gap), dedup_flip_share=max(share),
               dedup_flip_margin=max(margin), dedup_skipped_by_program=skips[0],
               dedup_skipped_by_reference=skips[1])
    return out
