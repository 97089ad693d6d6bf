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
import itertools
import statistics
import time

import torch

from benchmark import common, generate
from benchmark import weights as bw
from benchmark.counts import flops, kernels
from benchmark.reference import model as rm
from benchmark.trace import Tracer

# the CPU tests' traffic
SHORT = dict(hw=[32, 48], frames=14, warmup_frames=12, trace_start=2, trace_frames=3)


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
        bank = Transitions(int(ctx.rng(200 + v % len(videos)).integers(1 << 62)))
        for i in range(n_frames):
            tracer.begin(unit)
            if tracer.active:
                # the bank's valid slots that this frame's read sees
                reads0 = engine.stats["memory_reads"]
                size0 = 0 if engine.mem is None else int(engine.mem.size[0])
            # the program's state that this frame's step starts from
            before = (engine.mem, engine._feat_k2)
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
            bank.offer(i, *before, engine.mem)
        kept[v % len(videos)] = (outs, written, bank)
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
    head = ctx.kind.head_rel_err(ctx, model, pcfg, prec, first[0], first[1])
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
    ran (`kept`: {video: (outputs, written, Transitions)}) against the
    reference's run of the same frames (fp32), in units of the error that
    the bf16 twin of the reference makes on the same frames, both taking
    the program's dedup decisions, which are judged on their own; and the
    bank's transitions that the run kept, each replayed by the reference
    from the program's bank before it (PERF.md says why); the numbers are
    taken over the frames of all those videos. `records`, a list, receives
    each video's record (yardstick_errors, with `slot_gaps`)."""
    recs = []
    w = bw.generate(ctx.cfg, ctx.seed, ctx.device)
    for vi in sorted(kept):
        outs, written, bank = kept[vi]
        frames = torch.from_numpy(generate.normalise(videos[vi])).to(ctx.device)
        got = [(p.to(ctx.device), c.to(ctx.device)) for p, c in outs]
        dups = write_decisions(written)
        rec = yardstick_errors(ctx, w, frames, lambda t, s: (got[t][0][s], got[t][1][s]),
                               dups)
        rec["slot_gaps"] = slot_gaps(ctx, w, frames, bank.items, dups)
        recs.append(rec)
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


def yardstick_errors(ctx, w, frames, program, dups) -> dict:
    """Runs the fp32 reference and its bf16 twin over frames (T, B, H, W,
    3) on the weights `w`, both taking the decisions `dups`
    (write_decisions) in place of their own dedup decisions, so that a
    decision flipped by rounding does not part their banks from the
    program's; program(t, s) gives the program's (pointmap, confidence) of
    frame t of stream s. Returns the video's record: per stream, each
    frame's relative L2 error of the program (`prog`) and of the twin
    (`twin`) against fp32 (lists of (pointmap, confidence)), the fp32
    reference's own dedup check (`log`: per write, each stream's
    (similarity, skip)) and `dups`."""
    exact, log = [], []
    with torch.no_grad():
        rm.stream(rm.Ref(w, ctx.cfg), frames, lambda t, p, c: exact.append((p, c)),
                  dups, log)
    if len(exact) != frames.shape[0]:
        raise RuntimeError(f"the reference made {len(exact)} frames of {frames.shape[0]}")
    b = frames.shape[1]
    errs = {"prog": [[] for _ in range(b)], "twin": [[] for _ in range(b)]}

    def add(side, t, got):
        for s in range(b):
            p, c = got(s)
            errs[side][s].append((common.rel_err(p, exact[t][0][s]),
                                  common.rel_err(c, exact[t][1][s])))

    for t in range(len(exact)):
        add("prog", t, lambda s: program(t, s))
    with torch.no_grad():
        rm.stream(rm.Ref(w, ctx.cfg, bf16=True), frames,
                  lambda t, p, c: add("twin", t, lambda s: (p[s], c[s])), dups)
    return dict(errs, log=log, dups=dups)


# the frames, beside every prune, whose bank transition a run keeps
SAMPLED_WRITES = 3


class Transitions:
    """The frames of one run of a video whose bank transition the check
    replays (`slot_gaps`): every frame on which the bank was pruned, and
    SAMPLED_WRITES other frames that wrote to it, drawn from the seed;
    each kept as (t, bank before, the read's keys before, bank after).
    offer() is called after each frame's step with the state it started
    from and the bank after it, and reads the bank's size (the frame's
    outputs are on the host by then, so the device has finished)."""

    def __init__(self, seed: int):
        self.pruned = []
        self.writes = common.Reservoir(seed, SAMPLED_WRITES)
        self.size = None

    def offer(self, t, before, k2, after):
        size = None if after is None else tuple(after.size.tolist())
        # a step with a read (the second pair on) and a bank to start from
        if before is not None and k2 is not None and size != self.size:
            item = (t, before, k2, after)
            if any(a < b for a, b in zip(size, self.size)):
                self.pruned.append(item)
            else:
                self.writes.offer(lambda: item)
        self.size = size

    @property
    def items(self) -> list:
        return sorted(self.pruned + self.writes.items, key=lambda x: x[0])


def as_bank(state) -> rm.Bank:
    """The program's bank (or a reference's) as the reference's, in fp32."""
    return rm.Bank(k=state.k.float(), v=state.v.float(), count=state.count.float(),
                   attn=state.attn.float(), size=state.size.long(),
                   wm=state.wm.long(), lm=state.lm.long())


def slot_gaps(ctx, w, frames, transitions, dups) -> list:
    """Each kept transition (t, before, k2, after) replayed by the fp32
    reference: from the bank `before` and the read's keys k2, the step of
    frame t (read, pair, write with the program's decision dups[t]); then
    [(t, slot_gap)] of the bank `after` against the reference's."""
    ref = rm.Ref(w, ctx.cfg)
    hw = tuple(frames.shape[2:4])
    out = []
    with torch.no_grad():
        for t, before, k2, after in transitions:
            prev, _ = ref.encode(frames[t - 1])
            feat, pos = ref.encode(frames[t])
            _, want, _, _ = rm.step(ref, as_bank(before), prev, feat, pos, k2.float(), hw,
                                    dups[t])
            out.append((t, slot_gap(before, after, want)))
    return out


def _fingerprints(x: torch.Tensor) -> list:
    """Per row of x (N, D), an integer of its bits: rows alike to the bit
    read alike, others apart but by chance (~2**-20 a pair)."""
    bits = x.contiguous().view({2: torch.int16, 4: torch.int32}[x.element_size()]).long()
    g = torch.Generator(device="cpu").manual_seed(20)
    mult = torch.randint(1, 1 << 20, (x.shape[-1],), generator=g).to(x.device)
    return (bits * mult).sum(-1).tolist()


def slot_gap(before, got, want) -> float:
    """The share of the reference's valid slots (`want`, a bank after a
    step from `before`) on which the bank `got` differs: where, slot by
    slot, one holds a token of the bank before (key and value to the bit)
    and the other another one, or the same at another age, or a new token;
    plus the difference of their valid slots. 1 where the counts of
    working frames or long-term tokens differ. The worst stream's."""
    worst = 0.0
    for s in range(before.k.shape[0]):
        if (int(got.wm[s]), int(got.lm[s])) != (int(want.wm[s]), int(want.lm[s])):
            return 1.0

        def slots(bank):
            n = int(bank.size[s])
            k, v = (x[s, :n].to(before.k.dtype) for x in (bank.k, bank.v))
            return list(zip(_fingerprints(k), _fingerprints(v), bank.count[s, :n].tolist()))

        old = {(a, b) for a, b, _ in slots(before)}
        mark = lambda xs: [x if x[:2] in old else "new" for x in xs]
        g, r = mark(slots(got)), mark(slots(want))
        differ = sum(a != b for a, b in zip(g, r)) + abs(len(g) - len(r))
        worst = max(worst, differ / max(len(r), 1))
    return worst


def upper_median(values) -> float:
    return sorted(values)[len(values) // 2]


# the frames on each side of a frame that its spike is measured against
SPIKE_REACH = 3


def spikes(ratios) -> list:
    """Each frame's ratio over the median ratio of the SPIKE_REACH frames
    before it and after it in its video."""
    out = []
    for t, r in enumerate(ratios):
        near = ratios[max(0, t - SPIKE_REACH):t] + ratios[t + 1:t + 1 + SPIKE_REACH]
        out.append(r / max(statistics.median(near), 1e-30))
    return out


def pooled_numbers(records, thresh: float) -> dict:
    """The numbers compared, each over the frames of all the records
    (videos), the worst stream's:

    - `pts3d_err_over_twin`: the median over the frames of each frame's
      ratio of the program's pointmap error to the twin's, both against
      fp32, so that the frame's own sensitivity to rounding, which varies
      with the weights, the inputs and the bank's state, divides out;
    - `pts3d_p95_spike_over_twin`: the 95th percentile over the frames of
      each frame's spike (`spikes`) in that ratio. Rounding parts the two
      runs in stretches of frames (the memory read's threshold flips,
      PERF.md), so a sound ratio moves little from one frame to the next,
      while a fault on scattered frames (a tenth of them, as control.py's
      `tenth-frames`) stands out against its neighbours;
    - `bank_slot_gap`: the worst `slot_gap` of the transitions replayed,
      which sees a fault of the bank's write, spill and prune on the frame
      where it acts, however many frames it then sways;
    - the program's dedup decisions judged on their own, against the fp32
      reference's own check of the same frames: `dedup_skip_gap` is the
      writes the program skipped less those the reference's check skipped,
      in absolute value, over the decisions; rounding flips decisions both
      ways, a wrong check one way. `dedup_flip_share` (the decisions on
      which the two differ) and `dedup_flip_margin` (the farthest from the
      threshold that they differ) are kept for the record, with each
      side's median frame errors."""
    b = len(records[0]["prog"])
    out = {}
    for i, name in ((0, "pts3d"), (1, "conf")):
        ep = [[e[i] for r in records for e in r["prog"][s]] for s in range(b)]
        ey = [[e[i] for r in records for e in r["twin"][s]] for s in range(b)]
        out[f"{name}_rel_err_median"] = max(upper_median(e) for e in ep)
        out[f"twin_{name}_rel_err_median"] = min(upper_median(q) for q in ey)
    # per stream, each video's frame by frame ratios of the pointmap errors
    ratios = [[[a[0] / max(c[0], 1e-30) for a, c in zip(r["prog"][s], r["twin"][s])]
               for r in records] for s in range(b)]
    out["pts3d_err_over_twin"] = max(upper_median([x for rs in per for x in rs])
                                     for per in ratios)
    out["pts3d_p95_spike_over_twin"] = max(
        common.percentile([x for rs in per for x in spikes(rs)], 95) for per in ratios)
    out["bank_slot_gap"] = max([g for r in records for _, g in r["slot_gaps"]], default=0.0)
    out["bank_transitions"] = sum(len(r["slot_gaps"]) for r in records)
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


def reference_checks(ctx, exact, low) -> tuple:
    """The cell's numbers with the reference `low` in the program's place,
    following its own dedup decisions, over every distinct video
    (control.py): (numbers, each video's record). Its bank transitions
    are kept and replayed as a run's are."""
    tr, dev = ctx.traffic, ctx.device
    w = exact.w
    hw = tuple(tr["hw"])
    records = []
    for v in range(tr["videos"]):
        frames = torch.from_numpy(generate.normalise(generate.room_video(
            ctx.rng(v), tr["frames"], 1, hw, dev))).to(dev)
        if v == 0:
            head = common.head_rel_err(exact, low.head, frames[0], frames[1])
        outs, log = [], []
        bank = Transitions(int(ctx.rng(200 + v).integers(1 << 62)))
        rm.stream(low, frames, lambda t, p, c: outs.append((p, c)), log=log,
                  on_step=bank.offer)
        # the control's own write decisions, which the references follow
        dups = [None] + [torch.tensor([own for _, own in row]) for row in log]
        rec = yardstick_errors(ctx, w, frames, lambda t, s: (outs[t][0][s], outs[t][1][s]),
                               dups)
        rec["slot_gaps"] = slot_gaps(ctx, w, frames, bank.items, dups)
        records.append(rec)
        del frames, outs, bank
    numbers = pooled_numbers(records, ctx.cfg["memory"]["sim_thresh"])
    return dict(numbers, head_rel_err=head), records


def program_checks(ctx) -> tuple:
    """The program over every distinct video, after the run's warm-up,
    each as the run's window runs it, then checked as a run checks them
    (control.py): (numbers, each video's record, with the bank's counters
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
        bank = Transitions(int(ctx.rng(200 + v).integers(1 << 62)))
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
    head = ctx.kind.head_rel_err(ctx, model, pcfg, prec, first[0], first[1])
    del engine, model, first
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    records = []
    numbers = check(ctx, videos, kept, hw, records)
    for rec, (_, written, _) in zip(records, (kept[v] for v in sorted(kept))):
        rec["bank"] = [None if w is None else (int(w[0][0]), int(w[1][0])) for w in written]
    return dict(numbers, head_rel_err=head), records


# The faults of the online cells that control.py plants (PERF.md):


def tenth_frames():
    """Every tenth pair's reference-frame pointmap, as the pair step
    returns it, scaled by 1.5: the fault on a tenth of the frames that the
    spike statistic exists for."""
    import spann3r_torch.models.spann3r as sp
    orig, calls = sp.pair_step, itertools.count()

    def altered(*a, **kw):
        out = orig(*a, **kw)
        if next(calls) % 10 == 9:
            out.res1["pts3d"] = out.res1["pts3d"] * 1.5
        return out

    return common.patched(sp, "pair_step", altered)


def dedup_off():
    """The write never skipped as a duplicate, which `dedup_skip_gap`
    exists for."""
    import spann3r_torch.models.memory as mem
    return common.patched(mem, "check_sim", lambda state, k, *a: torch.zeros(
        k.shape[0], dtype=torch.bool, device=k.device))


def prune_truncates():
    """The prune keeping the bank's first long_mem_size slots, by place
    alone, in place of the young slots first (`bank_slot_gap`)."""
    import spann3r_torch.models.memory as mem

    def truncated(state, cfg):
        keep = cfg.long_mem_size
        cut = lambda a: torch.cat([a[:, :keep], torch.zeros_like(a[:, keep:])], 1)
        return state._replace(k=cut(state.k), v=cut(state.v), count=cut(state.count),
                              attn=cut(state.attn), size=torch.full_like(state.size, keep))

    return common.patched(mem, "memory_prune", truncated)


def long_term_zeroed():
    """The tokens that spill to long-term memory lost: after each write,
    the bank's long-term slots (its first `lm`) hold zeros
    (`bank_slot_gap`)."""
    import spann3r_torch.models.spann3r as sp
    orig = sp.add_mem_check

    def lost(state, k, v, cfg):
        s = orig(state, k, v, cfg)
        lt = (torch.arange(s.k.shape[1], device=s.k.device)[None] < s.lm[:, None])[..., None]
        return s._replace(k=torch.where(lt, torch.zeros_like(s.k), s.k),
                          v=torch.where(lt, torch.zeros_like(s.v), s.v))

    return common.patched(sp, "add_mem_check", lost)


FAULTS = {"tenth-frames": tenth_frames, "dedup-off": dedup_off,
          "prune-truncates": prune_truncates, "long-term-zeroed": long_term_zeroed}
# the checks each control has to fail, one of them
CAUGHT_BY = {"fp8": ["pts3d_err_over_twin"],
             "tenth-frames": ["pts3d_p95_spike_over_twin"],
             "dedup-off": ["dedup_skip_gap"],
             "prune-truncates": ["bank_slot_gap"], "long-term-zeroed": ["bank_slot_gap"],
             "heads-tf32": ["head_rel_err"], "heads-bf16": ["head_rel_err"]}
