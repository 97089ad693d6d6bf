"""DUSt3R's pairwise inference of whole scenes through
`models.inference.inference`.

A scene is `views` distinct images; its pairs are the complete graph,
symmetrised (DUSt3R's `make_pairs(scene_graph='complete',
symmetrize=True)`: n (n - 1) pairs), decoded `batch` pairs at a time with
both heads; the outputs reach the host as numpy arrays, as the entry
point returns them. Scenes follow each other; `scenes` distinct scenes
are made from the seed and cycled.

Traffic keys: hw, views, batch, scenes, trace_start, trace_scenes.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import common, generate
from benchmark import weights as bw
from benchmark.counts import flops, kernels
from benchmark.reference import model as rm
from benchmark.trace import Tracer


# the CPU tests' traffic
SHORT = dict(hw=[32, 48], views=4, batch=3)
# no faults of its own: its controls are every cell's (control.py)
FAULTS = {}
# the checks each control has to fail, one of them
CAUGHT_BY = {"fp8": ["pts3d_err_over_fp8", "conf_rel_err"],
             "heads-tf32": ["head_rel_err"], "heads-bf16": ["head_rel_err"]}


def complete_pairs(n: int):
    """(i, j) of the symmetrised complete graph, in make_pairs' order."""
    pairs = [(i, j) for i in range(n) for j in range(i)]
    return pairs + [(j, i) for i, j in pairs]


def run(ctx: common.Ctx) -> dict:
    from spann3r_torch.models.inference import inference

    tr = ctx.traffic
    hw = tuple(tr["hw"])
    model, pcfg, prec = common.build_program_model(ctx)
    scenes = [generate.scene(ctx.rng(s), tr["views"], hw) for s in range(tr["scenes"])]
    ij = complete_pairs(tr["views"])
    p = flops.tokens(ctx.cfg, hw)
    es = 2 if prec.compute_dtype == torch.bfloat16 else 4

    def one_scene(imgs):
        views = [{"img": imgs[i:i + 1], "idx": i} for i in range(len(imgs))]
        with tracer.span("bench.inference"):
            return inference([(views[i], views[j]) for i, j in ij], model, pcfg,
                             batch_size=tr["batch"], prec=prec, verbose=False)

    tracer = Tracer(False, 0, 0, ctx.device)
    one_scene(scenes[0])                    # warm-up: every shape of a scene
    common.sync(ctx.device)
    setup_s = time.perf_counter() - ctx.t_start

    tracer = Tracer(ctx.trace, tr["trace_start"], tr["trace_scenes"], ctx.device)
    tracer.warm_up()
    sample = common.Reservoir(int(ctx.rng(100).integers(1 << 62)))
    n_pairs = len(ij)
    shapes = kernels.encoder_sdpa(ctx.cfg, tr["views"], p, es)
    for s in range(0, n_pairs, tr["batch"]):
        shapes += kernels.decoder_sdpa(ctx.cfg, min(tr["batch"], n_pairs - s), p, es)
    done = unit = 0
    win = common.Window(ctx.seconds)
    t_open = win.open()
    while not win.over:
        k = unit % len(scenes)
        tracer.begin(unit)
        out = one_scene(scenes[k])
        if tracer.active:
            tracer.add(tr["views"], sdpa=shapes)
        tracer.end(unit)
        done += tr["views"]
        sample.offer(lambda: (k, out))
        unit += 1
    window_s = time.perf_counter() - t_open
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    summary = tracer.finish()
    traced = summary["units"] if summary else 0.0
    result = {
        "metrics": {"images_per_s": done / window_s, "setup_s": setup_s},
        "attempted": unit, "failed": 0, "memory_peak_bytes": peak,
        "trace": summary,
        "layer": {"flops_per_unit": flops.pairs_scene(ctx.cfg, hw, tr["views"], n_pairs)
                  / tr["views"],
                  "rate": (done - traced) / (window_s - tracer.spent_s)},
        "notes": {"scenes": unit},
    }
    t_ref = time.perf_counter()
    # the heads alone, on the sampled scene's first batch of pairs, while
    # the program is alive
    imgs = torch.from_numpy(scenes[sample.item[0]]).to(ctx.device)
    first = ij[:tr["batch"]]
    head = ctx.kind.head_rel_err(ctx, model, pcfg, prec, imgs[[i for i, _ in first]],
                                 imgs[[j for _, j in first]])
    del model, imgs
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check(ctx, scenes, sample.item, ij)
    result["checks"] = common.limited(ctx, dict(numbers, head_rel_err=head))
    result["notes"]["reference_s"] = time.perf_counter() - t_ref
    return result


def check(ctx, scenes, sample, ij) -> dict:
    """Every pair of the sampled scene against the fp32 reference. The
    pointmaps: the program's worst answer's relative L2 error over the
    worst answer's error of a float8 run of the reference on the same
    scene (the scene's and the weights' own sensitivity to rounding divides
    out, PERF.md); the confidences: the worst answer's relative error.
    Returns each number."""
    k, out = sample
    w = bw.generate(ctx.cfg, ctx.seed, ctx.device)
    exact, low = rm.Ref(w, ctx.cfg), rm.Ref(w, ctx.cfg, lowp=True)
    imgs = torch.from_numpy(scenes[k]).to(ctx.device)
    hw = imgs.shape[1:3]
    got = {"p1": out["pred1"]["pts3d"], "c1": out["pred1"]["conf"],
           "p2": out["pred2"]["pts3d_in_other_view"], "c2": out["pred2"]["conf"]}
    worst = {"prog_p": 0.0, "fp8_p": 0.0, "prog_c": 0.0}
    bs = ctx.traffic["batch"]
    with torch.no_grad():
        fe, pe = exact.encode(imgs)
        fl, pl = low.encode(imgs)
        for s in range(0, len(ij), bs):
            i1 = torch.tensor([a for a, _ in ij[s:s + bs]], device=imgs.device)
            i2 = torch.tensor([b for _, b in ij[s:s + bs]], device=imgs.device)
            e1, e2 = exact.decode(fe[i1], fe[i2], pe[i1], pe[i2])
            l1, l2 = low.decode(fl[i1], fl[i2], pl[i1], pl[i2])
            for side, ex, lo in ((1, exact.head(1, e1, hw), low.head(1, l1, hw)),
                                 (2, exact.head(2, e2, hw), low.head(2, l2, hw))):
                for n in range(len(i1)):
                    gp = torch.from_numpy(np.asarray(got[f"p{side}"][s + n])).to(imgs.device)
                    gc = torch.from_numpy(np.asarray(got[f"c{side}"][s + n])).to(imgs.device)
                    worst["prog_p"] = max(worst["prog_p"], common.rel_err(gp, ex["pts3d"][n]))
                    worst["fp8_p"] = max(worst["fp8_p"],
                                         common.rel_err(lo["pts3d"][n], ex["pts3d"][n]))
                    worst["prog_c"] = max(worst["prog_c"], common.rel_err(gc, ex["conf"][n]))
    return {"pts3d_err_over_fp8": worst["prog_p"] / worst["fp8_p"],
            "conf_rel_err": worst["prog_c"], "pts3d_rel_err_worst": worst["prog_p"],
            "fp8_pts3d_rel_err_worst": worst["fp8_p"]}


def reference_checks(ctx, exact, low) -> tuple:
    """The cell's numbers with the reference `low` in the program's place,
    on the first scene, pair by pair (control.py)."""
    tr, dev = ctx.traffic, ctx.device
    hw = tuple(tr["hw"])
    scenes = [generate.scene(ctx.rng(s), tr["views"], hw)
              for s in range(tr["scenes"])]
    ij = complete_pairs(tr["views"])
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
    return dict(check(ctx, scenes, (0, got), ij), head_rel_err=head), None
