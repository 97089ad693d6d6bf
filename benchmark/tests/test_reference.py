"""The plain reference against the program on the CPU, at a narrow
configuration in fp32, where the two must agree to rounding: the
streaming reconstruction with its memory (reads, dedup, spill, prune),
and pairwise inference. And the benchmark's
weights load into the program's model under its own keys."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import common, generate, weights as bw
from benchmark.drivers import pairs
from benchmark.reference import model as rm
from benchmark.tests import tiny

TOL = 2e-5   # fp32 against fp32: rounding of differently ordered sums


def _ctx(name, seed=12345):
    cfg, traffic = tiny.cell(name, "float32")
    return common.Ctx(cfg, traffic, seed, 0.0, False, torch.device("cpu"), 0.0,
                      traffic["limits"])


def test_weights_fill_every_parameter():
    ctx = _ctx("spann3r.online-512")
    model, _, _ = common.build_program_model(ctx)
    names = [n for n, _, _ in bw.spec(ctx.cfg)]
    assert sorted(names) == sorted(model.state_dict())
    assert bw.n_params(ctx.cfg) == sum(p.numel() for p in model.parameters())


def test_stream_matches_program():
    from spann3r_torch.models.spann3r import InferenceEngine
    ctx = _ctx("spann3r.online-512")
    model, pcfg, prec = common.build_program_model(ctx)
    frames = generate.video(ctx.rng(0), 16, 2, (32, 48))
    frames[:, 1] = frames[:, 0]          # a second stream of repeated frames
    frames[4:9, 1] = frames[4, 1]        # ... that the dedup check skips
    eng = InferenceEngine(model, pcfg, (32, 48), prec, batch=2)
    preds = eng.run(frames)
    assert int(eng.mem.lm.max()) > 0 and int(eng.mem.size.max()) >= 40  # spilled, pruned
    ref = rm.Ref(bw.generate(ctx.cfg, ctx.seed, "cpu"), ctx.cfg)
    errs = []

    def on_frame(t, p, c):
        key = "pts3d" if t == 0 else "pts3d_in_other_view"
        errs.append(max(common.rel_err(preds[t][key], p),
                        common.rel_err(preds[t]["conf"], c)))

    with torch.no_grad():
        rm.stream(ref, torch.from_numpy(generate.normalise(frames)), on_frame)
    assert len(errs) == 16 and max(errs) < TOL


def test_pairs_match_program():
    from spann3r_torch.models.inference import inference
    ctx = _ctx("dust3r.pairs-512")
    model, pcfg, prec = common.build_program_model(ctx)
    imgs = generate.scene(ctx.rng(0), 3, (32, 48))
    views = [{"img": imgs[i:i + 1], "idx": i} for i in range(3)]
    ij = pairs.complete_pairs(3)
    out = inference([(views[i], views[j]) for i, j in ij], model, pcfg,
                    batch_size=4, prec=prec, verbose=False)
    ref = rm.Ref(bw.generate(ctx.cfg, ctx.seed, "cpu"), ctx.cfg)
    with torch.no_grad():
        for row, (i, j) in enumerate(ij):
            r1, r2 = ref.pair(torch.from_numpy(imgs[i:i + 1]),
                              torch.from_numpy(imgs[j:j + 1]))
            got = torch.from_numpy(np.asarray(out["pred2"]["pts3d_in_other_view"][row]))
            assert common.rel_err(torch.from_numpy(out["pred1"]["pts3d"][row]),
                                  r1["pts3d"][0]) < TOL
            assert common.rel_err(got, r2["pts3d"][0]) < TOL
            assert common.rel_err(torch.from_numpy(out["pred2"]["conf"][row]),
                                  r2["conf"][0]) < TOL


@pytest.mark.parametrize("rounding", ["fp32", "bf16", "lowp"])
def test_cache_gives_the_same_bits(rounding):
    """The kept RoPE tables and rounded weights change no bit of the
    stream's outputs or of its dedup check."""
    ctx = _ctx("spann3r.online-512")
    w = bw.generate(ctx.cfg, ctx.seed, "cpu")
    frames = torch.from_numpy(generate.normalise(generate.video(ctx.rng(0), 14, 1, (32, 48))))
    kw = {} if rounding == "fp32" else {rounding: True}
    runs = []
    for cache in (True, False):
        ref = rm.Ref(w, ctx.cfg, cache=cache, **kw)
        outs, log = [], []
        with torch.no_grad():
            rm.stream(ref, frames, lambda t, p, c: outs.append((p, c)), log=log)
        runs.append((outs, log))
        if cache:
            assert ref.tables and (ref.wt or rounding == "fp32")
        else:
            assert not ref.tables and not ref.wt
    (a, log_a), (b, log_b) = runs
    assert len(a) == len(b) == 14 and log_a == log_b
    for (pa, ca), (pb, cb) in zip(a, b):
        assert torch.equal(pa, pb) and torch.equal(ca, cb)
