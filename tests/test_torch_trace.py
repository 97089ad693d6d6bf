"""The spans of spann3r_torch (`utils/trace.py`), on the CPU, at the DPT
configuration of tests/test_torch_engine.py (its bank prunes within 8
frames): the spans that a profiled stream and a profiled pairwise inference
record, and their nesting; the host's waits for the device, one
`spann3r.sync` span each; and that a run with no profiler records nothing
and gives the profiled run's bits.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from spann3r_torch import config as TC
from spann3r_torch.models import memory as TM
from spann3r_torch.models import spann3r as TS
from spann3r_torch.models.inference import inference
from spann3r_torch.utils import trace
from tests.test_torch_model import HW, _cfg, _frames

KIND = "dpt"
# each step after the first two: the memory's read, the pair step (decoder,
# key heads, the reference head, value encoder) and the write
STEP = ["spann3r.encode", "spann3r.memory.read", "spann3r.decode",
        "spann3r.memory.value", "spann3r.head", "spann3r.memory.value",
        "spann3r.memory.write"]


@pytest.fixture(scope="module")
def engine():
    cfg = _cfg(TC, KIND)
    model = TS.build_spann3r(cfg, "cpu", torch.Generator().manual_seed(3))
    return TS.InferenceEngine(model, cfg, HW[KIND], TC.FP32)


def _spans(prof):
    """The program's spans in the profile, as a forest of (name, start_us,
    end_us, children), in order of start."""
    flat = sorted((e.start_ns() / 1e3, -e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("spann3r."))
    roots, open_ = [], []
    for s, neg_d, name in flat:
        node = (name, s, s - neg_d / 1e3, [])
        while open_ and open_[-1][2] <= s:
            open_.pop()
        (open_[-1][3] if open_ else roots).append(node)
        open_.append(node)
    return roots


def _calls(prof, name):
    return sum(e.name() == name
               for e in prof.profiler.kineto_results.events())


def _shape(nodes):
    return [(n, _shape(c)) if c else n for n, _, _, c in nodes]


def _stream(engine, frames, profiled):
    trace.reset()
    engine.reset()
    outs = []

    def go():
        for f in frames:
            out = engine.step(engine.put_frame(f))
            outs.append(None if out is None else out["res1"])

    if not profiled:
        go()
        return outs, None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        go()
    return outs, prof


def test_step_records_each_layer_in_its_step(engine):
    """One `spann3r.step` a frame; inside it the encoder, then from the
    second frame the pair's layers in order (the read once a key exists),
    and inside the write on every frame with a bank its three waits for
    the device, `spann3r.sync`: two in the append, then the prune's read."""
    frames = _frames(KIND, t=8, seed=70)
    _, prof = _stream(engine, frames, True)
    steps = _spans(prof)
    assert [name for name, _, _, _ in steps] == ["spann3r.step"] * len(frames)
    write = ("spann3r.memory.write", ["spann3r.sync"] * 3)
    want = [["spann3r.encode"],
            [n for n in STEP[:-1] if n != "spann3r.memory.read"] + [write]]
    want += [STEP[:-1] + [write]] * (len(frames) - 2)
    assert [_shape(children) for _, _, _, children in steps] == want


def test_span_sums_follow_the_trace(engine):
    """While profiled, each span's host seconds are summed, within the
    trace's durations of the span."""
    frames = _frames(KIND, t=8, seed=71)
    _, prof = _stream(engine, frames, True)
    got = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("spann3r."):
            calls, us = got.get(e.name(), (0, 0.0))
            got[e.name()] = (calls + 1, us + e.duration_ns() / 1e3)
    assert set(trace.SPAN_S) == set(got)
    for name, (calls, us) in got.items():
        assert 0 < trace.SPAN_S[name] <= us / 1e6 + calls * 1e-4, name
    total = trace.SPAN_S["spann3r.step"]
    assert total == pytest.approx(got["spann3r.step"][1] / 1e6, rel=0.1)


def test_syncs_are_spanned_and_prunes_run_as_unprofiled(engine, monkeypatch):
    """Three `spann3r.sync` spans a frame written (the append's two, the
    prune's read), and the prunes of the unprofiled run, call for call."""
    prunes = []
    orig = TM.memory_prune
    monkeypatch.setattr(TM, "memory_prune",
                        lambda s, c: prunes.append(1) or orig(s, c))
    frames = _frames(KIND, t=8, seed=72)
    _stream(engine, frames, False)
    assert prunes
    n = len(prunes)
    _, prof = _stream(engine, frames, True)
    assert _calls(prof, "spann3r.sync") == 3 * (len(frames) - 1)
    assert len(prunes) == 2 * n


def test_unprofiled_run_records_nothing_and_gives_the_same_bits(engine):
    assert trace.span("spann3r.step") is trace.span("spann3r.decode")
    frames = _frames(KIND, t=8, seed=73)
    plain, _ = _stream(engine, frames, False)
    assert not trace.SPAN_S
    profiled, _ = _stream(engine, frames, True)
    assert len(plain) == len(profiled) and plain[0] is None
    for a, b in zip(plain[1:], profiled[1:]):
        for k in ("pts3d", "conf"):
            assert torch.equal(a[k], b[k])


def test_run_video_records_the_memory_spans(engine):
    """The chunked path shares the spans of the layers it runs: one encode
    a chunk, and the memory's read and write (the syncs inside) a pair."""
    frames = _frames(KIND, t=7, seed=74)
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.run_video(frames, chunk=3)
    roots = _shape(_spans(prof))
    assert roots.count("spann3r.encode") == 3
    assert roots.count("spann3r.memory.read") == len(frames) - 2
    write = ("spann3r.memory.write", ["spann3r.sync"] * 3)
    assert roots.count(write) == len(frames) - 1
    assert _calls(prof, "spann3r.sync") == 3 * (len(frames) - 1)


@pytest.mark.parametrize("batch", [4, 6])
def test_inference_records_encode_decode_heads_and_copies(engine, batch):
    """Pairwise inference over 3 frames (6 pairs): the copy of the unique
    frames to the device (a sync) and their encode; a batch, the copies of
    its two index lists (a sync each), one decode and two heads; one copy
    to the host for each of the 4 outputs."""
    model = engine.model.dust3r
    cfg = engine.cfg.dust3r
    rng = np.random.default_rng(75)
    views = [{"img": torch.from_numpy(rng.standard_normal((1, *HW[KIND], 3))
                                      .astype(np.float32)), "idx": i}
             for i in range(3)]
    pairs = [(views[i], views[j]) for i in range(3) for j in range(3) if i != j]
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        inference(pairs, model, cfg, batch_size=batch, prec=TC.FP32,
                  verbose=False)
    batches = -(-len(pairs) // batch)
    roots = _shape(_spans(prof))
    assert roots == (["spann3r.sync", "spann3r.encode"]
                     + ["spann3r.sync", "spann3r.sync", "spann3r.decode",
                        "spann3r.head", "spann3r.head"] * batches
                     + ["spann3r.to_host"] * 4)
    assert _calls(prof, "spann3r.sync") == 1 + 2 * batches
