"""The streaming engine's CUDA graphs (`InferenceEngine(cuda_graphs=True)`,
`utils/graphs.py`) against the same engine with every layer eager, on the
card. Each test takes the `dev` fixture, which skips it where no CUDA
device is present; on the card they run with

    python -m pytest --noconftest tests/test_torch_graphs.py -q

A narrow configuration (head dims 64, as the kernels take) whose bank
spills and prunes every few frames, at B = 1 and B = 2, in bf16 with fp32
heads as the benchmark runs it; two videos of uint8 frames with a reset
between them. In one stream of the second video the frames 5-6 repeat
frame 4, so that the streams' dedup decisions part. The graphed step must
give the eager step's bits.
"""
import numpy as np
import pytest
import torch

from spann3r_torch import config as TC
from spann3r_torch.models import dust3r as TD
from spann3r_torch.models import memory as TM
from spann3r_torch.models import spann3r as TS
from spann3r_torch.ops import _kernels

HW = (64, 96)
FRAMES = 12
# the layers a step replays: encoder, decoders, key heads, reference head,
# value encoder
GRAPHS = 5
CFG = TC.Spann3RConfig(
    dust3r=TC.DUSt3RConfig(
        img_size=HW, patch_size=16,
        enc=TC.ViTConfig(dim=128, depth=2, num_heads=2),
        dec=TC.ViTConfig(dim=128, depth=4, num_heads=2),
        head_type="dpt", dpt_feature_dim=32, dpt_last_dim=16,
        dpt_layer_dims=(16, 24, 32, 48)),
    memory=TC.MemoryConfig(long_mem_size=48, work_mem_size=2, sim_thresh=0.8),
    value_enc_depth=1, value_enc_dim=128, value_enc_heads=2,
    attn_head_in=256, attn_head_out=128)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _videos(batch):
    rng = np.random.default_rng(batch)
    videos = rng.integers(0, 256, (2, FRAMES, batch, *HW, 3), dtype=np.uint8)
    videos[1, 5:7, 0] = videos[1, 4, 0]
    return videos


def _engines(dev, batch):
    model = TS.build_spann3r(CFG, dev, torch.Generator().manual_seed(batch))
    return (TS.InferenceEngine(model, CFG, HW, TC.BF16, batch=batch),
            TS.InferenceEngine(model, CFG, HW, TC.BF16, batch=batch,
                               cuda_graphs=False))


def _step(engine, frame):
    before = _kernels.launch_counts()
    out = engine.step(engine.put_frame(frame))
    after = _kernels.launch_counts()
    return out, {k: after[k] - before[k] for k in after}


def _same(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert torch.equal(a, b), what


def _kept(engine, out):
    """What the caller may keep of a step: its outputs, the bank and the
    read's keys; and clones of them to compare with later."""
    held = [] if out is None else [out["res1"]["pts3d"], out["res1"]["conf"]]
    held += [] if engine.mem is None else list(engine.mem)
    held += [] if engine._feat_k2 is None else [engine._feat_k2]
    return held, [t.clone() for t in held]


@pytest.mark.parametrize("batch", [1, 2])
def test_graphed_step_equals_eager_step(dev, batch, monkeypatch):
    """Frame by frame: the same res1 bits, bank, keys, carried states and
    kernel launches as the eager engine; the target head at each video's
    end alike; what frame t returned or left is unchanged after frame t+1;
    the graphs captured in the first video and replayed on every step of
    the second."""
    prunes = []
    orig_prune = TM.memory_prune
    monkeypatch.setattr(TM, "memory_prune",
                        lambda s, c: prunes.append(1) or orig_prune(s, c))
    graphed, eager = _engines(dev, batch)
    for v, video in enumerate(_videos(batch)):
        graphed.reset()
        eager.reset()
        assert graphed.stats["graph_captures"] == (GRAPHS if v else 0)
        kept = None
        for t, frame in enumerate(video):
            got, got_launches = _step(graphed, frame)
            want, want_launches = _step(eager, frame)
            assert got_launches == want_launches, (v, t)
            if kept is not None:
                for a, b in zip(*kept):
                    _same(a, b, f"video {v} frame {t - 1} kept")
            kept = _kept(graphed, got)
            assert (got is None) == (want is None)
            if got is not None:
                for k in ("pts3d", "conf"):
                    _same(got["res1"][k], want["res1"][k], f"{v} {t} {k}")
                for name in TM.MemoryState._fields:
                    _same(getattr(graphed.mem, name), getattr(eager.mem, name),
                          f"{v} {t} bank {name}")
                _same(graphed._feat_k2, eager._feat_k2, f"{v} {t} keys")
                for a, b in zip(graphed._last_hooks, eager._last_hooks):
                    _same(a, b, f"{v} {t} hooks")
            _same(graphed._feat_prev, eager._feat_prev, f"{v} {t} features")
        got, want = graphed.target_prediction(), eager.target_prediction()
        for k in ("pts3d", "conf"):
            _same(got[k], want[k], f"{v} target {k}")
        assert graphed.stats["graph_captures"] == GRAPHS
        assert graphed.stats["graph_replays"] == FRAMES - (0 if v else 2)
        assert graphed.stats["memory_reads"] == eager.stats["memory_reads"]
    assert prunes
    assert eager.stats["graph_captures"] == eager.stats["graph_replays"] == 0


def test_run_returns_distinct_tensors(dev):
    """`run` keeps every frame's prediction: each its own tensor, none
    overwritten by later replays, all equal to the eager engine's; and
    after a parameter is replaced by another tensor the engine captures
    its graphs anew rather than read the old one."""
    graphed, eager = _engines(dev, 1)
    video = _videos(1)[0]
    graphed.run(video)
    for new_weights in (False, True):
        if new_weights:
            norm = graphed.model.dust3r.enc_norm
            norm.weight = torch.nn.Parameter(norm.weight * 1.25)
        got, want = graphed.run(video), eager.run(video)
        assert graphed.stats["graph_captures"] == GRAPHS
        assert graphed.stats["graph_replays"] == FRAMES - 2 * new_weights
        assert len(got) == len(want) == FRAMES
        ptrs = [p[k].data_ptr() for p in got for k in p]
        assert len(set(ptrs)) == len(ptrs)
        for i, (a, b) in enumerate(zip(got, want)):
            assert list(a) == list(b)
            for k in a:
                _same(a[k], b[k], f"pred {i} {k}")


def test_patched_layers_act_on_every_frame(dev, monkeypatch):
    """`step` calls `pair_step`, and `pair_step` the decoder and the head
    through their module attributes, on every frame, with the replays
    beneath them: a patched `pair_step` that alters every third output,
    a patched head that turns TF32 on around itself (captured so), and a
    patched prune act on the graphed engine as on the eager one."""
    calls = {"pair": 0, "decode": 0, "head": 0, "prune": 0}
    orig = TS.pair_step, TD.decoder, TD.downstream_head, TM.memory_prune

    def pair(*a, **kw):
        out = orig[0](*a, **kw)
        calls["pair"] += 1
        if calls["pair"] % 3 == 0:
            out.res1["pts3d"] = out.res1["pts3d"] * 1.5
        return out

    def decode(*a, **kw):
        calls["decode"] += 1
        return orig[1](*a, **kw)

    def head(*a, **kw):
        calls["head"] += 1
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return orig[2](*a, **kw)
        finally:
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False

    def prune(s, c):
        calls["prune"] += 1
        return orig[3](s, c)

    monkeypatch.setattr(TS, "pair_step", pair)
    monkeypatch.setattr(TD, "decoder", decode)
    monkeypatch.setattr(TD, "downstream_head", head)
    monkeypatch.setattr(TM, "memory_prune", prune)
    graphed, eager = _engines(dev, 2)
    video = _videos(2)[0]
    counts, outs = [], []
    for engine in (graphed, eager):
        for k in calls:
            calls[k] = 0
        engine.reset()
        outs.append([engine.step(engine.put_frame(f)) for f in video][1:])
        counts.append(dict(calls))
    assert counts[0] == counts[1]
    assert counts[0]["pair"] == counts[0]["decode"] == FRAMES - 1
    assert counts[0]["head"] == FRAMES - 1 and counts[0]["prune"] > 0
    assert graphed.stats["graph_replays"] == FRAMES - 2
    for t, (a, b) in enumerate(zip(*outs)):
        for k in ("pts3d", "conf"):
            _same(a["res1"][k], b["res1"][k], f"frame {t + 1} {k}")
