"""The frame-at-a-time engine of spann3r_torch (`InferenceEngine.reset /
encode / put_frame / step / target_prediction / run`) against the JAX
package's engine, on the CPU, at FP32, on the two tiny configurations of
tests/test_torch_model.py (the DPT one prunes its memory within 8 frames).

Tolerance: 5e-4 (rtol and atol), the one of the port's whole-video
comparisons in tests/test_torch_model.py: eight frames of a recurrent
memory carry the per-module 1e-4 forward.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spann3r_tpu import config as JC
from spann3r_tpu.models import spann3r as JS
from spann3r_torch import config as TC
from spann3r_torch.models import memory as TM
from spann3r_torch.models import spann3r as TS
from tests.test_torch_model import HW, _frames, _models

TOL = 5e-4


def _close(a, b, msg=""):
    if isinstance(a, torch.Tensor):
        a = a.detach().float().numpy()
    np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=TOL,
                               atol=TOL, err_msg=msg)


def _engines(kind):
    jcfg, tcfg, params, _, model = _models(kind)
    return (JS.InferenceEngine(params, jcfg, HW[kind], JC.FP32),
            TS.InferenceEngine(model, tcfg, HW[kind], TC.FP32))


@pytest.mark.parametrize("kind", ["dpt", "linear"])
def test_step_and_target_prediction_match_jax(kind, monkeypatch):
    """Frame by frame: None on the first frame, then res1 of each pair and
    the deferred target head on demand; the memory bank alike."""
    prunes = []
    orig_prune = TM.memory_prune
    monkeypatch.setattr(TM, "memory_prune",
                        lambda s, c: prunes.append(1) or orig_prune(s, c))
    jeng, teng = _engines(kind)
    frames = _frames(kind, seed=60)
    for i, f in enumerate(frames):
        ref = jeng.step(jnp.asarray(f))
        out = teng.step(teng.put_frame(f), want_res2=(i == 4))
        if i == 0:
            assert ref is None and out is None
            assert teng.target_prediction() is None
            continue
        assert set(out) == {"res1", "res2"}
        for k in ("pts3d", "conf"):
            _close(out["res1"][k], ref["res1"][k], f"frame {i} {k}")
        tgt, ref_tgt = teng.target_prediction(), jeng.target_prediction()
        for k in ("pts3d", "conf"):
            _close(tgt[k], ref_tgt[k], f"frame {i} target {k}")
            if i == 4:
                torch.testing.assert_close(out["res2"][k], tgt[k], rtol=0,
                                           atol=0)
            else:
                assert out["res2"] is None
    assert teng.stats["memory_reads"] == len(frames) - 2
    for name in ("size", "wm", "lm"):
        np.testing.assert_array_equal(getattr(teng.mem, name).numpy(),
                                      np.asarray(getattr(jeng.mem, name)))
    _close(teng.mem.k, np.asarray(jeng.mem.k, np.float32), "bank keys")
    if kind == "dpt":
        assert prunes


@pytest.mark.parametrize("kind", ["dpt", "linear"])
def test_run_matches_jax_and_run_video(kind):
    """`run` gives the JAX engine's preds, and the port's own chunked
    `run_video` (chunk 3) on the same frames."""
    jeng, teng = _engines(kind)
    frames = _frames(kind, seed=61)
    ref = jeng.run(frames)
    out = teng.run(frames)
    video = teng.run_video(frames, chunk=3)
    assert len(out) == len(ref) == len(video) == len(frames)
    for i, (a, b, c) in enumerate(zip(out, ref, video)):
        assert list(a) == list(b) == list(c)
        for k in b:
            assert isinstance(a[k], torch.Tensor) and a[k].dtype == torch.float32
            assert tuple(a[k].shape) == np.asarray(b[k]).shape == c[k].shape
            _close(a[k], b[k], f"pred {i} {k} vs JAX run")
            _close(a[k], c[k], f"pred {i} {k} vs run_video")


def test_reset_starts_a_new_stream():
    """A second `run` on the same engine gives the first one's results,
    and `reset` drops the bank and forgets the previous frame. A new
    engine holds no bank until its first pair."""
    _, teng = _engines("linear")
    frames = _frames("linear", t=4, seed=62)
    assert teng.mem is None
    first = teng.run(frames)
    assert int(teng.mem.size[0]) > 0 and teng.target_prediction() is not None
    second = teng.run(frames)
    for a, b in zip(first, second):
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    teng.reset()
    assert teng.mem is None and teng.target_prediction() is None
    assert teng.step(teng.put_frame(frames[0])) is None and teng.mem is None
    teng.step(teng.put_frame(frames[1]))
    assert int(teng.mem.size[0]) > 0


def test_encode_and_put_frame():
    """put_frame hands a frame to the model's device (the CPU here);
    encode takes uint8 or normalised float frames, as the JAX engine."""
    jeng, teng = _engines("linear")
    f = _frames("linear", t=1, seed=63)[0]
    t = teng.put_frame(f)
    assert isinstance(t, torch.Tensor) and t.device == teng.device
    assert t.dtype == torch.uint8 and tuple(t.shape) == f.shape
    for img in (f, f.astype(np.float32) / 127.5 - 1.0):
        feats, pos = teng.encode(torch.from_numpy(img))
        ref, ref_pos = jeng.encode(jnp.asarray(img))
        _close(feats, ref)
        np.testing.assert_array_equal(pos.numpy(), np.asarray(ref_pos))


def test_cpu_engine_never_captures():
    """CUDA graphs are the card's alone: an engine on the CPU captures and
    replays nothing, over two streams, and gives the bits of an engine
    built with its graphs turned off."""
    _, tcfg, _, _, model = _models("dpt")
    frames = _frames("dpt", seed=64)
    engines = [TS.InferenceEngine(model, tcfg, HW["dpt"], TC.FP32,
                                  cuda_graphs=on) for on in (True, False)]
    runs = [[e.run(frames) for _ in range(2)] for e in engines]
    for e in engines:
        assert e._graphs is None
        assert e.stats["graph_captures"] == e.stats["graph_replays"] == 0
    for a, b in zip(sum(runs[0], []), sum(runs[1], [])):
        assert list(a) == list(b)
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
