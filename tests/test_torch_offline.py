"""Pairwise inference and offline reconstruction of spann3r_torch against
the JAX package, on the CPU, on the two tiny configurations of
tests/test_torch_model.py (weights carried across by
`state_dict_from_jax_params`), at FP32.

Tolerances: module outputs 1e-4 (rtol and atol), whole reconstructions
5e-4, as in tests/test_torch_model.py. The greedy loop picks frames by an
argmax, so a near tie between two candidates could make the two sides
pick different frames; every comparison asserts that the gap between the
best two scores is larger than GAP_TOL, above ten times the most the two
sides' scores were seen to differ by (7e-7, a few fp32 ulps at ~1.0), so
a tie fails loudly rather than at random. With random weights the scores
of the linear-head configuration spread over only ~3e-4, and some inputs
hold near ties; the frames here are drawn from a seed without one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spann3r_tpu import api as JAPI
from spann3r_tpu import config as JC
from spann3r_tpu.models import dust3r as JD
from spann3r_tpu.models import inference as JI
from spann3r_tpu.models import offline as JO
from spann3r_tpu.models import pairs as JP
from spann3r_torch import api as TAPI
from spann3r_torch import config as TC
from spann3r_torch.models import dust3r as TD
from spann3r_torch.models import inference as TI
from spann3r_torch.models import offline as TO
from spann3r_torch.models import pairs as TP
from spann3r_torch.models.vit import patch_positions
from spann3r_torch.ops import _kernels
from spann3r_torch.ops import rope as TR
from tests.test_torch_model import HW, _models

TOL = 1e-4
RECON_TOL = 5e-4
SEED = 54   # frames whose candidate scores hold no near tie
GAP_TOL = 1e-5


def _imgs(kind, n, seed):
    h, w = HW[kind]
    return (np.random.default_rng(seed).standard_normal((n, h, w, 3))
            .astype(np.float32) * 0.3)


def _close(a, b, tol=TOL, msg=""):
    if isinstance(a, torch.Tensor):
        a = a.detach().float().numpy()
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol,
                               err_msg=msg)


# ---------------------------------------------------------------------------
# scene graphs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefilter", [None, "seq1", "seq2", "cyc1"])
@pytest.mark.parametrize("symmetrize", [True, False])
@pytest.mark.parametrize("graph", ["complete", "swin", "swin-2", "oneref",
                                   "oneref-2", "prev"])
def test_make_pairs_matches_jax(graph, symmetrize, prefilter):
    for n in (3, 5, 7):
        assert TP.make_pairs(n, graph, prefilter, symmetrize) == \
            JP.make_pairs(n, graph, prefilter, symmetrize)


def test_make_pairs_of_views():
    """View dicts are paired as they are and prefiltered by their 'idx'."""
    views = [{"idx": i, "img": None} for i in range(5)]
    got = TP.make_pairs(views, "complete", prefilter="cyc1")
    assert got == JP.make_pairs(views, "complete", prefilter="cyc1")
    assert all(isinstance(a, dict) for pair in got for a in pair)
    with pytest.raises(ValueError, match="unknown scene graph"):
        TP.make_pairs(3, "ring")


# ---------------------------------------------------------------------------
# two-view forward and pairwise inference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shapes", ["same", "mixed"])
@pytest.mark.parametrize("kind", ["dpt", "linear"])
def test_dust3r_forward(kind, shapes):
    """Views of one shape share an encoder batch; a second view of another
    shape (a portrait one) is encoded on its own."""
    jcfg, tcfg, params, _, model = _models(kind)
    h, w = HW[kind]
    rng = np.random.default_rng(50)
    img1 = rng.standard_normal((2, h, w, 3)).astype(np.float32)
    hw2 = (h, w) if shapes == "same" else (h + 16, w - 16)
    img2 = rng.standard_normal((2, *hw2, 3)).astype(np.float32)
    ref1, ref2 = JD.forward(params["dust3r"], jnp.asarray(img1),
                            jnp.asarray(img2), jcfg.dust3r, JC.FP32)
    out1, out2 = TD.forward(model.dust3r, torch.from_numpy(img1),
                            torch.from_numpy(img2), tcfg.dust3r, TC.FP32)
    assert set(out1) == set(ref1) == {"pts3d", "conf"}
    assert set(out2) == set(ref2) == {"pts3d_in_other_view", "conf"}
    for out, ref in ((out1, ref1), (out2, ref2)):
        for k in ref:
            assert tuple(out[k].shape) == ref[k].shape
            _close(out[k], ref[k], msg=k)


@pytest.mark.parametrize("kind", ["dpt", "linear"])
def test_inference_matches_jax(kind):
    """12 pairs in batches of 5 (the last one short): the reference's
    view/pred contract, row for row."""
    jcfg, tcfg, params, _, model = _models(kind)
    imgs = _imgs(kind, 4, 51)
    views = [{"img": imgs[i:i + 1], "idx": i} for i in range(4)]
    pairs = TP.make_pairs(views, "complete")
    ref = JI.inference(pairs, params["dust3r"], jcfg.dust3r, batch_size=5,
                       prec=JC.FP32, verbose=False)
    out = TI.inference(pairs, model.dust3r, tcfg.dust3r, batch_size=5,
                       prec=TC.FP32, verbose=False)
    assert out["view1"] == ref["view1"] and out["view2"] == ref["view2"]
    for pred in ("pred1", "pred2"):
        assert set(out[pred]) == set(ref[pred])
        for k in ref[pred]:
            assert out[pred][k].shape == ref[pred][k].shape == (
                (12, *HW[kind], 3) if k != "conf" else (12, *HW[kind]))
            assert out[pred][k].dtype == np.float32
            _close(out[pred][k], ref[pred][k], msg=f"{pred} {k}")


@pytest.mark.parametrize("kind", ["dpt", "linear"])
def test_pairwise_confidences_and_initial_pair(kind):
    """20 pairs of 5 frames in chunks of 8 (the JAX side pads the last
    chunk, the port decodes the 4 there are), then the argmax pair."""
    jcfg, tcfg, params, _, model = _models(kind)
    imgs = _imgs(kind, 5, SEED)
    pairs = TP.make_pairs(5, "complete")
    feats, pos = JD.encode_image(params["dust3r"], jnp.asarray(imgs),
                                 jcfg.dust3r, JC.FP32)
    ref = JO.pairwise_confidences(params["dust3r"],
                                  {i: feats[i] for i in range(5)}, pos, pairs,
                                  HW[kind], jcfg, JC.FP32)
    tfeats, tpos = TD.encode_image(model.dust3r, torch.from_numpy(imgs),
                                   tcfg.dust3r, TC.FP32)
    out = TO.pairwise_confidences(model.dust3r, tfeats, tpos, pairs,
                                  HW[kind], tcfg, TC.FP32)
    assert out.shape == (len(pairs),) and out.dtype == np.float32
    _close(out, ref)
    assert np.abs(out - ref).max() < GAP_TOL / 10
    top2 = np.sort(out)[-2:]
    assert top2[1] - top2[0] > GAP_TOL, top2
    assert TO.find_initial_pair(pairs, out, 5) == \
        JO.find_initial_pair(pairs, ref, 5)


# ---------------------------------------------------------------------------
# greedy next-best-view reconstruction
# ---------------------------------------------------------------------------

_JAX_RUNS = {}


def _jax_offline(kind, fn, n, seed):
    key = (kind, fn, n, seed)
    if key not in _JAX_RUNS:
        jcfg, _, params, _, _ = _models(kind)
        _JAX_RUNS[key] = getattr(JO, fn)(params, _imgs(kind, n, seed), jcfg,
                                         HW[kind], scene_graph="complete",
                                         prec=JC.FP32)
    return _JAX_RUNS[key]


def _compare_recon(out, ref, tol=RECON_TOL):
    preds, preds_all, idx_used = out
    rpreds, rpreds_all, ridx = ref
    assert idx_used == list(ridx)
    assert len(preds) == len(rpreds) and len(preds_all) == len(rpreds_all)
    for i, (a, b) in enumerate(zip(preds, rpreds)):
        assert list(a) == list(b), (i, list(a), list(b))
        for k in b:
            assert a[k].shape == np.asarray(b[k]).shape
            _close(a[k], b[k], tol, msg=f"pred {i} {k}")
    for (a1, a2), (b1, b2) in zip(preds_all, rpreds_all):
        for a, b in ((a1, b1), (a2, b2)):
            assert set(a) == set(b)
            for k in b:
                _close(a[k], b[k], tol, msg=k)


def _record_scores(monkeypatch):
    """The candidate scores of each greedy round, as the port computed them."""
    rounds = []
    orig = TO._score_candidates

    def recording(*a, **kw):
        s = orig(*a, **kw)
        rounds.append(s.numpy().copy())
        return s

    monkeypatch.setattr(TO, "_score_candidates", recording)
    return rounds


def _assert_no_ties(rounds, idx_used):
    """Each round scores only the frames not used yet, and its best two
    scores are further apart than GAP_TOL."""
    n = len(idx_used)
    for r, scores in enumerate(rounds):
        assert len(scores) == n - 2 - r, (r, scores)
        top2 = np.sort(scores)[-2:]
        if len(scores) > 1:
            assert top2[1] - top2[0] > GAP_TOL, (r, scores)


@pytest.mark.parametrize("fn", ["offline_reconstruction",
                                "offline_reconstruction_fused"])
@pytest.mark.parametrize("n", [5, 2])
@pytest.mark.parametrize("kind", ["dpt", "linear"])
def test_offline_matches_jax(kind, n, fn, monkeypatch):
    """The same frame order and the same predictions as each of the JAX
    package's two greedy versions (its loop and its fused scan), for a
    clip with greedy rounds and for the two-frame clip with none."""
    _, tcfg, _, _, model = _models(kind)
    seed = SEED
    rounds = _record_scores(monkeypatch)
    out = getattr(TO, fn)(model, _imgs(kind, n, seed), tcfg, HW[kind],
                          scene_graph="complete", prec=TC.FP32)
    assert len(rounds) == n - 2
    _assert_no_ties(rounds, out[2])
    _compare_recon(out, _jax_offline(kind, fn, n, seed))
    assert sorted(out[2]) == list(range(n))


@pytest.mark.parametrize("graph", ["complete", "swin-2"])
def test_api_offline_matches_jax(graph, monkeypatch):
    jcfg, tcfg, params, _, model = _models("dpt")
    frames = _imgs("dpt", 5, SEED)[:, None]
    rounds = _record_scores(monkeypatch)
    ref, ref_order, _ = JAPI.reconstruct_video(params, jcfg, frames, JC.FP32,
                                               offline=True, scene_graph=graph)
    preds, order, fps = TAPI.reconstruct_video(model, tcfg, frames, TC.FP32,
                                               offline=True, scene_graph=graph)
    _assert_no_ties(rounds, order)
    assert order == list(ref_order) and fps > 0
    assert len(preds) == len(ref) == 5
    for i, (a, b) in enumerate(zip(preds, ref)):
        assert set(a) == set(b)
        for k in b:
            _close(a[k], b[k], RECON_TOL, msg=f"pred {i} {k}")


def test_offline_rejects_batches_and_raw_frames():
    _, tcfg, _, _, model = _models("linear")
    imgs = _imgs("linear", 3, 55)
    with pytest.raises(ValueError, match="single-stream"):
        TAPI.reconstruct_video(model, tcfg, np.stack([imgs, imgs], 1),
                               offline=True)
    raw = (imgs * 100).astype(np.uint8)
    with pytest.raises(ValueError, match="normalised float"):
        TO.offline_reconstruction(model, raw, tcfg, HW["linear"])


# ---------------------------------------------------------------------------
# the kernels' launcher at the offline decoder's shapes
# ---------------------------------------------------------------------------

class _FakeLib:
    """Stands in for the built library: records the RoPE launch."""

    def __init__(self):
        self.calls = []

    def spann3r_rope2d(self, n_ops, ptrs, strides, n_tokens, shared, *rest):
        self.calls.append({"n_ops": n_ops, "shared": shared})
        return 0


@pytest.mark.parametrize("attn", ["self", "cross"])
def test_offline_decoder_rope_shares_positions(attn, monkeypatch):
    """The offline decoder runs at batch 8 (and at the count of candidate
    frames of a greedy round) with the positions
    expanded over the batch with stride 0. Its q and k (slices of one qkv
    projection, or two projections of the cross-attention) take the same
    positions tensor, so the launcher's shared-positions test holds and one
    block rotates both operands."""
    fake = _FakeLib()
    monkeypatch.setattr(_kernels, "lib", lambda: fake)
    monkeypatch.setattr(_kernels, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(TR, "_sm_count", lambda dev: 132)
    b, n, h, d = 8, 48, 12, 64
    pos = patch_positions(6, 8)[None].expand(b, -1, -1)
    if attn == "self":
        qkv = torch.zeros(b, n, 3, h, d).permute(2, 0, 3, 1, 4)
        q, k = qkv[0], qkv[1]
    else:
        q, k = (torch.zeros(b, n, h * d).reshape(b, n, h, d).transpose(1, 2)
                for _ in range(2))
    TR._launch([(q, pos), (k, pos)], 100.0, 1.0)
    assert fake.calls == [{"n_ops": 2, "shared": 1}]
    # positions of their own (another tensor) take a block per operand
    TR._launch([(q, pos), (k, pos.clone())], 100.0, 1.0)
    assert fake.calls[-1] == {"n_ops": 2, "shared": 0}
