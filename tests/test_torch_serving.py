"""Serving modes of spann3r_torch against the JAX package, on the CPU:
bf16 weight storage (`cast_serving_weights_`), int8 linear weights
(`quantize_linear_weights_`, weight-only and with int8 activations above
a row floor) and BF16_FAST (bf16 heads).

Configurations: the two tiny ones of tests/test_torch_model.py and, for
int8 (whose default selection needs dims >= 512), the 512-wide
linear-head one of tests/test_quant.py; weights carried across by
`state_dict_from_jax_params`. Tolerances: quantised weights and scales
bit for bit; cast weights give the same bits; int8 model outputs within
the port's BF16 bound (BF16_TOL of tests/test_torch_model.py); BF16_FAST
against JAX's BF16_FAST at BF16_TOL end to end and nearly bit for bit in
the head alone, and against the port's BF16 within the bounds
tests/test_precision_modes.py holds the JAX package's BF16_FAST to.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spann3r_tpu import config as JC
from spann3r_tpu.models import spann3r as JS
from spann3r_tpu.ops import layers as JL
from spann3r_tpu.ops import quant as JQ
from spann3r_torch import config as TC
from spann3r_torch.models import spann3r as TS
from spann3r_torch.ops import layers as TL
from spann3r_torch.ops import quant as TQ
from spann3r_torch.utils.convert import state_dict_from_jax_params
from tests.test_torch_model import BF16_TOL, HW, _compare_preds, _models

WIDE_HW = (32, 32)


def _wide_cfg(mod):
    return mod.Spann3RConfig(
        dust3r=mod.DUSt3RConfig(img_size=WIDE_HW, patch_size=16,
                                enc=mod.ViTConfig(dim=512, depth=2, num_heads=4),
                                dec=mod.ViTConfig(dim=512, depth=2, num_heads=4),
                                head_type="linear"),
        value_enc_depth=2, value_enc_dim=512, value_enc_heads=4,
        attn_head_in=512 + 512, attn_head_out=512)


_WIDE = {}


def _setup(kind):
    """(JAX cfg, port cfg, JAX params, numpy params, image hw)."""
    if kind != "wide":
        jcfg, tcfg, params, params_np, _ = _models(kind)
        return jcfg, tcfg, params, params_np, HW[kind]
    if not _WIDE:
        params = JS.init_spann3r(jax.random.PRNGKey(0), _wide_cfg(JC))
        _WIDE["v"] = (_wide_cfg(JC), _wide_cfg(TC), params,
                      jax.tree.map(np.asarray, params), WIDE_HW)
    return _WIDE["v"]


def _fresh(kind):
    """A port model of its own (the serving modes change it in place)."""
    _, tcfg, _, params_np, _ = _setup(kind)
    model = TS.build_spann3r(tcfg, "cpu", torch.Generator().manual_seed(0))
    model.load_state_dict(state_dict_from_jax_params(params_np, tcfg),
                          strict=True)
    return model


# ---------------------------------------------------------------------------
# int8 weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(768, 1024), (64, 48)])
def test_quantize_weight_matches_jax(shape):
    """q and scale of the same numpy weight, bit for bit, with a zero
    channel (scale clamped at 1e-12) and exact halves rounded to even."""
    w = np.random.default_rng(70).standard_normal(shape).astype(np.float32)
    w *= 0.02
    w[:, 0] = 0.0
    w[:, 1] = 0.0
    w[:4, 1] = [127.0, 0.5, 1.5, -2.5]      # scale 1: halves to even
    q, scale = JQ._quantize_weight(jnp.asarray(w))
    tq, tscale = TQ.quantize_weight(torch.from_numpy(w.T.copy()))
    assert tq.dtype == torch.int8 and tuple(tq.shape) == shape[::-1]
    assert tscale.dtype == torch.float32 and tuple(tscale.shape) == (shape[1], 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q).T)
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(scale).T)
    assert tq[1, :4].tolist() == [127, 0, 2, -2]
    assert tscale[0, 0] == torch.tensor(1e-12) and not tq[0].any()


def _jax_matrices(qparams) -> int:
    """int8 matrices of a JAX quantised pytree, a stacked (L, in, out)
    block weight counted L times."""
    leaves = jax.tree_util.tree_leaves_with_path(qparams)
    return sum(int(np.prod(np.shape(v)[:-2])) for p, v in leaves
               if getattr(p[-1], "key", None) == "w_q")


@pytest.mark.parametrize("kind,min_dim", [("dpt", 96), ("linear", 48),
                                          ("wide", 256), ("wide", 512)])
def test_quantize_selection_and_converter_match_jax(kind, min_dim):
    """Quantising in the port picks the tensors JAX's rule picks (read
    through the converter's key map: the same state-dict keys), and gives
    the same int8 weights and scales as JAX's quantised pytree carried
    across by the converter, bit for bit."""
    _, tcfg, params, _, _ = _setup(kind)
    qparams = JQ.quantize_linear_weights(params, min_dim=min_dim)
    want = state_dict_from_jax_params(jax.tree.map(np.asarray, qparams), tcfg)
    model = TQ.quantize_linear_weights_(_fresh(kind), min_dim=min_dim)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    n = TQ.count_quantized(model)
    assert n == _jax_matrices(qparams) > 0
    assert n == sum(k.endswith(".w_q") for k in got)
    assert not any(k.startswith(("attn_head", "dust3r.downstream_head"))
                   and k.endswith(".w_q") for k in got)
    # the converted pytree loads into the quantised port model as it is
    model.load_state_dict(want, strict=True)


def _pair_inputs(seed=71):
    rng = np.random.default_rng(seed)
    p = (WIDE_HW[0] // 16) * (WIDE_HW[1] // 16)
    feats = [rng.standard_normal((1, p, 512)).astype(np.float32) for _ in range(3)]
    from spann3r_tpu.models.vit import patch_positions
    pos = np.asarray(patch_positions(WIDE_HW[0] // 16, WIDE_HW[1] // 16))[None]
    return feats + [pos.copy()]


@pytest.mark.parametrize("act", [False, True])
def test_int8_pair_step_matches_jax(act, monkeypatch):
    """Both sides int8 (min_dim 256) at BF16, weight-only or with int8
    activations on every call (a floor of 2 rows, as tests/test_quant.py
    engages them at tiny shapes). The pointmaps and confidences of both
    heads hold the BF16 bound. The 512-wide bf16 features (the memory keys
    and value) are held by their relative RMS difference: without int8 the
    two sides' features already differ by 0.98% there (bf16 rounds at other
    places), weight-only int8 by 1.03%, and int8 activations by 2.43%,
    where a one-ulp difference in a bf16 activation can move its int8 code
    by one; the bounds are 2% and 5%."""
    jcfg, tcfg, params, _, hw = _setup("wide")
    qparams = JQ.quantize_linear_weights(params, min_dim=256)
    model = TQ.quantize_linear_weights_(_fresh("wide"), min_dim=256,
                                        act_min_rows=2 if act else 0)
    if act:
        monkeypatch.setenv("SPANN3R_INT8_ACT", "2")
    else:
        monkeypatch.delenv("SPANN3R_INT8_ACT", raising=False)
    args = _pair_inputs()
    ref = JS.pair_step(qparams, jcfg, *(jnp.asarray(a) for a in args), hw,
                       JC.BF16)
    with torch.no_grad():
        out = TS.pair_step(model, tcfg, *(torch.from_numpy(a) for a in args),
                           hw, TC.BF16)
    for res, rref in ((out.res1, ref.res1), (out.res2, ref.res2)):
        for k in ("pts3d", "conf"):
            np.testing.assert_allclose(res[k].numpy(), np.asarray(rref[k]),
                                       rtol=BF16_TOL, atol=BF16_TOL, err_msg=k)
    for a, b in ((out.feat_k1, ref.feat_k1), (out.feat_k2, ref.feat_k2),
                 (out.cur_v, ref.cur_v)):
        a, b = a.float().numpy(), np.asarray(b, np.float32)
        rel = np.linalg.norm(a - b) / np.linalg.norm(b)
        assert rel < (5e-2 if act else 2e-2), rel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_activation_linear_matches_jax(dtype, monkeypatch):
    """The int8-activation `linear` (floor 1024 rows, JAX's SPANN3R_INT8_ACT
    =1) on 2048 rows gives JAX's bits; 4 rows, below the floor, take the
    weight-only path: the same bits as a weight-only module, and JAX's
    output within fp32 (1e-5) or one bf16 rounding (8e-3)."""
    rng = np.random.default_rng(72)
    w = rng.standard_normal((768, 1024)).astype(np.float32) * 0.02
    b = rng.standard_normal((1024,)).astype(np.float32) * 0.01
    p = JQ.quantize_linear_weights({"lin": {"w": jnp.asarray(w),
                                            "b": jnp.asarray(b)}})["lin"]
    big = rng.standard_normal((2, 1024, 768)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    monkeypatch.setenv("SPANN3R_INT8_ACT", "1")
    ref_big = np.asarray(JL.linear(p, jnp.asarray(big).astype(jdt)), np.float32)
    ref_small = np.asarray(JL.linear(p, jnp.asarray(big[:1, :4]).astype(jdt)),
                           np.float32)

    def module(rows):
        q, s = TQ.quantize_weight(torch.from_numpy(w.T.copy()))
        return TL.QuantLinear(q, s, torch.nn.Parameter(torch.from_numpy(b)),
                              rows)

    tdt = getattr(torch, dtype)
    m, m_off = module(TQ.INT8_ACT_ROWS), module(0)
    x = torch.from_numpy(big).to(tdt)
    with torch.no_grad():
        y_big, y_small = TL.linear(m, x), TL.linear(m, x[:1, :4])
        y_off, y_off_small = TL.linear(m_off, x), TL.linear(m_off, x[:1, :4])
    assert y_big.dtype == tdt and tuple(y_big.shape) == (2, 1024, 1024)
    np.testing.assert_array_equal(y_big.float().numpy(), ref_big)
    torch.testing.assert_close(y_small, TL.linear(m_off, x[:1, :4]), rtol=0,
                               atol=0)
    tol = 1e-5 if dtype == "float32" else 8e-3
    np.testing.assert_allclose(y_small.float().numpy(), ref_small, rtol=tol,
                               atol=tol)
    # the int8 product is what changed: the weight-only path is off by more
    assert not torch.equal(y_big, y_off)


# ---------------------------------------------------------------------------
# bf16 weight storage
# ---------------------------------------------------------------------------

def _video(kind, t=6, seed=73):
    h, w = _setup(kind)[4]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((t, 1, h, w, 3)) * 0.4).astype(np.float32)


def _run_video(model, kind, frames, prec):
    _, tcfg, _, _, hw = _setup(kind)
    return TS.InferenceEngine(model, tcfg, hw, prec).run_video(frames, chunk=4)


@pytest.mark.parametrize("kind", ["dpt", "linear"])
def test_cast_serving_weights_same_bits_under_bf16(kind):
    frames = _video(kind)
    plain = _run_video(_fresh(kind), kind, frames, TC.BF16)
    cast = TQ.cast_serving_weights_(_fresh(kind))
    out = _run_video(cast, kind, frames, TC.BF16)
    assert len(out) == len(plain) == len(frames)
    for a, b in zip(out, plain):
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("kind", ["dpt", "linear"])
def test_cast_serving_weights_dtype_map_matches_jax(kind):
    """Every tensor the JAX rule stores in bf16, and only those, is bf16 in
    the port (read through the converter's key map), and the JAX test's
    named cases (tests/test_quant.py) hold."""
    _, tcfg, params, _, _ = _setup(kind)
    cast = JQ.cast_serving_weights(params)
    flags = jax.tree.map(lambda a: np.full(np.shape(a), float(
        a.dtype == jnp.bfloat16), np.float32), cast)
    want = state_dict_from_jax_params(flags, tcfg)
    got = TQ.cast_serving_weights_(_fresh(kind)).state_dict()
    assert set(got) == set(want)
    for k, flag in want.items():
        assert (got[k].dtype == torch.bfloat16) == bool(flag.flatten()[0]), k
        assert got[k].dtype in (torch.bfloat16, torch.float32), k
    head = ("dust3r.downstream_head1.dpt.act_postprocess.0.0.weight"
            if kind == "dpt" else "dust3r.downstream_head1.proj.weight")
    assert got["norm_q.weight"].dtype == torch.float32
    assert got[head].dtype == torch.float32
    assert got["dust3r.enc_blocks.0.attn.qkv.weight"].dtype == torch.bfloat16
    assert got["attn_head_1.0.weight"].dtype == torch.bfloat16
    assert got["dust3r.enc_norm.weight"].dtype == torch.float32


# ---------------------------------------------------------------------------
# BF16_FAST
# ---------------------------------------------------------------------------

def _fast_bounds(fast, ref):
    """tests/test_precision_modes.py's bounds of BF16_FAST against a
    reference run; returns the largest relative pointmap change."""
    pts_f = np.concatenate([p[k].ravel() for p in fast for k in p if k != "conf"])
    pts_r = np.concatenate([p[k].ravel() for p in ref for k in p if k != "conf"])
    conf_f = np.concatenate([p["conf"].ravel() for p in fast])
    conf_r = np.concatenate([p["conf"].ravel() for p in ref])
    rel = np.abs(pts_f - pts_r) / (np.abs(pts_r).mean() + 1e-6)
    assert np.median(rel) < 2e-2, np.median(rel)
    assert np.quantile(rel, 0.99) < 1e-1, np.quantile(rel, 0.99)
    rel_c = np.abs(conf_f - conf_r) / (np.abs(conf_r) + 1e-6)
    assert np.median(rel_c) < 5e-3, np.median(rel_c)
    agree = ((conf_f > 1.001) == (conf_r > 1.001)).mean()
    assert agree > 0.98, agree
    return float(rel.max())


def _uint8_video(t=6, seed=5):
    return np.random.default_rng(seed).integers(
        0, 256, (t, 1, *HW["dpt"], 3)).astype(np.uint8)


def test_bf16_fast_matches_jax_bf16_fast():
    """The port's BF16_FAST against JAX's BF16_FAST. End to end, the video
    holds the BF16 bound (BF16_TOL). At this size the trunk's bf16
    rounding, which differs between the two sides, moves the pointmaps as
    far as the head dtype does, so the head is also held alone, on the
    same bf16 decoder hook states: its outputs are bf16 values (the head
    ran in bf16 to its end, as JAX's), and its confidences equal JAX's bit
    for bit on at least 99% of the pixels (99.7% measured) and within one
    bf16 ulp elsewhere. An fp32 head rounded to bf16 at its end matches
    JAX's on 77% only. The pointmaps, whose values cross zero, are held at
    the 99th percentile of |a - b| / mean|b| < 5e-2 (2.5e-2 measured)."""
    jcfg, tcfg, params, _, hw = _setup("dpt")
    frames = _uint8_video()
    ref = JS.InferenceEngine(params, jcfg, hw, JC.BF16_FAST).run_video(frames)
    model = _fresh("dpt")
    out = _run_video(model, "dpt", frames, TC.BF16_FAST)
    _compare_preds(out, ref, BF16_TOL)

    rng = np.random.default_rng(74)
    from spann3r_tpu.models.vit import patch_positions
    p = (hw[0] // 16) * (hw[1] // 16)
    pos = np.asarray(patch_positions(hw[0] // 16, hw[1] // 16))[None]
    feats = [jnp.asarray(rng.standard_normal((1, p, jcfg.dust3r.enc.dim)),
                         jnp.float32) for _ in range(3)]
    hooks = JS.pair_step(params, jcfg, *feats, jnp.asarray(pos), hw, JC.BF16,
                         compute_res2=False).dec2_hooks
    assert all(h.dtype == jnp.bfloat16 for h in hooks)
    want = JS.head2_from_hooks(params, jcfg, hooks, hw, JC.BF16_FAST)
    with torch.no_grad():
        got = TS.head2_from_hooks(
            model, tcfg, tuple(torch.from_numpy(np.asarray(h, np.float32))
                               .to(torch.bfloat16) for h in hooks),
            hw, TC.BF16_FAST)
    for k in ("pts3d", "conf"):
        assert torch.equal(got[k].to(torch.bfloat16).float(), got[k]), k
    a, b = got["conf"].numpy(), np.asarray(want["conf"], np.float32)
    assert (a == b).mean() >= 0.99, (a == b).mean()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(b))) - 7)
    assert (np.abs(a - b) <= ulp).all()
    a, b = got["pts3d"].numpy(), np.asarray(want["pts3d"], np.float32)
    rel = np.abs(a - b) / np.abs(b).mean()
    assert np.quantile(rel, 0.99) < 5e-2, np.quantile(rel, 0.99)


def test_bf16_fast_against_bf16():
    """The heads really run in bf16 (the outputs move: rel.max() > 0), and
    no further than tests/test_precision_modes.py allows."""
    model = _fresh("dpt")
    frames = _uint8_video()
    fast = _run_video(model, "dpt", frames, TC.BF16_FAST)
    ref = _run_video(model, "dpt", frames, TC.BF16)
    assert _fast_bounds(fast, ref) > 0.0
