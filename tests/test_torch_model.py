"""spann3r_torch model against the JAX package on the same weights, on the CPU.

Weights: JAX init -> numpy pytree -> `state_dict_from_jax_params` ->
`load_state_dict(strict=True)`. Two tiny configurations: the DPT one of
tests/test_precision_modes.py (64x64, a memory small enough to prune) and
the linear-head one of tools/readiness_drill.py (32x32, 12 decoder blocks).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spann3r_tpu import config as JC
from spann3r_tpu.models import dust3r as JD
from spann3r_tpu.models import spann3r as JS
from spann3r_tpu.utils import torch_ckpt
from spann3r_torch import api as TAPI
from spann3r_torch import config as TC
from spann3r_torch.models import dust3r as TD
from spann3r_torch.models import memory as TM
from spann3r_torch.models import spann3r as TS
from spann3r_torch.utils.convert import state_dict_from_jax_params

TOL = 1e-4
VIDEO_TOL = 5e-4
# BF16: the scan emits its outputs rounded to bf16 (as the JAX scan does),
# and the two sides round activations at different places before that (the
# JAX XLA memory read casts the attention weights to bf16, the port keeps
# them fp32 like the fused kernel; bf16 GEMMs on the two backends round at
# other points). Measured: outputs differ by at most one bf16 ulp (2^-7
# relative, 1.6e-2 at conf ~2); 1e-2 relative plus 1e-2 absolute covers it.
BF16_TOL = 1e-2


def _cfg(mod, kind):
    if kind == "dpt":
        return mod.Spann3RConfig(
            dust3r=mod.DUSt3RConfig(
                img_size=(64, 64), patch_size=16,
                enc=mod.ViTConfig(dim=128, depth=2, num_heads=4),
                dec=mod.ViTConfig(dim=96, depth=2, num_heads=4),
                head_type="dpt", dpt_feature_dim=32, dpt_last_dim=16,
                dpt_layer_dims=(16, 24, 32, 48)),
            memory=mod.MemoryConfig(long_mem_size=64, work_mem_size=2),
            value_enc_depth=1, value_enc_dim=128, value_enc_heads=4,
            attn_head_in=128 + 96, attn_head_out=128)
    return mod.Spann3RConfig(
        dust3r=mod.DUSt3RConfig(img_size=(32, 32), patch_size=16,
                                enc=mod.ViTConfig(dim=64, depth=2, num_heads=4),
                                dec=mod.ViTConfig(dim=48, depth=12, num_heads=4),
                                head_type="linear"),
        value_enc_depth=2, value_enc_dim=64, value_enc_heads=4,
        attn_head_in=64 + 48, attn_head_out=64)


HW = {"dpt": (64, 64), "linear": (32, 32)}
_CACHE = {}


def _models(kind):
    if kind not in _CACHE:
        jcfg, tcfg = _cfg(JC, kind), _cfg(TC, kind)
        params = JS.init_spann3r(jax.random.PRNGKey(0), jcfg)
        params_np = jax.tree.map(np.asarray, params)
        model = TS.build_spann3r(tcfg, "cpu", torch.Generator().manual_seed(0))
        model.load_state_dict(state_dict_from_jax_params(params_np, tcfg),
                              strict=True)
        _CACHE[kind] = (jcfg, tcfg, params, params_np, model)
    return _CACHE[kind]


def _feats(kind, seed, n=1):
    jcfg = _cfg(JC, kind)
    h, w = HW[kind]
    p = (h // 16) * (w // 16)
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, p, jcfg.dust3r.enc.dim)).astype(np.float32)
            for _ in range(3)]


def _pos(kind, n=1):
    h, w = HW[kind]
    from spann3r_tpu.models.vit import patch_positions
    return np.broadcast_to(np.asarray(patch_positions(h // 16, w // 16))[None],
                           (n, (h // 16) * (w // 16), 2)).copy()


def _close(a, b, tol=TOL):
    if isinstance(a, torch.Tensor):
        a = a.detach().float().numpy()
    np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# converter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dpt", "linear"])
def test_converter_matches_torch_ckpt(kind):
    jcfg, tcfg, _, params_np, _ = _models(kind)
    ref = torch_ckpt.to_torch_state_dict_spann3r(params_np, jcfg)
    sd = state_dict_from_jax_params(params_np, tcfg)
    assert set(sd) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


def test_full_config_keys_match_published():
    with torch.device("meta"):
        model = TS.Spann3R(TC.Spann3RConfig())
    path = os.path.join(os.path.dirname(__file__), "data",
                        "spann3r_published_keys.txt")
    with open(path) as f:
        published = {ln.strip() for ln in f if ln.strip()}
    want = {k for k in published if not torch_ckpt.is_alias_or_vestigial_key(k)}
    assert set(model.state_dict()) == want


def test_capacity():
    mem = TC.MemoryConfig()
    assert mem.capacity(768) == 8704
    assert mem.capacity(196) == 5248


# ---------------------------------------------------------------------------
# modules, FP32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dpt", "linear"])
def test_encode_image(kind):
    jcfg, tcfg, params, _, model = _models(kind)
    h, w = HW[kind]
    img = np.random.default_rng(40).standard_normal((2, h, w, 3)).astype(np.float32)
    ref, ref_pos = JD.encode_image(params["dust3r"], jnp.asarray(img),
                                   jcfg.dust3r, JC.FP32)
    out, pos = TD.encode_image(model.dust3r, torch.from_numpy(img),
                               tcfg.dust3r, TC.FP32)
    _close(out, ref)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(ref_pos))


@pytest.mark.parametrize("kind", ["dpt", "linear"])
def test_decoder(kind):
    jcfg, tcfg, params, _, model = _models(kind)
    f1, f2, _ = _feats(kind, 41)
    pos = _pos(kind)
    ref1, ref2 = JD.decoder(params["dust3r"], jnp.asarray(f1), jnp.asarray(pos),
                            jnp.asarray(f2), jnp.asarray(pos), jcfg.dust3r, JC.FP32)
    out1, out2 = TD.decoder(model.dust3r, torch.from_numpy(f1),
                            torch.from_numpy(pos), torch.from_numpy(f2),
                            torch.from_numpy(pos), tcfg.dust3r, TC.FP32)
    assert [s is None for s in out1] == [s is None for s in ref1]
    for a, b in zip(out1 + out2, list(ref1) + list(ref2)):
        if b is not None:
            _close(a, b)


@pytest.mark.parametrize("kind", ["dpt", "linear"])
def test_downstream_head(kind):
    jcfg, tcfg, params, _, model = _models(kind)
    f1, f2, _ = _feats(kind, 42)
    pos = _pos(kind)
    dec1, _ = JD.decoder(params["dust3r"], jnp.asarray(f1), jnp.asarray(pos),
                         jnp.asarray(f2), jnp.asarray(pos), jcfg.dust3r, JC.FP32)
    states = [None if s is None else torch.from_numpy(np.array(s)) for s in dec1]
    for num in (1, 2):
        ref = JD.downstream_head(params["dust3r"], num, dec1, HW[kind],
                                 jcfg.dust3r, JC.FP32)
        out = TD.downstream_head(model.dust3r, num, states, HW[kind],
                                 tcfg.dust3r, TC.FP32)
        assert set(out) == set(ref) == {"pts3d", "conf"}
        for k in ref:
            assert tuple(out[k].shape) == ref[k].shape
            _close(out[k], ref[k])


@pytest.mark.parametrize("kind", ["dpt", "linear"])
def test_pair_step(kind):
    jcfg, tcfg, params, _, model = _models(kind)
    fuse, f1, f2 = _feats(kind, 43)
    pos = _pos(kind)
    for compute_res2 in (True, False):
        ref = JS.pair_step(params, jcfg, *(jnp.asarray(a) for a in (fuse, f1, f2, pos)),
                           HW[kind], JC.FP32, compute_res2=compute_res2)
        out = TS.pair_step(model, tcfg, *(torch.from_numpy(a) for a in (fuse, f1, f2, pos)),
                           HW[kind], TC.FP32, compute_res2=compute_res2)
        for k in ("pts3d", "conf"):
            _close(out.res1[k], ref.res1[k])
        for a, b in ((out.feat_k1, ref.feat_k1), (out.feat_k2, ref.feat_k2),
                     (out.cur_v, ref.cur_v)):
            _close(a, b)
        if compute_res2:
            for k in ("pts3d", "conf"):
                _close(out.res2[k], ref.res2[k])
        else:
            assert len(out.dec2_hooks) == len(ref.dec2_hooks)
            for a, b in zip(out.dec2_hooks, ref.dec2_hooks):
                _close(a, b)


# ---------------------------------------------------------------------------
# the streaming video path
# ---------------------------------------------------------------------------

def _frames(kind, t=8, seed=44):
    h, w = HW[kind]
    return np.random.default_rng(seed).integers(0, 256, (t, 1, h, w, 3)).astype(np.uint8)


def _compare_preds(preds, ref, tol):
    assert len(preds) == len(ref)
    for a, b in zip(preds, ref):
        assert list(a) == list(b)
        for k in b:
            assert a[k].shape == np.asarray(b[k]).shape
            assert a[k].dtype == np.float32
            np.testing.assert_allclose(a[k], np.asarray(b[k], np.float32),
                                       rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("kind", ["dpt", "linear"])
def test_run_video_fp32(kind, monkeypatch):
    """T=8, chunk 3: chunk boundaries, a short tail chunk (padded on the
    JAX side) and (dpt config) memory prunes."""
    jcfg, tcfg, params, _, model = _models(kind)
    prunes = []
    orig_prune = TM.memory_prune
    monkeypatch.setattr(TM, "memory_prune",
                        lambda s, c: prunes.append(1) or orig_prune(s, c))
    frames = _frames(kind)
    ref = JS.InferenceEngine(params, jcfg, HW[kind], JC.FP32).run_video(frames, chunk=3)
    engine = TS.InferenceEngine(model, tcfg, HW[kind], TC.FP32)
    preds = engine.run_video(frames, chunk=3)
    _compare_preds(preds, ref, VIDEO_TOL)
    assert engine.stats["memory_reads"] == len(frames) - 2
    if kind == "dpt":
        assert len(prunes) >= 1
        p_tokens = (HW[kind][0] // 16) * (HW[kind][1] // 16)
        mem = engine.carry.mem
        assert int(mem.size[0]) <= tcfg.memory.long_mem_size + 2 * p_tokens


def test_reconstruct_video_fp32():
    jcfg, tcfg, params, _, model = _models("dpt")
    frames = _frames("dpt", seed=45)
    ref = JS.InferenceEngine(params, jcfg, HW["dpt"], JC.FP32).run_video(frames, chunk=3)
    preds, order, fps = TAPI.reconstruct_video(model, tcfg, frames, TC.FP32, chunk=3)
    _compare_preds(preds, ref, VIDEO_TOL)
    assert order == list(range(len(frames))) and fps > 0


def test_run_video_bf16():
    jcfg, tcfg, params, _, model = _models("dpt")
    frames = _frames("dpt", seed=46)
    ref = JS.InferenceEngine(params, jcfg, HW["dpt"], JC.BF16).run_video(frames, chunk=3)
    preds = TS.InferenceEngine(model, tcfg, HW["dpt"], TC.BF16).run_video(frames, chunk=3)
    _compare_preds(preds, ref, BF16_TOL)
