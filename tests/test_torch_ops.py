"""spann3r_torch ops against their JAX counterparts on the CPU.

Inputs come from numpy seeds; weights are made by the JAX initialisers and
carried over with the port's converter rules. Where the JAX side is a
Pallas kernel it runs in interpret mode. FP32 throughout unless stated.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spann3r_tpu.ops import attention as JA
from spann3r_tpu.ops import layers as JL
from spann3r_tpu.ops import pallas_attention as JPA
from spann3r_tpu.ops import pallas_rope as JPR
from spann3r_tpu.ops.rope import _apply as jax_rope_apply
from spann3r_tpu.ops.rope import rope_2d_ref
from spann3r_torch.ops import attention as TA
from spann3r_torch.ops import layers as TL
from spann3r_torch.ops import rope as TR
from spann3r_torch.utils import convert

TOL = 1e-5


@pytest.fixture
def interpret_mode(monkeypatch):
    """Run the Pallas kernels through the interpreter (CPU)."""
    orig = JPR.pl.pallas_call
    monkeypatch.setattr(JPR.pl, "pallas_call",
                        functools.partial(orig, interpret=True))


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _linear_module(p):
    w = np.asarray(p["w"])
    m = torch.nn.Linear(w.shape[0], w.shape[1], bias=p.get("b") is not None)
    sd = {}
    convert._lin(sd, "m", p)
    m.load_state_dict({k[2:]: v for k, v in sd.items()})
    return m


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,d_out", [((2, 7, 32), 48), ((5, 16), 8)])
def test_linear(shape, d_out):
    rng = np.random.default_rng(1)
    p = JL.init_linear(jax.random.PRNGKey(1), shape[-1], d_out)
    p["b"] = jnp.asarray(rng.standard_normal(d_out).astype(np.float32))
    x = rng.standard_normal(shape).astype(np.float32)
    _close(TL.linear(_linear_module(p), torch.from_numpy(x)),
           JL.linear(p, jnp.asarray(x)))


def test_layer_norm_fp32_and_bf16():
    rng = np.random.default_rng(2)
    d = 24
    p = {"scale": jnp.asarray(rng.standard_normal(d).astype(np.float32)),
         "bias": jnp.asarray(rng.standard_normal(d).astype(np.float32))}
    m = torch.nn.LayerNorm(d)
    sd = {}
    convert._ln(sd, "m", p)
    m.load_state_dict({k[2:]: v for k, v in sd.items()})
    x = (rng.standard_normal((3, 5, d)) * 3 + 1).astype(np.float32)
    _close(TL.layer_norm(m, torch.from_numpy(x)), JL.layer_norm(p, jnp.asarray(x)))
    # bf16 in, normalised in fp32, bf16 out
    y = TL.layer_norm(m, torch.from_numpy(x).bfloat16())
    assert y.dtype == torch.bfloat16
    ref = JL.layer_norm(p, jnp.asarray(x).astype(jnp.bfloat16))
    _close(y.float(), ref.astype(jnp.float32), tol=2e-2)


def test_gelu_and_mlp():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 16)).astype(np.float32) * 2
    _close(TL.gelu(torch.from_numpy(x)), JL.gelu(jnp.asarray(x)))
    p = JL.init_mlp(jax.random.PRNGKey(3), 16, 64)
    m = TL.Mlp(16, 64)
    sd = {}
    convert._lin(sd, "fc1", p["fc1"])
    convert._lin(sd, "fc2", p["fc2"])
    m.load_state_dict(sd)
    _close(TL.mlp(m, torch.from_numpy(x)), JL.mlp(p, jnp.asarray(x)))


def _conv_module(p, transpose=False, **kw):
    w = np.asarray(p["w"])
    kh, kw_, cin, cout = w.shape
    cls = torch.nn.ConvTranspose2d if transpose else torch.nn.Conv2d
    m = cls(cin, cout, (kh, kw_), bias=p.get("b") is not None, **kw)
    sd = {}
    (convert._deconv if transpose else convert._conv)(sd, "m", p)
    m.load_state_dict({k[2:]: v for k, v in sd.items()})
    return m


@pytest.mark.parametrize("k,stride,jpad,tpad,bias", [
    (1, 1, "VALID", 0, True),                  # act_postprocess 1x1
    (3, 1, [(1, 1), (1, 1)], 1, True),         # residual conv units
    (3, 1, [(1, 1), (1, 1)], 1, False),        # layer_rn (no bias)
    (3, 2, [(1, 1), (1, 1)], 1, True),         # act3 stride-2 conv
    (16, 16, "VALID", 0, True),                # patch embed
])
def test_conv2d(k, stride, jpad, tpad, bias):
    rng = np.random.default_rng(4)
    p = JL.init_conv2d(jax.random.PRNGKey(4), k, k, 6, 10, bias=bias)
    if bias:
        p["b"] = jnp.asarray(rng.standard_normal(10).astype(np.float32))
    x = rng.standard_normal((2, 32, 48, 6)).astype(np.float32)
    ref = JL.conv2d(p, jnp.asarray(x), stride=stride, padding=jpad)
    out = TL.conv2d(_conv_module(p), torch.from_numpy(x).permute(0, 3, 1, 2),
                    stride=stride, padding=tpad)
    _close(out.permute(0, 2, 3, 1), ref)


@pytest.mark.parametrize("stride", [2, 4])
def test_conv2d_transpose(stride):
    rng = np.random.default_rng(5)
    p = JL.init_conv2d(jax.random.PRNGKey(5), stride, stride, 6, 6)
    p["b"] = jnp.asarray(rng.standard_normal(6).astype(np.float32))
    x = rng.standard_normal((2, 5, 7, 6)).astype(np.float32)
    ref = JL.conv2d_transpose(p, jnp.asarray(x), stride)
    out = TL.conv2d_transpose(_conv_module(p, transpose=True, stride=stride),
                              torch.from_numpy(x).permute(0, 3, 1, 2), stride)
    _close(out.permute(0, 2, 3, 1), ref)


@pytest.mark.parametrize("hw,out_hw", [((3, 4), (6, 8)), ((7, 5), (14, 10)),
                                       ((1, 6), (2, 12))])
def test_interpolate_bilinear(hw, out_hw):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    ref = JL.interpolate_bilinear(jnp.asarray(x), out_hw, align_corners=True)
    out = TL.interpolate_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), out_hw)
    _close(out.permute(0, 2, 3, 1), ref)


def test_init_rules():
    """Xavier-uniform bounds with the JAX package's fans; zero biases."""
    g = torch.Generator().manual_seed(0)
    lin = torch.nn.Linear(40, 24)
    TL.init_linear_(lin, g)
    lim = np.sqrt(6.0 / (40 + 24))
    w = lin.weight.detach().abs()
    assert float(w.max()) <= lim and float(w.max()) > 0.9 * lim
    assert float(lin.bias.detach().abs().max()) == 0.0
    conv = torch.nn.Conv2d(3, 32, 4)
    TL.init_conv_(conv, g, xavier_flat=True)
    lim = np.sqrt(6.0 / (4 * 4 * 3 + 32))
    assert float(conv.weight.detach().abs().max()) <= lim
    tconv = torch.nn.ConvTranspose2d(8, 8, 2, stride=2)
    TL.init_conv_(tconv, g)
    lim = np.sqrt(6.0 / (2 * 2 * 8 * 2))
    assert float(tconv.weight.detach().abs().max()) <= lim


# ---------------------------------------------------------------------------
# RoPE2D (kernel K3's plain version)
# ---------------------------------------------------------------------------

def _rope_inputs(seed, b=2, h=3, n=24, d=64, max_pos=32):
    rng = np.random.default_rng(seed)
    tok = rng.standard_normal((b, h, n, d)).astype(np.float32)
    pos = rng.integers(0, max_pos, (b, n, 2)).astype(np.int32)
    return tok, pos


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_rope_plain_vs_jax_ref(sign):
    tok, pos = _rope_inputs(7)
    ref = jax_rope_apply(jnp.asarray(tok), jnp.asarray(pos), 100.0, sign)
    out = TR.rope_2d_plain(torch.from_numpy(tok), torch.from_numpy(pos), 100.0, sign)
    _close(out, ref, tol=1e-6)
    if sign > 0:
        _close(out, rope_2d_ref(jnp.asarray(tok), jnp.asarray(pos), 100.0), tol=1e-6)


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_rope_plain_vs_pallas_interpret(interpret_mode, sign):
    # positions below 14, as the JAX kernel's own test: at larger angles the
    # interpreter's sin/cos already differ from the JAX reference by ~2e-6
    tok, pos = _rope_inputs(8, max_pos=14)
    ref = JPR._rope_pallas_raw(jnp.asarray(tok), jnp.asarray(pos), 100.0, sign)
    out = TR.rope_2d(torch.from_numpy(tok), torch.from_numpy(pos), 100.0, sign)
    _close(out, ref, tol=1e-6)


def test_rope_bf16_vs_pallas_interpret(interpret_mode):
    # both compute in fp32 and round once to bf16: at most one bf16 ulp apart
    tok, pos = _rope_inputs(9)
    tj = jnp.asarray(tok).astype(jnp.bfloat16)
    ref = JPR.rope_2d_pallas(tj, jnp.asarray(pos), 100.0)
    tt = torch.from_numpy(np.array(tj.astype(jnp.float32))).bfloat16()
    out = TR.rope_2d(tt, torch.from_numpy(pos), 100.0)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out.float()), _np(ref.astype(jnp.float32)),
                               rtol=8e-3, atol=8e-3)


def test_rope_strided_view_matches_contiguous():
    """The q/k slices of a packed qkv projection are strided views."""
    rng = np.random.default_rng(10)
    qkv = torch.from_numpy(rng.standard_normal((2, 12, 3, 4, 16)).astype(np.float32))
    q = qkv.permute(2, 0, 3, 1, 4)[0]
    assert not q.is_contiguous()
    pos = torch.from_numpy(rng.integers(0, 8, (2, 12, 2)).astype(np.int32))
    torch.testing.assert_close(TR.rope_2d(q, pos), TR.rope_2d(q.contiguous(), pos),
                               rtol=0, atol=0)


def _rope_qk_inputs(seed, d=64):
    """q (2, 3, 20, d) and k (2, 3, 29, d) with their own positions; the
    positions of q are one grid expanded over the batch with stride 0, as
    the model passes them."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, 3, 20, d)).astype(np.float32)
    k = rng.standard_normal((2, 3, 29, d)).astype(np.float32)
    qgrid = rng.integers(0, 14, (20, 2)).astype(np.int32)
    kpos = rng.integers(0, 14, (2, 29, 2)).astype(np.int32)
    return q, k, qgrid, kpos


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("d", [64, 32])
def test_rope_qk_vs_jax(interpret_mode, sign, d):
    """The two-operand entry point against the Pallas kernel (interpret
    mode) and the JAX package's reference, each operand on its own."""
    q, k, qgrid, kpos = _rope_qk_inputs(15, d)
    qpos_t = torch.from_numpy(qgrid)[None].expand(2, -1, -1)
    assert qpos_t.stride(0) == 0
    qpos = np.broadcast_to(qgrid, (2, 20, 2))
    qr, kr = TR.rope_2d_qk(torch.from_numpy(q), torch.from_numpy(k), qpos_t,
                           torch.from_numpy(kpos), 100.0, sign)
    for out, x, p in ((qr, q, qpos), (kr, k, kpos)):
        xj, pj = jnp.asarray(x), jnp.asarray(p)
        _close(out, JPR._rope_pallas_raw(xj, pj, 100.0, sign), tol=1e-6)
        _close(out, jax_rope_apply(xj, pj, 100.0, sign), tol=1e-6)


def test_rope_qk_bf16_vs_jax(interpret_mode):
    """bf16 q and k against the Pallas kernel and against `_apply` in fp32
    on the same bf16 inputs, rounded once, as the kernel computes (`_apply`
    on bf16 inputs rounds its cos/sin tables to bf16, which the port does
    not): at most one bf16 ulp apart."""
    q, k, qgrid, kpos = _rope_qk_inputs(16)
    qpos = np.broadcast_to(qgrid, (2, 20, 2))
    to_t = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
    qj, kj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k))
    qr, kr = TR.rope_2d_qk(to_t(qj), to_t(kj),
                           torch.from_numpy(qgrid)[None].expand(2, -1, -1),
                           torch.from_numpy(kpos), 100.0)
    for out, xj, p in ((qr, qj, qpos), (kr, kj, kpos)):
        assert out.dtype == torch.bfloat16
        for ref in (JPR._rope_pallas_raw(xj, jnp.asarray(p), 100.0, 1.0),
                    jax_rope_apply(xj.astype(jnp.float32), jnp.asarray(p),
                                   100.0, 1.0).astype(jnp.bfloat16)):
            np.testing.assert_allclose(_np(out.float()),
                                       _np(ref.astype(jnp.float32)),
                                       rtol=8e-3, atol=8e-3)


@pytest.mark.parametrize("d,dtype,offset,want", [
    (64, torch.bfloat16, 0, 8), (64, torch.float32, 0, 4),
    (48, torch.bfloat16, 0, 4), (32, torch.bfloat16, 0, 8),
    (64, torch.bfloat16, 4, 4), (64, torch.bfloat16, 1, 1),
    (4, torch.float32, 0, 1)])
def test_rope_kernel_vector_width(d, dtype, offset, want):
    """16-byte accesses where D/4, the pointers and the strides allow them,
    narrower ones elsewhere: a q slice of a qkv projection viewed `offset`
    elements into its buffer."""
    buf = torch.zeros(2 * 5 * 3 * 4 * d + offset, dtype=dtype)
    qkv = buf[offset:].view(2, 5, 3, 4, d).permute(2, 0, 3, 1, 4)
    assert TR.vector_width([qkv[0], qkv[1], torch.empty(2, 4, 5, d, dtype=dtype)]) == want


@pytest.mark.parametrize("n,blocks,want", [
    (768, 16, 16),    # encoder q+k: 16 frames
    (768, 1, 4),      # decoder q+k, shared positions: 192 blocks
    (768, 2, 8),      # q and k with positions of their own
    (196, 1, 1), (5, 64, 2), (5, 8, 1)])
def test_rope_kernel_token_tile(n, blocks, want):
    """The largest tile whose grid still gives each of the 132 SMs a block."""
    assert TR.token_tile(n, blocks, 132) == want


@pytest.mark.parametrize("bad", ["heads", "dtype", "pos", "float pos", "three"])
def test_rope_kernel_rejects_mismatched_operands(bad):
    """The launcher checks its operands before it reaches the kernel."""
    q = torch.zeros(2, 3, 5, 64)
    k = torch.zeros(2, 4 if bad == "heads" else 3, 7, 64,
                    dtype=torch.bfloat16 if bad == "dtype" else torch.float32)
    qpos = torch.zeros(2, 5, 2, dtype=torch.int32)
    kpos = torch.zeros(2, 5 if bad == "pos" else 7, 2,
                       dtype=torch.float32 if bad == "float pos" else torch.int32)
    ops = [(q, qpos), (k, kpos)] + ([(q, qpos)] if bad == "three" else [])
    with pytest.raises(ValueError):
        TR._launch(ops, 100.0, 1.0)


# ---------------------------------------------------------------------------
# SDPA (kernel K2's plain version) and the attention blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,n,m,d", [
    (1, 4, 20, 20, 64),    # ragged self-attention
    (2, 3, 20, 33, 64),    # cross-attention, N != M
    (1, 2, 16, 16, 32),
])
def test_sdpa_plain_vs_jax(interpret_mode, b, h, n, m, d):
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, h, n, d), (b, h, m, d), (b, h, m, d)))
    scale = d ** -0.5
    out = TA.sdpa(*(torch.from_numpy(a) for a in (q, k, v)), scale)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    _close(out, JPA._sdpa_jnp(jq, jk, jv, scale))
    _close(out, JPA.fused_sdpa(jq, jk, jv, scale))


@pytest.mark.parametrize("b,h,n,m", [(2, 16, 20, 20), (1, 16, 196, 196),
                                     (2, 4, 20, 37)])
def test_sdpa_plain_head_dim_32_vs_jax(interpret_mode, b, h, n, m):
    """Head dim 32, the CroCo decoder's (the encoder's 20 visible tokens,
    the decoder's 196, N != M): the plain version against the JAX kernel
    in interpret mode, fp32."""
    rng = np.random.default_rng(13)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, h, n, 32), (b, h, m, 32), (b, h, m, 32)))
    scale = 32 ** -0.5
    out = TA.sdpa(*(torch.from_numpy(a) for a in (q, k, v)), scale)
    assert out.shape == (b, h, n, 32)
    _close(out, JPA.fused_sdpa(*(jnp.asarray(a) for a in (q, k, v)), scale))


def test_sdpa_kernel_wrappers_refuse_other_head_dims():
    """The kernels take head dim 32 or 64: any other raises before a
    launch, naming the two."""
    for d in (16, 48, 128):
        x = torch.zeros(1, 2, 8, d)
        with pytest.raises(ValueError, match="head dim 32 or 64"):
            TA.sdpa_cuda(x, x, x, 0.1)
        with pytest.raises(ValueError, match="head dim 32 or 64"):
            TA.sdpa_backward_cuda(x, x, x, x, torch.zeros(1, 2, 8), 0.1)


def test_sdpa_bf16_vs_jax():
    rng = np.random.default_rng(12)
    q, k, v = (jnp.asarray(rng.standard_normal((1, 2, 24, 64))).astype(jnp.bfloat16)
               for _ in range(3))
    ref = JPA._sdpa_jnp(q, k, v, 0.125)
    to_t = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
    out = TA.sdpa(to_t(q), to_t(k), to_t(v), 0.125)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out.float()), _np(ref.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("rope", [True, False])
def test_self_attention(rope):
    rng = np.random.default_rng(13)
    dim, heads, n = 64, 4, 12
    p = JA.init_self_attention(jax.random.PRNGKey(13), dim)
    m = TA.SelfAttention(dim)
    sd = {}
    convert._lin(sd, "qkv", p["qkv"])
    convert._lin(sd, "proj", p["proj"])
    m.load_state_dict(sd)
    x = rng.standard_normal((2, n, dim)).astype(np.float32)
    pos = rng.integers(0, 6, (2, n, 2)).astype(np.int32)
    jpos, tpos = (jnp.asarray(pos), torch.from_numpy(pos)) if rope else (None, None)
    ref = JA.self_attention(p, jnp.asarray(x), jpos, heads)
    out = TA.self_attention(m, torch.from_numpy(x), tpos, heads)
    _close(out, ref)


def test_cross_attention():
    rng = np.random.default_rng(14)
    dim, heads, n, mm = 48, 4, 10, 14
    p = JA.init_cross_attention(jax.random.PRNGKey(14), dim)
    m = TA.CrossAttention(dim)
    sd = {}
    for k in ("projq", "projk", "projv", "proj"):
        convert._lin(sd, k, p[k])
    m.load_state_dict(sd)
    xq = rng.standard_normal((2, n, dim)).astype(np.float32)
    xk = rng.standard_normal((2, mm, dim)).astype(np.float32)
    qpos = rng.integers(0, 6, (2, n, 2)).astype(np.int32)
    kpos = rng.integers(0, 6, (2, mm, 2)).astype(np.int32)
    ref = JA.cross_attention(p, jnp.asarray(xq), jnp.asarray(xk), jnp.asarray(xk),
                             jnp.asarray(qpos), jnp.asarray(kpos), heads)
    out = TA.cross_attention(m, torch.from_numpy(xq), torch.from_numpy(xk),
                             torch.from_numpy(xk), torch.from_numpy(qpos),
                             torch.from_numpy(kpos), heads)
    _close(out, ref)
