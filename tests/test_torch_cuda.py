"""spann3r_torch CUDA kernels against their plain versions, on the card.

Each test takes the `dev` fixture, which skips it where no CUDA device is
present; on the card they run with

    python -m pytest tests/test_torch_cuda.py -q

Shapes are small (ragged edges included); chip_smoke.py checks the
main path's shapes.
"""
import pytest
import torch

from spann3r_torch.ops import _kernels
from spann3r_torch.ops import attention, memory_read, rope

DTYPES = {"fp32": (torch.float32, 1e-5), "bf16": (torch.bfloat16, 2e-2)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, dtype, dev, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(device=dev, dtype=dtype)


def _assert_close(got, want, tol):
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_rope_kernel(dev, dt, sign):
    dtype, tol = DTYPES[dt]
    qkv = _randn((2, 40, 3, 3, 64), dtype, dev, 0).permute(2, 0, 3, 1, 4)
    pos = torch.randint(0, 32, (2, 40, 2), device=dev)
    before = _kernels.LAUNCHES["rope2d"]
    out = rope.rope_2d(qkv[1], pos, 100.0, sign)
    assert _kernels.LAUNCHES["rope2d"] == before + 1
    _assert_close(out, rope.rope_2d_plain(qkv[1], pos, 100.0, sign), tol)


def _rope_qk_operands(layout, d, dtype, dev):
    """q, k, qpos, kpos: 'packed' slices one qkv projection and shares int32
    positions expanded over the batch with stride 0; 'cross' splits q and k
    (N != M) from separate projections, each with its own positions (int64
    for k); 'misaligned' views q one element into its buffer, so only
    scalar accesses stay aligned."""
    g = torch.Generator(device=dev).manual_seed(20)
    if layout == "packed":
        qkv = _randn((2, 37, 3, 3, d), dtype, dev, 21).permute(2, 0, 3, 1, 4)
        pos = torch.randint(0, 32, (37, 2), generator=g, device=dev,
                            dtype=torch.int32)[None].expand(2, -1, -1)
        return qkv[0], qkv[1], pos, pos
    q = _randn((2, 19, 3 * d), dtype, dev, 22).view(2, 19, 3, d).transpose(1, 2)
    k = _randn((2, 45, 3 * d), dtype, dev, 23).view(2, 45, 3, d).transpose(1, 2)
    qpos = torch.randint(0, 32, (2, 19, 2), generator=g, device=dev,
                         dtype=torch.int32)
    kpos = torch.randint(0, 32, (2, 45, 2), generator=g, device=dev)
    if layout == "misaligned":
        q = _randn((2, 3, 19, d + 1), dtype, dev, 24)[..., 1:]
    return q, k, qpos, kpos


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("d", [64, 32, 48])
@pytest.mark.parametrize("layout", ["packed", "cross", "misaligned"])
def test_rope_qk_kernel(dev, dt, sign, d, layout):
    """q and k of one attention in one launch, each against the plain
    version: at most one bf16 rounding apart (8e-3), 1e-5 in fp32."""
    dtype, _ = DTYPES[dt]
    tol = 8e-3 if dtype == torch.bfloat16 else 1e-5
    q, k, qpos, kpos = _rope_qk_operands(layout, d, dtype, dev)
    widest = 16 // q.element_size()
    if layout == "misaligned":
        assert rope.vector_width([q, k]) == 1
    elif d == 48:   # Q = 12: 4 elements per access in either dtype
        assert rope.vector_width([q, k]) == 4
    else:
        assert rope.vector_width([q, k]) == widest
    before = _kernels.LAUNCHES["rope2d"]
    qr, kr = rope.rope_2d_qk(q, k, qpos, kpos, 100.0, sign)
    assert _kernels.LAUNCHES["rope2d"] == before + 1
    _assert_close(qr, rope.rope_2d_plain(q, qpos, 100.0, sign), tol)
    _assert_close(kr, rope.rope_2d_plain(k, kpos, 100.0, sign), tol)
    assert qr.is_contiguous() and kr.is_contiguous()
    # each operand alone takes one launch and gives the same bits
    assert torch.equal(rope.rope_2d(q, qpos, 100.0, sign), qr)
    assert torch.equal(rope.rope_2d(k, kpos, 100.0, sign), kr)
    assert _kernels.LAUNCHES["rope2d"] == before + 3


def test_rope_qk_kernel_token_tiles(dev):
    """Every token tile size gives the same bits, and a tile that is not
    a divisor of N leaves a ragged last block."""
    q, k, qpos, kpos = _rope_qk_operands("cross", 64, torch.bfloat16, dev)
    want = rope._launch([(q, qpos), (k, kpos)], 100.0, 1.0, tile=1)
    for tile in (2, 7, 8, 64):
        got = rope._launch([(q, qpos), (k, kpos)], 100.0, 1.0, tile=tile)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("b,h,n,m", [(2, 3, 20, 20), (1, 4, 70, 33),
                                     (1, 2, 196, 196),
                                     (32, 32, 65, 40),    # 4-row layout
                                     (1, 12, 768, 768),   # decoder
                                     (1, 16, 768, 768)])  # value encoder
def test_sdpa_kernel(dev, dt, b, h, n, m):
    dtype, tol = DTYPES[dt]
    q = _randn((b, h, n, 64), dtype, dev, 1)
    k = _randn((b, h, m, 64), dtype, dev, 2)
    v = _randn((b, h, m, 64), dtype, dev, 3)
    out = attention.sdpa(q, k, v, 0.125)
    _assert_close(out, attention.sdpa_plain(q, k, v, 0.125),
                  max(tol, 1e-4) if dt == "fp32" else tol)


@pytest.mark.parametrize("b,h,n,m", [(1, 3, 100, 300), (2, 2, 64, 130),
                                     (1, 12, 768, 768)])
def test_sdpa_kernel_strided(dev, b, h, n, m):
    """q/k/v as strided slices of a packed qkv projection (row stride
    3 * H * Dh), ragged key tiles included."""
    qkv = _randn((b, max(n, m), 3, h, 64), torch.bfloat16, dev, 10)
    qkv = qkv.permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0, :, :, :n], qkv[1, :, :, :m], qkv[2, :, :, :m]
    out = attention.sdpa_cuda(q, k, v, 0.125)
    _assert_close(out, attention.sdpa_plain(q, k, v, 0.125), 2e-2)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("size", [0, 40, 256])
@pytest.mark.parametrize("attn_thresh", [0.0, 5e-4])
@pytest.mark.parametrize("p,c,d", [(16, 256, 64),
                                   (70, 256, 20)])   # ragged, unaligned rows
def test_memory_read_kernel(dev, dt, size, attn_thresh, p, c, d):
    dtype, tol = DTYPES[dt]
    q = _randn((1, p, d), dtype, dev, 4)
    k = _randn((1, c, d), dtype, dev, 5)
    v = _randn((1, c, d), dtype, dev, 6)
    sz = torch.tensor([size], dtype=torch.int32, device=dev)
    out, asum = memory_read.memory_read_attention(q, k, v, sz, attn_thresh)
    ref_out, ref_asum = memory_read.memory_read_attention_plain(q, k, v, sz,
                                                                attn_thresh)
    tol = max(tol, 1e-4) if dt == "fp32" else tol
    _assert_close(out, ref_out, tol)
    _assert_close(asum, ref_asum, max(tol, 1e-4))


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("attn_thresh", [0.0, 5e-4])
def test_memory_read_kernel_streams(dev, dt, attn_thresh):
    """B=2 streams, each with its own bank and size, one of them full."""
    dtype, tol = DTYPES[dt]
    q = _randn((2, 70, 128), dtype, dev, 7)
    k = _randn((2, 320, 128), dtype, dev, 11)
    v = _randn((2, 320, 128), dtype, dev, 12)
    sz = torch.tensor([75, 320], dtype=torch.int32, device=dev)
    before = _kernels.LAUNCHES["memory_read"]
    out, asum = memory_read.memory_read_attention(q, k, v, sz, attn_thresh)
    assert _kernels.LAUNCHES["memory_read"] == before + 1
    ref_out, ref_asum = memory_read.memory_read_attention_plain(q, k, v, sz,
                                                                attn_thresh)
    tol = max(tol, 1e-4)
    _assert_close(out, ref_out, tol)
    _assert_close(asum, ref_asum, tol)
    assert torch.count_nonzero(asum[0, 75:]) == 0


def test_memory_read_column_sums_are_deterministic(dev):
    q = _randn((1, 96, 128), torch.bfloat16, dev, 8)
    k = _randn((1, 1024, 128), torch.bfloat16, dev, 9)
    sz = torch.tensor([900], dtype=torch.int32, device=dev)
    runs = [memory_read.memory_read_attention(q, k, k, sz, 5e-4)[1]
            for _ in range(3)]
    for r in runs[1:]:
        assert torch.equal(r, runs[0])


# ---------------------------------------------------------------------------
# offline mode's decoder shapes and the int8 serving path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("attn", ["self", "cross"])
def test_offline_decoder_batch(dev, dt, attn):
    """K3 then K2 as the offline decoder runs them: batch 8, 12 heads,
    q and k from one qkv projection (self) or from two projections
    (cross), positions expanded over the batch with stride 0 and shared by
    q and k (one K3 launch for both)."""
    from spann3r_torch.models.vit import patch_positions
    dtype, tol = DTYPES[dt]
    b, h, n = 8, 12, 96
    pos = patch_positions(8, 12, dev)[None].expand(b, -1, -1)
    if attn == "self":
        qkv = _randn((b, n, 3, h, 64), dtype, dev, 30).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
    else:
        q, k, v = (_randn((b, n, h * 64), dtype, dev, s).view(b, n, h, 64)
                   .transpose(1, 2) for s in (31, 32, 33))
    before = dict(_kernels.LAUNCHES)
    qr, kr = rope.rope_2d_qk(q, k, pos, pos, 100.0)
    out = attention.sdpa(qr, kr, v, 0.125)
    assert _kernels.LAUNCHES["rope2d"] == before["rope2d"] + 1
    assert _kernels.LAUNCHES["sdpa"] == before["sdpa"] + 1
    rope_tol = 8e-3 if dtype == torch.bfloat16 else 1e-5
    qp = rope.rope_2d_plain(q, pos, 100.0)
    kp = rope.rope_2d_plain(k, pos, 100.0)
    _assert_close(qr, qp, rope_tol)
    _assert_close(kr, kp, rope_tol)
    _assert_close(out, attention.sdpa_plain(qr, kr, v, 0.125),
                  max(tol, 1e-4) if dt == "fp32" else tol)
    # each batch item alone gives the same bits as in the batch
    q1, k1 = rope.rope_2d_qk(q[3:4], k[3:4], pos[3:4], pos[3:4], 100.0)
    assert torch.equal(q1, qr[3:4]) and torch.equal(k1, kr[3:4])
    assert torch.equal(attention.sdpa(q1, k1, v[3:4], 0.125), out[3:4])


@pytest.mark.parametrize("dt", list(DTYPES))
def test_int8_linear_on_the_card(dev, dt):
    """The int8 linear on the card against the same module on the CPU:
    int8 activations (torch._int_mm, exact int32 sums, then the same fp32
    scaling) to one rounding of the output dtype, weight-only to the GEMM
    tolerance; shapes the int8 product does not take raise."""
    from spann3r_torch.ops import layers, quant
    dtype, tol = DTYPES[dt]
    w = _randn((1024, 768), torch.float32, "cpu", 40) * 0.02
    b = _randn((1024,), torch.float32, "cpu", 41) * 0.01
    x = _randn((2, 768, 768), dtype, "cpu", 42)
    for rows, want_tol in ((quant.INT8_ACT_ROWS, 1e-6 if dt == "fp32" else 8e-3),
                           (0, max(tol, 1e-4))):
        q, s = quant.quantize_weight(w)
        m = layers.QuantLinear(q, s, torch.nn.Parameter(b.clone()), rows)
        with torch.no_grad():
            want = layers.linear(m, x)
            got = layers.linear(m.to(dev), x.to(dev))
        assert got.dtype == dtype
        _assert_close(got.cpu(), want, want_tol)
    with torch.no_grad():
        m = layers.QuantLinear(*quant.quantize_weight(w), None, 1).to(dev)
        with pytest.raises(ValueError, match="multiples of 8"):
            layers.linear(m, x[0, :16].to(dev))          # 16 rows
        m = layers.QuantLinear(*quant.quantize_weight(w[:, :764]), None,
                               1).to(dev)
        with pytest.raises(ValueError, match="multiples of 8"):
            layers.linear(m, x[0, :, :764].to(dev))      # K = 764


# ---------------------------------------------------------------------------
# the backward kernels (training)
# ---------------------------------------------------------------------------

def _assert_scaled(got, want, tol):
    """|got - want| <= tol * (rms(want) + |want|) everywhere: sums taken in
    another order differ by a share of the summands' size, not of each
    result's."""
    got, want = got.float(), want.float()
    bound = tol * (want.pow(2).mean().sqrt() + want.abs())
    err = (got - want).abs()
    assert bool((err <= bound).all()), float((err / bound).max())


def _sdpa_operands(layout, dtype, dev, n, m, b=2, h=3):
    """q (B, H, N, 64), k and v (B, H, M, 64): 'self' slices one qkv
    projection (N = M), 'cross' separate (B, *, H*64) projections."""
    if layout == "self":
        qkv = _randn((b, n, 3, h, 64), dtype, dev, 50).permute(2, 0, 3, 1, 4)
        return qkv[0], qkv[1], qkv[2]
    q = _randn((b, n, h * 64), dtype, dev, 51).view(b, n, h, 64).transpose(1, 2)
    k, v = (_randn((b, m, h * 64), dtype, dev, s).view(b, m, h, 64)
            .transpose(1, 2) for s in (52, 53))
    return q, k, v


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("layout,n,m", [("self", 37, 37), ("self", 196, 196),
                                        ("cross", 37, 101), ("cross", 130, 5)])
def test_sdpa_backward_kernel(dev, dt, layout, n, m):
    """The backward kernel against sdpa_backward_plain on the same inputs:
    ragged query and key tiles, q/k/v strided views, dO a strided view
    (the merged heads' gradient) and one with row stride 128; the
    forward's logsumexp against torch.logsumexp, and the forward output's
    bits unchanged when the logsumexp is asked for."""
    dtype, tol = DTYPES[dt]
    q, k, v = _sdpa_operands(layout, dtype, dev, n, m)
    out, lse = attention.sdpa_cuda(q, k, v, 0.125, with_lse=True)
    assert torch.equal(out, attention.sdpa_cuda(q, k, v, 0.125))
    want_lse = torch.logsumexp(torch.matmul(q.float(), k.float().transpose(
        -1, -2)) * 0.125, dim=-1)
    _assert_scaled(lse, want_lse, 1e-5)
    b, h = q.shape[:2]
    douts = (_randn((b, n, h, 64), dtype, dev, 54).transpose(1, 2),
             _randn((b, h, n, 128), dtype, dev, 55)[..., :64])
    for dout in douts:
        before = _kernels.LAUNCHES["sdpa_bwd"]
        got = attention.sdpa_backward_cuda(q, k, v, dout, lse, 0.125)
        assert _kernels.LAUNCHES["sdpa_bwd"] == before + 1
        want = attention.sdpa_backward_plain(q, k, v, dout, lse, 0.125)
        for g, w in zip(got, want):
            assert g.dtype == dtype and g.shape == w.shape
            _assert_scaled(g, w, 1e-4 if dt == "fp32" else tol)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("layout,b,h,n,m", [
    ("self", 10, 16, 196, 196), ("self", 2, 12, 196, 196),  # training
    ("cross", 2, 3, 68, 196), ("cross", 2, 3, 196, 68)])    # 4-row tails
def test_sdpa_backward_kernel_shapes(dev, dt, layout, b, h, n, m):
    """The backward kernel at the training encoder's and decoder's shapes,
    and with a ragged tail of 4 rows on the query side (68 = 64 + 4) and
    on the key side, N != M: against sdpa_backward_plain, and two launches
    give the same bits for dq, dk and dv (every output element has one
    owner, no atomics)."""
    dtype, tol = DTYPES[dt]
    q, k, v = _sdpa_operands(layout, dtype, dev, n, m, b=b, h=h)
    _, lse = attention.sdpa_cuda(q, k, v, 0.125, with_lse=True)
    dout = _randn((b, n, h, 64), dtype, dev, 57).transpose(1, 2)
    got = attention.sdpa_backward_cuda(q, k, v, dout, lse, 0.125)
    again = attention.sdpa_backward_cuda(q, k, v, dout, lse, 0.125)
    want = attention.sdpa_backward_plain(q, k, v, dout, lse, 0.125)
    for g, g2, w in zip(got, again, want):
        assert torch.equal(g, g2)
        _assert_scaled(g, w, 1e-4 if dt == "fp32" else tol)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_sdpa_autograd_on_the_card(dev, dt):
    """sdpa under autograd on the card (forward and backward kernels)
    against plain autograd of sdpa_plain on the CPU, in fp32 on the same
    values; inference (no grad) launches no backward and asks for no
    logsumexp."""
    dtype, tol = DTYPES[dt]
    q, k, v = _sdpa_operands("cross", dtype, dev, 70, 45)
    w = _randn(q.shape, torch.float32, dev, 56)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    before = dict(_kernels.LAUNCHES)
    out = attention.sdpa(*leaves, 0.125)
    grads = torch.autograd.grad((out.float() * w).sum(), leaves)
    assert _kernels.LAUNCHES["sdpa"] == before["sdpa"] + 1
    assert _kernels.LAUNCHES["sdpa_bwd"] == before["sdpa_bwd"] + 1
    cpu = [t.detach().cpu().float().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(
        (attention.sdpa_plain(*cpu, 0.125) * w.cpu()).sum(), cpu)
    for g, ww in zip(grads, want):
        _assert_scaled(g.cpu(), ww, 1e-4 if dt == "fp32" else 3 * tol)
    with torch.no_grad():
        attention.sdpa(*leaves, 0.125)
    assert _kernels.LAUNCHES["sdpa_bwd"] == before["sdpa_bwd"] + 1


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("grad_layout", ["heads", "strided", "broadcast"])
def test_rope_backward_kernel(dev, dt, grad_layout):
    """rope_2d_qk under autograd: one backward launch rotates both
    gradients by the inverse rotation, whatever layout they arrive in
    (a (B, N, H, D) view, a last dim of stride 2, stride 0 over the
    heads); the positions get none."""
    dtype, tol = DTYPES[dt]
    qkv = _randn((2, 37, 3, 3, 64), dtype, dev, 60).permute(2, 0, 3, 1, 4)
    q, k = (t.detach().clone().requires_grad_(True) for t in (qkv[0], qkv[1]))
    pos = torch.randint(0, 32, (37, 2), device=dev,
                        dtype=torch.int32)[None].expand(2, -1, -1)
    if grad_layout == "heads":
        gs = [_randn((2, 37, 3, 64), dtype, dev, s).transpose(1, 2)
              for s in (61, 62)]
    elif grad_layout == "strided":
        gs = [_randn((2, 3, 37, 128), dtype, dev, s)[..., ::2] for s in (61, 62)]
    else:
        gs = [_randn((2, 1, 37, 64), dtype, dev, s).expand(2, 3, 37, 64)
              for s in (61, 62)]
    before = dict(_kernels.LAUNCHES)
    qr, kr = rope.rope_2d_qk(q, k, pos, pos, 100.0)
    dq, dk = torch.autograd.grad((qr, kr), (q, k), grad_outputs=gs)
    assert _kernels.LAUNCHES["rope2d"] == before["rope2d"] + 1
    assert _kernels.LAUNCHES["rope2d_bwd"] == before["rope2d_bwd"] + 1
    rope_tol = 8e-3 if dtype == torch.bfloat16 else 1e-5
    for got, g in ((dq, gs[0]), (dk, gs[1])):
        _assert_close(got, rope.rope_2d_plain(g, pos, 100.0, -1.0), rope_tol)


# ---------------------------------------------------------------------------
# head dim 32 (the CroCoNet() decoder: 512 wide, 16 heads)
# ---------------------------------------------------------------------------

def _sdpa_operands_d(layout, dtype, dev, n, m, b, h, d, seed=70):
    """q (B, H, N, d), k and v (B, H, M, d): 'self' slices one packed qkv
    projection (row stride 3 * H * d: the columns past d of a head are the
    next head's), 'cross' separate (B, *, H * d) projections."""
    if layout == "self":
        qkv = _randn((b, n, 3, h, d), dtype, dev, seed).permute(2, 0, 3, 1, 4)
        return qkv[0], qkv[1], qkv[2]
    q = _randn((b, n, h * d), dtype, dev, seed + 1).view(b, n, h, d)
    k, v = (_randn((b, m, h * d), dtype, dev, s).view(b, m, h, d)
            for s in (seed + 2, seed + 3))
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("layout,b,h,n,m", [
    ("self", 2, 16, 20, 20),      # a ragged 20-token tile (extra coverage)
    ("self", 4, 16, 196, 196),    # the CroCoNet() decoder
    ("cross", 2, 16, 196, 196), ("cross", 2, 3, 20, 196),
    ("cross", 1, 4, 70, 33), ("self", 2, 3, 1, 1)])
def test_sdpa_kernel_head_dim_32(dev, dt, layout, b, h, n, m):
    """The forward kernel at head dim 32 against sdpa_plain: strided
    views whose next 32 columns hold another head (the loads are masked
    by column), ragged tiles, N != M."""
    dtype, tol = DTYPES[dt]
    q, k, v = _sdpa_operands_d(layout, dtype, dev, n, m, b, h, 32)
    scale = 32 ** -0.5
    before = _kernels.LAUNCHES["sdpa"]
    out = attention.sdpa(q, k, v, scale)
    assert _kernels.LAUNCHES["sdpa"] == before + 1
    assert out.shape == (b, h, n, 32)
    _assert_scaled(out, attention.sdpa_plain(q, k, v, scale),
                   1e-4 if dt == "fp32" else tol)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("layout,b,h,n,m", [
    ("self", 2, 16, 20, 20), ("self", 4, 16, 196, 196),
    ("cross", 2, 3, 68, 196), ("cross", 2, 3, 196, 68),
    ("cross", 1, 4, 37, 101)])
def test_sdpa_backward_kernel_head_dim_32(dev, dt, layout, b, h, n, m):
    """The backward kernel at head dim 32 against sdpa_backward_plain, dO
    a (B, N, H, 32) view, the forward's logsumexp; two launches give the
    same bits."""
    dtype, tol = DTYPES[dt]
    q, k, v = _sdpa_operands_d(layout, dtype, dev, n, m, b, h, 32)
    scale = 32 ** -0.5
    _, lse = attention.sdpa_cuda(q, k, v, scale, with_lse=True)
    want_lse = torch.logsumexp(torch.matmul(q.float(), k.float().transpose(
        -1, -2)) * scale, dim=-1)
    _assert_scaled(lse, want_lse, 1e-5)
    dout = _randn((b, n, h, 32), dtype, dev, 77).transpose(1, 2)
    got = attention.sdpa_backward_cuda(q, k, v, dout, lse, scale)
    again = attention.sdpa_backward_cuda(q, k, v, dout, lse, scale)
    want = attention.sdpa_backward_plain(q, k, v, dout, lse, scale)
    for g, g2, w in zip(got, again, want):
        assert g.shape == w.shape and g.dtype == dtype
        assert torch.equal(g, g2)
        _assert_scaled(g, w, 1e-4 if dt == "fp32" else tol)


# the pretraining path at 224, B = 64 (chip_smoke.py's PRETRAIN_SHAPES): the
# encoders on the 20 visible tokens and on 196 (CroCoNet()'s 12 heads, v2's
# 16), the decoders' cross-attention (CroCoNet()'s at head dim 32) and v2's
# self-attention
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("layout,h,n,d", [
    ("self", 12, 20, 64), ("self", 12, 196, 64), ("cross", 16, 196, 32),
    ("self", 16, 20, 64), ("self", 16, 196, 64), ("cross", 12, 196, 64)])
def test_sdpa_kernels_at_the_pretrain_shapes(dev, dt, layout, h, n, d):
    """K2 and its backward at the pretraining path's shapes against their
    plain versions, q, k, v in the path's layouts."""
    dtype, tol = DTYPES[dt]
    q, k, v = _sdpa_operands_d(layout, dtype, dev, n, n, 64, h, d, seed=90)
    scale = d ** -0.5
    out, lse = attention.sdpa_cuda(q, k, v, scale, with_lse=True)
    _assert_scaled(out, attention.sdpa_plain(q, k, v, scale),
                   1e-4 if dt == "fp32" else tol)
    dout = _randn((64, n, h, d), dtype, dev, 91).transpose(1, 2)
    got = attention.sdpa_backward_cuda(q, k, v, dout, lse, scale)
    want = attention.sdpa_backward_plain(q, k, v, dout, lse, scale)
    for g, w in zip(got, want):
        _assert_scaled(g, w, 1e-4 if dt == "fp32" else tol)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("n", [20, 196])
def test_rope_kernels_at_the_pretrain_positions(dev, dt, n):
    """K3 both ways on the v2 encoder's q and k, (64, 16, n, 64) slices of
    one qkv projection, at the positions croco_forward gives them: the
    visible tokens' gathered under a random mask at ratio 0.9 (n = 20), the
    whole grid with stride 0 over the batch (n = 196)."""
    from spann3r_torch.models.croco_pretrain import random_mask
    from spann3r_torch.models.vit import patch_positions

    dtype, _ = DTYPES[dt]
    grid = patch_positions(14, 14, dev)[None].expand(64, -1, -1)
    if n < 196:
        mask = random_mask(torch.Generator(device=dev).manual_seed(92), 64,
                           196, 0.9, dev)
        order = torch.argsort(mask.to(torch.int32), dim=1, stable=True)
        pos = torch.take_along_dim(grid, order[:, :n, None], dim=1)
    else:
        pos = grid
    q, k, _ = _sdpa_operands_d("self", dtype, dev, n, n, 64, 16, 64, seed=93)
    rope_tol = 8e-3 if dtype == torch.bfloat16 else 1e-5
    for sign in (1.0, -1.0):
        qr, kr = rope.rope_2d_qk_cuda(q, k, pos, pos, 100.0, sign)
        _assert_close(qr, rope.rope_2d_plain(q, pos, 100.0, sign), rope_tol)
        _assert_close(kr, rope.rope_2d_plain(k, pos, 100.0, sign), rope_tol)


@pytest.mark.parametrize("d", [16, 48, 128])
def test_sdpa_kernels_refuse_other_head_dims(dev, d):
    q = _randn((1, 2, 8, d), torch.bfloat16, dev, 80)
    with pytest.raises(ValueError, match="head dim 32 or 64"):
        attention.sdpa_cuda(q, q, q, 0.125)
    lse = torch.zeros((1, 2, 8), device=dev)
    with pytest.raises(ValueError, match="head dim 32 or 64"):
        attention.sdpa_backward_cuda(q, q, q, q, lse, 0.125)
