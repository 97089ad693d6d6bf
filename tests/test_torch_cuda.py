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


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("b,h,n,m", [(2, 3, 20, 20), (1, 4, 70, 33),
                                     (1, 2, 196, 196),
                                     (32, 32, 65, 40)])   # 4-row layout
def test_sdpa_kernel(dev, dt, b, h, n, m):
    dtype, tol = DTYPES[dt]
    q = _randn((b, h, n, 64), dtype, dev, 1)
    k = _randn((b, h, m, 64), dtype, dev, 2)
    v = _randn((b, h, m, 64), dtype, dev, 3)
    out = attention.sdpa(q, k, v, 0.125)
    _assert_close(out, attention.sdpa_plain(q, k, v, 0.125),
                  max(tol, 1e-4) if dt == "fp32" else tol)


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


def test_memory_read_kernel_is_single_stream(dev):
    q = _randn((2, 16, 64), torch.float32, dev, 7)
    with pytest.raises(NotImplementedError, match="B>1"):
        memory_read.memory_read_attention(
            q, q, q, torch.tensor([4, 4], dtype=torch.int32, device=dev), 5e-4)


def test_memory_read_column_sums_are_deterministic(dev):
    q = _randn((1, 96, 128), torch.bfloat16, dev, 8)
    k = _randn((1, 1024, 128), torch.bfloat16, dev, 9)
    sz = torch.tensor([900], dtype=torch.int32, device=dev)
    runs = [memory_read.memory_read_attention(q, k, k, sz, 5e-4)[1]
            for _ in range(3)]
    for r in runs[1:]:
        assert torch.equal(r, runs[0])
