"""Self and cross attention with RoPE2D and the SDPA kernel.

`sdpa` computes softmax(q k^T * scale) v with fp32 logits and softmax, the
normalised probabilities cast to v's dtype, and PV accumulated in fp32
(the JAX package's numerics). It dispatches on the device of its inputs:
a CPU tensor takes the plain PyTorch version, a CUDA tensor the CUDA
kernel (`csrc/sdpa.cu`, head dim 64 or 32; bf16 on the tensor cores
through wgmma), which reads q/k/v through their
strides and writes its output in the layout that merging the heads back
needs, so neither side copies.

Under autograd (a CUDA input that requires grad, grad mode on) `sdpa` goes
through `SDPAKernel`, whose forward is the same kernel asked for each
row's logsumexp as well, and whose backward is the backward kernel
(`csrc/sdpa_bwd.cu`): dq, dk, dv from q, k, v, dO and the logsumexp, with
the numerics of `sdpa_backward_plain`. Inference calls pay for neither.
On the CPU, `sdpa_plain` runs under ordinary autograd.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from . import _kernels
from .layers import linear
from .rope import rope_2d, rope_2d_qk


def sdpa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               scale: float) -> torch.Tensor:
    """q (B, H, N, Dh), k/v (B, H, M, Dh) -> (B, H, N, Dh) in v.dtype."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs.float(), v.float()).to(v.dtype)


def sdpa_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor, lse: torch.Tensor, scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's arithmetic in plain PyTorch: (dq, dk, dv) in
    q's dtype from q (B, H, N, Dh), k and v (B, H, M, Dh), the output's
    cotangent dout (B, H, N, Dh) and each row's fp32 logsumexp lse
    (B, H, N). P = exp(s - lse) is the fp32 softmax of the scaled logits s;
    dv takes P rounded to v's dtype (the forward multiplies that with v);
    the softmax VJP's row term is D = sum_j P dP with dP = dO v^T, all in
    fp32; dS = P (dP - D) * scale is rounded to q's dtype for the dq and
    dk products, as the kernel's tensor cores take it (a no-op in fp32).
    O is not needed: D is not formed as dO . O, which differs from the
    VJP's once O is rounded to bf16."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None])
    dof = dout.float()
    dv = torch.matmul(p.to(v.dtype).float().transpose(-1, -2), dof)
    dp = torch.matmul(dof, v.float().transpose(-1, -2))
    ds = p * (dp - (p * dp).sum(-1, keepdim=True)) * scale
    ds = ds.to(q.dtype).float()
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


# the head dims the CUDA kernels take: 64 (ViT-L, ViT-B) and 32 (the CroCo
# decoder, 512 wide with 16 heads)
KERNEL_HEAD_DIMS = (32, 64)


def _check_head_dim(d: int) -> None:
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the SDPA kernels take head dim 32 or 64, got {d}")


def _heads_view(b: int, h: int, n: int, d: int, like: torch.Tensor
                ) -> torch.Tensor:
    """A new (B, H, N, Dh) view of a (B, N, H, Dh) buffer: the layout that
    merging the heads (and the projections' backward) reads without a
    copy."""
    return torch.empty((b, n, h, d), dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def sdpa_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float, with_lse: bool = False):
    """SDPA through the CUDA kernel. The result is a (B, H, N, Dh) view of
    a (B, N, H, Dh) buffer; with `with_lse`, (result, each row's fp32
    logsumexp (B, H, N)), which the backward reads."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, N, Dh)")
    b, h, n, d = q.shape
    m = k.shape[2]
    dev = q.device
    _check_head_dim(d)
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _kernels.require(t, name, dtype=q.dtype, device=dev,
                         last_contiguous=True)
    _kernels.require(k, "k", shape=(b, h, m, d))
    _kernels.require(v, "v", shape=(b, h, m, d))
    out = _heads_view(b, h, n, d, v)
    lse = (torch.empty((b, h, n), dtype=torch.float32, device=dev)
           if with_lse else None)
    lib = _kernels.lib()
    strides = []
    for t in (q, k, v, out):
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    code = lib.spann3r_sdpa(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        _kernels.DTYPE_CODE[q.dtype], b, h, n, m, d, *strides, float(scale),
        _kernels.stream_ptr(dev))
    _kernels.check(code, "sdpa")
    _kernels.LAUNCHES["sdpa"] += 1
    return (out, lse) if with_lse else out


def sdpa_backward_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       dout: torch.Tensor, lse: torch.Tensor, scale: float
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) through the backward kernel, each a (B, H, *, Dh) view
    of a (B, *, H, Dh) buffer in q's dtype. dout is read through its
    strides (a copy only where its last dim is not contiguous)."""
    b, h, n, d = q.shape
    m = k.shape[2]
    dev = q.device
    _check_head_dim(d)
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    for t, name in ((q, "q"), (k, "k"), (v, "v"), (dout, "dout")):
        _kernels.require(t, name, dtype=q.dtype, device=dev,
                         last_contiguous=True)
    _kernels.require(k, "k", shape=(b, h, m, d))
    _kernels.require(v, "v", shape=(b, h, m, d))
    _kernels.require(dout, "dout", shape=(b, h, n, d))
    _kernels.require(lse, "lse", dtype=torch.float32, device=dev,
                     shape=(b, h, n), contiguous=True)
    dq, dk, dv = (_heads_view(b, h, rows, d, q) for rows in (n, m, m))
    drow = torch.empty((b, h, n), dtype=torch.float32, device=dev)
    strides = []
    for t in (q, k, v, dout, dq, dk, dv):
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    code = _kernels.lib().spann3r_sdpa_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), drow.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), _kernels.DTYPE_CODE[q.dtype], b, h, n, m, d,
        *strides, float(scale), _kernels.stream_ptr(dev))
    _kernels.check(code, "sdpa_bwd")
    _kernels.LAUNCHES["sdpa_bwd"] += 1
    return dq, dk, dv


class SDPAKernel(torch.autograd.Function):
    """SDPA on the card under autograd: the forward kernel, which also
    writes each row's logsumexp, and the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = sdpa_cuda(q, k, v, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = sdpa_backward_cuda(q, k, v, dout, lse, ctx.scale)
        return dq, dk, dv, None


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         scale: float) -> torch.Tensor:
    if q.device.type == "cpu":
        return sdpa_plain(q, k, v, scale)
    if q.device.type == "cuda":
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return SDPAKernel.apply(q, k, v, scale)
        return sdpa_cuda(q, k, v, scale)
    raise NotImplementedError(f"sdpa on {q.device}")


def _split_heads(x: torch.Tensor, head_dim: int) -> torch.Tensor:
    b, n, c = x.shape
    return x.reshape(b, n, c // head_dim, head_dim).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


class SelfAttention(nn.Module):
    """Packed-QKV attention parameters (keys `attn.qkv`, `attn.proj`)."""

    def __init__(self, dim: int, qkv_bias: bool = True):
        super().__init__()
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)


class CrossAttention(nn.Module):
    """Separate q/k/v projections (keys `cross_attn.proj{q,k,v}`, `.proj`)."""

    def __init__(self, dim: int, qkv_bias: bool = True):
        super().__init__()
        self.projq = nn.Linear(dim, dim, bias=qkv_bias)
        self.projk = nn.Linear(dim, dim, bias=qkv_bias)
        self.projv = nn.Linear(dim, dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)


def self_attention(m: SelfAttention, x: torch.Tensor,
                   pos: Optional[torch.Tensor], num_heads: int,
                   rope_base: float = 100.0) -> torch.Tensor:
    """x (B, N, C); RoPE on q and k when pos is given and rope_base > 0.
    The heads are counted from `qkv`'s output: under tensor parallelism
    (parallel/sharding.py) it holds this rank's heads only."""
    b, n, c = x.shape
    head_dim = c // num_heads
    qkv = linear(m.qkv, x)
    qkv = qkv.reshape(b, n, 3, qkv.shape[-1] // (3 * head_dim), head_dim)
    qkv = qkv.permute(2, 0, 3, 1, 4)  # (3, B, H, N, Dh) view
    q, k, v = qkv[0], qkv[1], qkv[2]
    if pos is not None and rope_base > 0:
        q, k = rope_2d_qk(q, k, pos, pos, rope_base)
    out = sdpa(q, k, v, head_dim ** -0.5)
    return linear(m.proj, _merge_heads(out))


def cross_attention(m: CrossAttention, query: torch.Tensor, key: torch.Tensor,
                    value: torch.Tensor, qpos: Optional[torch.Tensor],
                    kpos: Optional[torch.Tensor], num_heads: int,
                    rope_base: float = 100.0) -> torch.Tensor:
    """query (B, N, C) attends to key and value (B, M, C); the heads are
    counted from the projections' output, as in `self_attention`."""
    c = query.shape[-1]
    head_dim = c // num_heads
    q = _split_heads(linear(m.projq, query), head_dim)
    k = _split_heads(linear(m.projk, key), head_dim)
    v = _split_heads(linear(m.projv, value), head_dim)
    if rope_base > 0:
        if qpos is not None and kpos is not None:
            q, k = rope_2d_qk(q, k, qpos, kpos, rope_base)
        elif qpos is not None:
            q = rope_2d(q, qpos, rope_base)
        elif kpos is not None:
            k = rope_2d(k, kpos, rope_base)
    out = sdpa(q, k, v, head_dim ** -0.5)
    return linear(m.proj, _merge_heads(out))
