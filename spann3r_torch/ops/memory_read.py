"""Spatial-memory readout: masked, thresholded single-head attention.

For layer-normed queries q (B, P, D) and bank keys/values k, v (B, C, D)
with `size` valid slots per stream:

    s = q k^T / sqrt(D), masked to -1e30 at slots >= size
    a = softmax(s)
    with attn_thresh > 0:  a = where(a < attn_thresh, 0, a) / (kept + 1e-12)
    out = a v             (in q's dtype)
    asum = sum over queries of a, per slot (fp32; the prune statistic)

The attention weights stay fp32 through the readout, as in the fused TPU
kernel. `memory_read_attention` dispatches on the device of q: a CPU
tensor takes the plain PyTorch version, a CUDA tensor the CUDA kernel
(`csrc/memory_read.cu`); both take any number B of streams.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from . import _kernels

NEG_INF = -1e30


def memory_read_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, size: torch.Tensor,
                                attn_thresh: float
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch readout. size: (B,) int."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    valid = torch.arange(k.shape[1], device=k.device)[None, :] < size[:, None]
    s = torch.where(valid[:, None, :], s, torch.full_like(s, NEG_INF))
    a = torch.softmax(s, dim=-1)
    if attn_thresh > 0:
        a = torch.where(a < attn_thresh, torch.zeros_like(a), a)
        a = a / (a.sum(dim=-1, keepdim=True) + 1e-12)
    out = torch.matmul(a, v.float()).to(q.dtype)
    return out, a.sum(dim=-2)


def memory_read_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, size: torch.Tensor,
                               attn_thresh: float
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel: q (B, P, D), k/v (B, C, D) of one dtype, contiguous,
    size (B,) int32 on the device (read there, never by the host)."""
    b, p, d = q.shape
    c = k.shape[1]
    dev = q.device
    for t, name, shape in ((q, "q", (b, p, d)), (k, "k", (b, c, d)),
                           (v, "v", (b, c, d))):
        _kernels.require(t, name, dtype=q.dtype, device=dev, shape=shape,
                         contiguous=True)
    _kernels.require(size, "size", dtype=torch.int32, device=dev, shape=(b,),
                     contiguous=True)
    lib = _kernels.lib()
    dtype = _kernels.DTYPE_CODE[q.dtype]
    out = torch.empty((b, p, d), dtype=q.dtype, device=dev)
    asum = torch.empty((b, c), dtype=torch.float32, device=dev)
    workspace = torch.empty(
        lib.spann3r_memory_read_workspace(dtype, b, p, c, d),
        dtype=torch.uint8, device=dev)
    code = lib.spann3r_memory_read(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), size.data_ptr(),
        out.data_ptr(), asum.data_ptr(), workspace.data_ptr(), dtype, b, p, c,
        d, 1.0 / math.sqrt(d), float(attn_thresh), _kernels.stream_ptr(dev))
    _kernels.check(code, "memory_read")
    _kernels.LAUNCHES["memory_read"] += 1
    return out, asum


def memory_read_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          size: torch.Tensor, attn_thresh: float
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (B, P, D) in q's dtype, asum (B, C) fp32)."""
    if q.device.type == "cpu":
        return memory_read_attention_plain(q, k, v, size, attn_thresh)
    if q.device.type == "cuda":
        return memory_read_attention_cuda(q, k, v, size, attn_thresh)
    raise NotImplementedError(f"memory_read_attention on {q.device}")
