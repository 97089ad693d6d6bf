"""2D rotary position embedding (RoPE2D) over (B, H, N, D) tokens.

The head dim D is split into quarters [u_Y | v_Y | u_X | v_X] (Q = D/4).
For the Y pair with angle a = pos_y * base^(-i/Q), and likewise the X pair
with pos_x:

    u' = u cos(a) - v sin(a)
    v' = v cos(a) + u sin(a)

sign = -1 rotates by the negated angle, the inverse (the backward pass).
The angles and the rotation are computed in fp32 and the result is cast to
the input's dtype.

`rope_2d` dispatches on the device of its input: a CPU tensor takes the
plain PyTorch version, a CUDA tensor the CUDA kernel
(`csrc/rope2d.cu`), which reads strided views (the q/k slices of the qkv
projection) through their strides and writes a contiguous result.
"""
from __future__ import annotations

import torch

from . import _kernels


def rope_2d_plain(tokens: torch.Tensor, pos: torch.Tensor,
                  base: float = 100.0, sign: float = 1.0) -> torch.Tensor:
    """Plain PyTorch RoPE2D: tokens (B, H, N, D), pos (B, N, 2) int (y, x)."""
    d = tokens.shape[-1]
    if d % 4 != 0:
        raise ValueError(f"head dim {d} must be a multiple of 4")
    q = d // 4
    idx = torch.arange(q, dtype=torch.float32, device=tokens.device)
    inv_freq = 1.0 / (base ** (idx / q))
    ang_y = pos[..., 0].float()[..., None] * inv_freq      # (B, N, Q)
    ang_x = pos[..., 1].float()[..., None] * inv_freq
    cos_y, sin_y = torch.cos(ang_y)[:, None], torch.sin(ang_y)[:, None] * sign
    cos_x, sin_x = torch.cos(ang_x)[:, None], torch.sin(ang_x)[:, None] * sign
    u_y, v_y, u_x, v_x = tokens.float().split(q, dim=-1)
    out = torch.cat([u_y * cos_y - v_y * sin_y,
                     v_y * cos_y + u_y * sin_y,
                     u_x * cos_x - v_x * sin_x,
                     v_x * cos_x + u_x * sin_x], dim=-1)
    return out.to(tokens.dtype)


def rope_2d_cuda(tokens: torch.Tensor, pos: torch.Tensor,
                 base: float = 100.0, sign: float = 1.0) -> torch.Tensor:
    """RoPE2D through the CUDA kernel; returns a contiguous tensor."""
    if tokens.dim() != 4:
        raise ValueError(f"tokens must be (B, H, N, D), got {tuple(tokens.shape)}")
    b, h, n, d = tokens.shape
    if d % 4 != 0:
        raise ValueError(f"head dim {d} must be a multiple of 4")
    dev = tokens.device
    _kernels.require(tokens, "tokens", last_contiguous=True)
    _kernels.require(pos, "pos", device=dev, shape=(b, n, 2))
    pos32 = pos.to(torch.int32).contiguous()
    out = torch.empty((b, h, n, d), dtype=tokens.dtype, device=dev)
    lib = _kernels.lib()
    code = lib.spann3r_rope2d(
        tokens.data_ptr(), out.data_ptr(), pos32.data_ptr(),
        _kernels.DTYPE_CODE[tokens.dtype], b, h, n, d,
        tokens.stride(0), tokens.stride(1), tokens.stride(2),
        float(base), float(sign), _kernels.stream_ptr(dev))
    _kernels.check(code, "rope2d")
    _kernels.LAUNCHES["rope2d"] += 1
    return out


def rope_2d(tokens: torch.Tensor, pos: torch.Tensor, base: float = 100.0,
            sign: float = 1.0) -> torch.Tensor:
    """Apply 2D RoPE to (B, H, N, D) tokens with (B, N, 2) integer (y, x)
    positions: the plain version on the CPU, the kernel on CUDA."""
    if tokens.device.type == "cpu":
        return rope_2d_plain(tokens, pos, base, sign)
    if tokens.device.type == "cuda":
        return rope_2d_cuda(tokens, pos, base, sign)
    raise NotImplementedError(f"rope_2d on {tokens.device}")
