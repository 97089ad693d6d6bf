"""2D rotary position embedding (RoPE2D) over (B, H, N, D) tokens.

The head dim D is split into quarters [u_Y | v_Y | u_X | v_X] (Q = D/4).
For the Y pair with angle a = pos_y * base^(-i/Q), and likewise the X pair
with pos_x:

    u' = u cos(a) - v sin(a)
    v' = v cos(a) + u sin(a)

sign = -1 rotates by the negated angle, the inverse (the backward pass).
The angles and the rotation are computed in fp32 and the result is cast to
the input's dtype.

`rope_2d` (one tensor) and `rope_2d_qk` (the q and k of one attention)
dispatch on the device of their inputs: a CPU tensor takes the plain
PyTorch version, a CUDA tensor the CUDA kernel (`csrc/rope2d.cu`), which
rotates q and k in one launch, reads strided views (the q/k slices of the
qkv projection, positions expanded over the batch) through their strides
and writes contiguous results.
"""
from __future__ import annotations

import functools
import struct
from typing import List, Optional, Sequence, Tuple

import torch

from . import _kernels

# tokens per block of the kernel (the block computes the angles of its
# tokens once and rotates every head of q and k over them): the largest of
# these that still gives every SM a block. On the H100 16 was the best tile
# at the encoder's shape and 4 at the decoder's (PERF.md)
TILE_TOKENS = (16, 8, 4, 2, 1)


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


def _strides(t: torch.Tensor) -> List[int]:
    """Element strides of the first three dims; 0 where a dim has size 1
    (its index is always 0, so its stride never counts)."""
    return [s if n > 1 else 0 for n, s in zip(t.shape[:3], t.stride()[:3])]


def _vector_width(esize: int, quarter: int, addresses: Sequence[int],
                  strides: Sequence[int]) -> int:
    """The most elements, up to 16 bytes, whose byte count divides D/4
    elements, every address and every stride (in elements): the lowest set
    bit of all of them together."""
    bits = 16 | quarter * esize
    for a in addresses:
        bits |= a
    for st in strides:
        bits |= st * esize
    return (bits & -bits) // esize


def vector_width(tensors: Sequence[torch.Tensor]) -> int:
    """Elements per vector access of the kernel: the most that fit 16
    bytes, divide D/4 and keep every pointer and stride of `tensors` (the
    inputs and outputs, which share dtype and D) aligned."""
    return _vector_width(tensors[0].element_size(), tensors[0].shape[-1] // 4,
                         [t.data_ptr() for t in tensors],
                         [st for t in tensors for st in _strides(t)])


def token_tile(n_tokens: int, blocks_per_tile: int, sms: int) -> int:
    """Tokens per block: the largest of TILE_TOKENS whose grid
    (ceil(N / tile) x blocks_per_tile blocks) still covers `sms` SMs."""
    for tile in TILE_TOKENS:
        if -(-n_tokens // tile) * blocks_per_tile >= sms:
            return tile
    return TILE_TOKENS[-1]


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(ops: Sequence[Tuple[torch.Tensor, torch.Tensor]], base: float,
            sign: float, tile: Optional[int] = None) -> List[torch.Tensor]:
    """One kernel launch over one or two (tokens, pos) operands that share
    B, H, D, dtype and device (N may differ). Returns the rotated tokens,
    each a new contiguous (B, H, N, D) tensor. `tile` (tokens per block)
    defaults to `token_tile`'s choice. The host work is kept small: the
    decoder calls this ~1100 times per 24 frames from a host-bound loop."""
    if not 1 <= len(ops) <= 2:
        raise ValueError(f"the kernel takes one or two operands, got {len(ops)}")
    x0 = ops[0][0]
    if x0.dim() != 4:
        raise ValueError(f"tokens must be (B, H, N, D), got {tuple(x0.shape)}")
    b, h, _, d = x0.shape
    if d % 4 != 0:
        raise ValueError(f"head dim {d} must be a multiple of 4")
    dev = x0.device
    outs, ptrs, strides, n_tokens, pos32 = [], [], [], [], []
    addresses, x_strides = [], []   # what the vector width must divide
    for i, (x, pos) in enumerate(ops):
        _kernels.require(x, f"tokens {i}", dtype=x0.dtype, device=dev,
                         last_contiguous=True)
        if x.dim() != 4 or (x.shape[0], x.shape[1], x.shape[3]) != (b, h, d):
            raise ValueError(f"tokens {i} has shape {tuple(x.shape)}, expected "
                             f"({b}, {h}, N, {d})")
        _kernels.require(pos, f"pos {i}", device=dev,
                         shape=(b, x.shape[2], 2))
        if pos.dtype.is_floating_point:
            raise ValueError(f"pos {i} must be integer, got {pos.dtype}")
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        outs.append(out)
        if x.numel() == 0:
            continue
        if pos.dtype != torch.int32:
            pos = pos.to(torch.int32)
        pos32.append(pos)   # holds a converted copy until the launch
        n = x.shape[2]
        sx = _strides(x)
        addresses += [x.data_ptr(), out.data_ptr()]
        x_strides += sx
        ptrs += [addresses[-2], addresses[-1], pos.data_ptr()]
        # out is contiguous: its strides are multiples of D
        strides += sx + [h * n * d if b > 1 else 0, n * d if h > 1 else 0,
                         d if n > 1 else 0] + list(pos.stride())
        n_tokens.append(n)
    n_ops = len(n_tokens)
    if n_ops == 0:
        return outs
    vec = _vector_width(x0.element_size(), d // 4, addresses, x_strides)
    # one block rotates both operands where they share their positions
    shared = n_ops == 2 and n_tokens[0] == n_tokens[1] and \
        ptrs[2] == ptrs[5] and strides[6:9] == strides[15:18]
    if tile is None:
        tile = token_tile(max(n_tokens), b * (1 if shared else n_ops),
                          _sm_count(dev))
    code = _kernels.lib().spann3r_rope2d(
        n_ops, struct.pack(f"{3 * n_ops}Q", *ptrs),
        struct.pack(f"{9 * n_ops}q", *strides),
        struct.pack(f"{n_ops}i", *n_tokens), int(shared),
        _kernels.DTYPE_CODE[x0.dtype], b, h, d, vec, tile, float(base),
        float(sign), _kernels.stream_ptr(dev))
    _kernels.check(code, "rope2d")
    _kernels.LAUNCHES["rope2d"] += 1
    return outs


def rope_2d_cuda(tokens: torch.Tensor, pos: torch.Tensor,
                 base: float = 100.0, sign: float = 1.0) -> torch.Tensor:
    """RoPE2D of one tensor through the CUDA kernel; returns a contiguous
    tensor."""
    return _launch([(tokens, pos)], base, sign)[0]


def rope_2d_qk_cuda(q: torch.Tensor, k: torch.Tensor, qpos: torch.Tensor,
                    kpos: torch.Tensor, base: float = 100.0,
                    sign: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """RoPE2D of q and k in one launch of the CUDA kernel; returns two
    contiguous tensors."""
    qr, kr = _launch([(q, qpos), (k, kpos)], base, sign)
    return qr, kr


def rope_2d(tokens: torch.Tensor, pos: torch.Tensor, base: float = 100.0,
            sign: float = 1.0) -> torch.Tensor:
    """Apply 2D RoPE to (B, H, N, D) tokens with (B, N, 2) integer (y, x)
    positions: the plain version on the CPU, the kernel on CUDA."""
    if tokens.device.type == "cpu":
        return rope_2d_plain(tokens, pos, base, sign)
    if tokens.device.type == "cuda":
        return rope_2d_cuda(tokens, pos, base, sign)
    raise NotImplementedError(f"rope_2d on {tokens.device}")


def rope_2d_qk(q: torch.Tensor, k: torch.Tensor, qpos: torch.Tensor,
               kpos: torch.Tensor, base: float = 100.0, sign: float = 1.0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply 2D RoPE to q (B, H, N, D) with qpos (B, N, 2) and to k
    (B, H, M, D) with kpos (B, M, 2): the plain version on each on the CPU,
    one kernel launch on CUDA."""
    if q.device.type == "cpu":
        return (rope_2d_plain(q, qpos, base, sign),
                rope_2d_plain(k, kpos, base, sign))
    if q.device.type == "cuda":
        return rope_2d_qk_cuda(q, k, qpos, kpos, base, sign)
    raise NotImplementedError(f"rope_2d_qk on {q.device}")
