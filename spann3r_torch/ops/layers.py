"""Primitive layers as functions over `nn.Module` parameter holders.

Parameters live in fp32 in standard PyTorch modules (`nn.Linear`,
`nn.LayerNorm`, `nn.Conv2d`, `nn.ConvTranspose2d`), so their state-dict
keys and layouts are the reference checkpoint's. The functions here apply
the numeric policy of the JAX package:
  - `linear` casts the weight to the activation dtype; products accumulate
    in fp32 (bf16 GEMMs on the card and on the CPU accumulate in fp32); an
    int8 `QuantLinear` dequantises its weight in the activation dtype, or
    quantises the activations too on calls with enough rows;
  - `layer_norm` normalises in fp32 and casts back;
  - convolutions run NCHW in the activation dtype;
  - `interpolate_bilinear` resizes in fp32 with align_corners semantics.

Random initialisation follows the JAX package's rules (xavier-uniform
weights, zero biases, unit LayerNorm scales) from an explicit
`torch.Generator`.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class QuantLinear(nn.Module):
    """An int8 linear for serving (`ops.quant.quantize_linear_weights_`):
    w_q (out, in) int8 and w_scale (out, 1) fp32, the per-output-channel
    scale, with the bias of the linear it replaces. `act_min_rows` > 0
    quantises the activations too, per row, when a call has at least that
    many rows; 0 keeps every call weight-only."""

    def __init__(self, w_q: torch.Tensor, w_scale: torch.Tensor,
                 bias: Optional[nn.Parameter], act_min_rows: int = 0):
        super().__init__()
        self.register_buffer("w_q", w_q)
        self.register_buffer("w_scale", w_scale)
        self.bias = bias
        self.act_min_rows = act_min_rows


def _int8_act_linear(m: QuantLinear, x: torch.Tensor) -> torch.Tensor:
    """Per-row symmetric int8 of x, an int8 x int8 -> int32 product
    (`torch._int_mm`), then both scales in fp32, as the JAX package's int8
    activation path computes it. On the card the product needs more than
    16 rows and K, N multiples of 8; other shapes raise."""
    k, n = x.shape[-1], m.w_q.shape[0]
    rows = x.numel() // k
    if x.device.type == "cuda" and (rows <= 16 or k % 8 or n % 8):
        raise ValueError(f"the int8 product takes > 16 rows and K, N "
                         f"multiples of 8 on the card; got {rows} rows, "
                         f"K={k}, N={n}")
    xf = x.float()
    xs = (xf.abs().amax(dim=-1, keepdim=True) / 127.0).clamp(min=1e-12)
    xq = torch.round(xf / xs).clamp(-127, 127).to(torch.int8)
    o = torch._int_mm(xq.reshape(rows, k), m.w_q.t())
    y = (o.float().reshape(*x.shape[:-1], n) * xs
         * m.w_scale.float().reshape(n)).to(x.dtype)
    return y if m.bias is None else y + m.bias.to(x.dtype)


def linear(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """x @ W^T + b in x's dtype, for an `nn.Linear` or a `QuantLinear`
    (weight-only: the weight dequantised in x's dtype as q * scale). A
    linear split by tensor parallelism carries its own forward
    (`tp_split`, set by parallel/sharding.py)."""
    split = getattr(m, "tp_split", None)
    if split is not None:
        return split(m, x)
    if isinstance(m, QuantLinear):
        if m.act_min_rows and x.numel() // x.shape[-1] >= m.act_min_rows:
            return _int8_act_linear(m, x)
        w = m.w_q.to(x.dtype) * m.w_scale.to(x.dtype)
    else:
        w = m.weight.to(x.dtype)
    b = None if m.bias is None else m.bias.to(x.dtype)
    return F.linear(x, w, b)


def layer_norm(m: nn.LayerNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    y = F.layer_norm(x.float(), (x.shape[-1],), m.weight.float(),
                     m.bias.float(), eps)
    return y.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    # exact erf formulation (nn.GELU default)
    return F.gelu(x)


def mlp(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Transformer MLP: fc1 -> GELU -> fc2."""
    return linear(m.fc2, gelu(linear(m.fc1, x)))


def conv2d(m: nn.Conv2d, x: torch.Tensor, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """NCHW convolution in the activation dtype."""
    b = None if m.bias is None else m.bias.to(x.dtype)
    return F.conv2d(x, m.weight.to(x.dtype), b, stride=stride, padding=padding)


def conv2d_transpose(m: nn.ConvTranspose2d, x: torch.Tensor,
                     stride: int) -> torch.Tensor:
    """NCHW transposed convolution with kernel == stride (non-overlapping)."""
    b = None if m.bias is None else m.bias.to(x.dtype)
    return F.conv_transpose2d(x, m.weight.to(x.dtype), b, stride=stride)


def interpolate_bilinear(x: torch.Tensor, out_hw, align_corners: bool = True
                         ) -> torch.Tensor:
    """Bilinear resize of NCHW maps, computed in fp32."""
    y = F.interpolate(x.float(), size=tuple(out_hw), mode="bilinear",
                      align_corners=align_corners)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

@torch.no_grad()
def xavier_uniform_(w: torch.Tensor, fan_in: int, fan_out: int,
                    generator: Optional[torch.Generator]) -> None:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    w.uniform_(-limit, limit, generator=generator)


@torch.no_grad()
def init_linear_(m: nn.Linear, generator: Optional[torch.Generator]) -> None:
    d_out, d_in = m.weight.shape
    xavier_uniform_(m.weight, d_in, d_out, generator)
    if m.bias is not None:
        m.bias.zero_()


@torch.no_grad()
def init_layer_norm_(m: nn.LayerNorm) -> None:
    m.weight.fill_(1.0)
    m.bias.zero_()


@torch.no_grad()
def init_conv_(m: nn.Module, generator: Optional[torch.Generator],
               xavier_flat: bool = False) -> None:
    """Conv2d weights (O, I, kh, kw) and ConvTranspose2d weights
    (I, O, kh, kw) with the JAX package's fans: fan_in = kh*kw*cin and
    fan_out = kh*kw*cout (cout when `xavier_flat`, the patch embedding)."""
    w = m.weight
    kh, kw = w.shape[2:]
    if isinstance(m, nn.ConvTranspose2d):
        cin, cout = w.shape[0], w.shape[1]
    else:
        cout, cin = w.shape[0], w.shape[1]
    fan_out = cout if xavier_flat else kh * kw * cout
    xavier_uniform_(w, kh * kw * cin, fan_out, generator)
    if m.bias is not None:
        m.bias.zero_()


@torch.no_grad()
def init_modules_(root: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Default init over a module tree, in registration order."""
    for m in root.modules():
        if isinstance(m, nn.Linear):
            init_linear_(m, generator)
        elif isinstance(m, nn.LayerNorm):
            init_layer_norm_(m)
        elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            init_conv_(m, generator)


class Mlp(nn.Module):
    """fc1/fc2 holder (state-dict keys `mlp.fc1`, `mlp.fc2`)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp(self, x)
