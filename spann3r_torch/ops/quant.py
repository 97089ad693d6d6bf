"""Serving modes of the weights: bf16 storage and int8 linear weights.

Both act in place on the model and pick the same tensors as the JAX
package's `ops/quant.py` rules, read through the converter's key map (the
JAX `head1`/`head2` subtrees are the port's `downstream_head1`/`2`):

  - `cast_serving_weights_` stores every floating weight in bf16 but the
    LayerNorms and the `downstream_head*` subtrees, whose use sites run in
    fp32. `linear` and the convolutions cast their weights to the
    activation dtype at every call, so under BF16 the pre-cast model gives
    the same bits and skips one cast per weight per call. The `attn_head_*`
    MLPs are cast too (in JAX, "attn_head_1".startswith("head") is false).
  - `quantize_linear_weights_` replaces each `nn.Linear` whose weight has
    both dims >= min_dim by a `QuantLinear`: int8 q = round(w / s), clipped
    to +-127, with the per-output-channel scale s = max|w| / 127 over the
    contraction axis (clamped at 1e-12), in fp32; `round` is half to even
    on both sides. The heads (`downstream_head*`, `attn_head*`), the
    convolutions and the biases stay as they are. `act_min_rows` > 0 also
    quantises the activations of calls with at least that many rows (the
    JAX package's SPANN3R_INT8_ACT, whose "on" means 1024 rows).
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from .layers import QuantLinear

# the JAX package's activation floor when its int8 activation path is on
INT8_ACT_ROWS = 1024


def _under(name: str, prefixes: Tuple[str, ...]) -> bool:
    return any(part.startswith(prefixes) for part in name.split("."))


@torch.no_grad()
def cast_serving_weights_(model: nn.Module) -> nn.Module:
    """Store the serving weights in bf16, in place; returns the model."""
    for name, mod in model.named_modules():
        if isinstance(mod, nn.LayerNorm) or _under(name, ("downstream_head",)):
            continue
        for tensors in (mod._parameters, mod._buffers):
            for t in tensors.values():
                if t is not None and t.is_floating_point():
                    t.data = t.data.to(torch.bfloat16)
    return model


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """w (out, in) -> (q (out, in) int8, scale (out, 1) fp32)."""
    wf = w.float()
    scale = (wf.abs().amax(dim=-1, keepdim=True) / 127.0).clamp(min=1e-12)
    q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def quantize_linear_weights_(model: nn.Module, min_dim: int = 512,
                             act_min_rows: int = 0) -> nn.Module:
    """Replace the eligible linears by int8 `QuantLinear`s, in place;
    returns the model."""
    targets = [(name, mod) for name, mod in model.named_modules()
               if isinstance(mod, nn.Linear)
               and not _under(name, ("downstream_head", "attn_head"))
               and min(mod.weight.shape) >= min_dim]
    for name, mod in targets:
        parent_name, _, child = name.rpartition(".")
        parent = model.get_submodule(parent_name)
        q, scale = quantize_weight(mod.weight)
        setattr(parent, child, QuantLinear(q, scale, mod.bias, act_min_rows))
    return model


def count_quantized(model: nn.Module) -> int:
    """The number of int8 matrices. The JAX package counts a stacked
    (L, in, out) block weight once; here every block holds its own."""
    return sum(isinstance(m, QuantLinear) for m in model.modules())
