"""Weight and state conversion from the JAX package's layouts.

`state_dict_from_jax_params` takes the JAX Spann3R param pytree as nested
dicts of numpy arrays and returns the port's state dict (reference key
names), so both packages can run on the same weights:
  - linear {'w': (in, out), 'b'} -> weight (out, in), bias
  - int8 linear {'w_q': (in, out) int8, 'w_scale': (1, out), 'b'} (the
    JAX package's quantised pytree) -> a `QuantLinear`'s w_q (out, in)
    and w_scale (out, 1); load it into a model quantised with
    `ops.quant.quantize_linear_weights_` at the same min_dim
  - LayerNorm {'scale', 'bias'} -> weight, bias
  - conv HWIO -> OIHW
  - transposed conv: the JAX kernel is HWIO and spatially flipped; it
    becomes ConvTranspose2d's (in, out, kh, kw) with the flip undone
  - block stacks (leading depth axis) -> one entry per block index
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..config import DUSt3RConfig, Spann3RConfig
from ..models.memory import MemoryState


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _lin(sd, prefix, p):
    if "w_q" in p:  # int8: the port's QuantLinear buffers
        sd[prefix + ".w_q"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(p["w_q"], np.int8).T))
        sd[prefix + ".w_scale"] = _t(np.asarray(p["w_scale"]).T)
    else:
        sd[prefix + ".weight"] = _t(np.asarray(p["w"]).T)
    if p.get("b") is not None:
        sd[prefix + ".bias"] = _t(p["b"])


def _ln(sd, prefix, p):
    sd[prefix + ".weight"] = _t(p["scale"])
    sd[prefix + ".bias"] = _t(p["bias"])


def _conv(sd, prefix, p):
    sd[prefix + ".weight"] = _t(np.transpose(np.asarray(p["w"]), (3, 2, 0, 1)))
    if p.get("b") is not None:
        sd[prefix + ".bias"] = _t(p["b"])


def _deconv(sd, prefix, p):
    w = np.asarray(p["w"])[::-1, ::-1]  # undo the spatial flip
    sd[prefix + ".weight"] = _t(np.transpose(w, (2, 3, 0, 1)))
    if p.get("b") is not None:
        sd[prefix + ".bias"] = _t(p["b"])


def _index(tree, i):
    if isinstance(tree, Mapping):
        return {k: _index(v, i) for k, v in tree.items()}
    return None if tree is None else np.asarray(tree)[i]


def _block(sd, prefix, p, decoder=False):
    _ln(sd, f"{prefix}.norm1", p["norm1"])
    _lin(sd, f"{prefix}.attn.qkv", p["attn"]["qkv"])
    _lin(sd, f"{prefix}.attn.proj", p["attn"]["proj"])
    _ln(sd, f"{prefix}.norm2", p["norm2"])
    _lin(sd, f"{prefix}.mlp.fc1", p["mlp"]["fc1"])
    _lin(sd, f"{prefix}.mlp.fc2", p["mlp"]["fc2"])
    if decoder:
        for k in ("projq", "projk", "projv", "proj"):
            _lin(sd, f"{prefix}.cross_attn.{k}", p["cross_attn"][k])
        _ln(sd, f"{prefix}.norm3", p["norm3"])
        _ln(sd, f"{prefix}.norm_y", p["norm_y"])


def _block_stack(sd, prefix, stacked, decoder=False):
    depth = np.asarray(stacked["norm1"]["scale"]).shape[0]
    for i in range(depth):
        _block(sd, f"{prefix}.{i}", _index(stacked, i), decoder)


def _dpt_head(sd, prefix, p):
    _conv(sd, f"{prefix}.act_postprocess.0.0", p["act0_conv"])
    _deconv(sd, f"{prefix}.act_postprocess.0.1", p["act0_deconv"])
    _conv(sd, f"{prefix}.act_postprocess.1.0", p["act1_conv"])
    _deconv(sd, f"{prefix}.act_postprocess.1.1", p["act1_deconv"])
    _conv(sd, f"{prefix}.act_postprocess.2.0", p["act2_conv"])
    _conv(sd, f"{prefix}.act_postprocess.3.0", p["act3_conv"])
    _conv(sd, f"{prefix}.act_postprocess.3.1", p["act3_conv2"])
    _conv(sd, f"{prefix}.head.0", p["head_conv1"])
    _conv(sd, f"{prefix}.head.2", p["head_conv2"])
    _conv(sd, f"{prefix}.head.4", p["head_conv3"])
    for i in range(4):
        _conv(sd, f"{prefix}.scratch.layer{i + 1}_rn", p[f"rn{i}"])
        rf = f"{prefix}.scratch.refinenet{i + 1}"
        q = p[f"refine{i + 1}"]
        _conv(sd, f"{rf}.resConfUnit1.conv1", q["res1"]["conv1"])
        _conv(sd, f"{rf}.resConfUnit1.conv2", q["res1"]["conv2"])
        _conv(sd, f"{rf}.resConfUnit2.conv1", q["res2"]["conv1"])
        _conv(sd, f"{rf}.resConfUnit2.conv2", q["res2"]["conv2"])
        _conv(sd, f"{rf}.out_conv", q["out_conv"])


def _dust3r(sd, prefix, p, cfg: DUSt3RConfig):
    _conv(sd, f"{prefix}patch_embed.proj", p["patch_embed"]["proj"])
    _block_stack(sd, f"{prefix}enc_blocks", p["enc_blocks"])
    _ln(sd, f"{prefix}enc_norm", p["enc_norm"])
    _lin(sd, f"{prefix}decoder_embed", p["decoder_embed"])
    _block_stack(sd, f"{prefix}dec_blocks", p["dec_blocks"], decoder=True)
    _block_stack(sd, f"{prefix}dec_blocks2", p["dec_blocks2"], decoder=True)
    _ln(sd, f"{prefix}dec_norm", p["dec_norm"])
    for num in (1, 2):
        if cfg.head_type == "dpt":
            _dpt_head(sd, f"{prefix}downstream_head{num}.dpt", p[f"head{num}"])
        else:
            _lin(sd, f"{prefix}downstream_head{num}.proj",
                 p[f"head{num}"]["proj"])


def state_dict_from_jax_params(params_np: Mapping[str, Any],
                               cfg: Spann3RConfig) -> Dict[str, torch.Tensor]:
    """JAX Spann3R params (nested dicts of numpy arrays) -> the port's
    state dict, loadable with `load_state_dict(strict=True)`."""
    sd: Dict[str, torch.Tensor] = {}
    _dust3r(sd, "dust3r.", params_np["dust3r"], cfg.dust3r)
    _block_stack(sd, "value_encoder", params_np["value_encoder"])
    _ln(sd, "value_norm", params_np["value_norm"])
    _lin(sd, "value_out", params_np["value_out"])
    for k in ("norm_q", "norm_k", "norm_v"):
        _ln(sd, k, params_np[k])
    for num in (1, 2):
        _lin(sd, f"attn_head_{num}.0", params_np[f"attn_head_{num}"]["fc1"])
        _lin(sd, f"attn_head_{num}.2", params_np[f"attn_head_{num}"]["fc2"])
    if "pos_patch_embed" in params_np:
        _conv(sd, "pos_patch_embed.proj", params_np["pos_patch_embed"]["proj"])
    return sd


def memory_state_from_jax(state_np, device=None) -> MemoryState:
    """A JAX MemoryState (fields as numpy arrays) -> the port's MemoryState.
    Keys and values keep their dtype (bfloat16 arrives through float32)."""
    def conv(name, dtype=None):
        a = np.asarray(getattr(state_np, name))
        if a.dtype.kind == "V" or str(a.dtype) == "bfloat16":
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a, copy=True))
        return t.to(device=device, dtype=dtype or t.dtype)

    return MemoryState(conv("k"), conv("v"), conv("count", torch.float32),
                       conv("attn", torch.float32), conv("size", torch.int32),
                       conv("wm", torch.int32), conv("lm", torch.int32))
