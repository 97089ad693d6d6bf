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

`state_dict_from_croco_params` does the same for the JAX package's CroCo
pretraining params (`init_croco`'s pytree) and the port's `CroCoNet`.

`load_spann3r_checkpoint` loads a published Spann3R `.pth` into the port:
its module paths are the published keys already. `load_dust3r_checkpoint`
loads a DUSt3R `.pth` into the port's `dust3r` submodule. Both read a
training checkpoint too (`args` stored as an `argparse.Namespace`, as the
reference's and the port's trainers write it), with `weights_only` loading
that admits that one class besides tensors and containers.
"""
from __future__ import annotations

import argparse
import re
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


def state_dict_from_croco_params(params_np: Mapping[str, Any]
                                 ) -> Dict[str, torch.Tensor]:
    """JAX CroCoNet params (`croco_pretrain.init_croco`, nested dicts of
    numpy arrays) -> the state dict of the port's `CroCoNet`, loadable with
    `load_state_dict(strict=True)`."""
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, "patch_embed.proj", params_np["patch_embed"]["proj"])
    _block_stack(sd, "enc_blocks", params_np["enc_blocks"])
    _ln(sd, "enc_norm", params_np["enc_norm"])
    _lin(sd, "decoder_embed", params_np["decoder_embed"])
    _block_stack(sd, "dec_blocks", params_np["dec_blocks"], decoder=True)
    _ln(sd, "dec_norm", params_np["dec_norm"])
    sd["mask_token"] = _t(params_np["mask_token"])
    _lin(sd, "prediction_head", params_np["prediction_head"])
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


# Keys of the published checkpoints that the port does not hold (the JAX
# package's list, utils/torch_ckpt.py):
#  - scratch.layer_rn.N.weight: the reference DPT scratch registers the
#    SAME conv tensors twice (nn.ModuleList aliasing layer{N+1}_rn,
#    ref croco/models/dpt_block.py:70-74) — duplicates, not information
#  - mask_token: CroCo masked-pretraining token carried along by
#    AsymmetricCroCo3DStereo but never used in DUSt3R inference/training
#    (ref dust3r/model.py:107 lists it only for param-group bookkeeping)
_ALIAS_OR_VESTIGIAL = (
    re.compile(r"\.scratch\.layer_rn\.\d+\.weight$"),
    re.compile(r"(^|\.)mask_token$"),
)


def is_alias_or_vestigial_key(key: str) -> bool:
    return any(p.search(key) for p in _ALIAS_OR_VESTIGIAL)


def read_checkpoint(path: str) -> Dict[str, Any]:
    """A `.pth` read with `weights_only=True`, admitting the
    `argparse.Namespace` of the training `args` besides tensors and
    containers."""
    with torch.serialization.safe_globals([argparse.Namespace]):
        return torch.load(path, map_location="cpu", weights_only=True)


def _model_state(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of a checkpoint (itself, or under 'model'), without a
    DDP `module.` prefix and without the alias and vestigial keys."""
    ckpt = read_checkpoint(path)
    state = ckpt.get("model", ckpt)
    state = {(k[len("module."):] if k.startswith("module.") else k): v
             for k, v in state.items()}
    return {k: v for k, v in state.items() if not is_alias_or_vestigial_key(k)}


def load_spann3r_checkpoint(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a Spann3R `.pth` (a state dict, or a dict holding it under
    'model', like the training checkpoints; keys with or without a DDP
    `module.` prefix) into `model`, strictly, with the alias and vestigial
    keys dropped. Returns the model."""
    model.load_state_dict(_model_state(path), strict=True)
    return model


def load_dust3r_checkpoint(path: str, dust3r: torch.nn.Module) -> torch.nn.Module:
    """Load a DUSt3R `.pth` into the port's `dust3r` submodule, strictly.
    A checkpoint without a second decoder gives the first one's weights to
    both (ref dust3r/model.py:94-101; the JAX package's convert_dust3r).
    Returns the submodule."""
    state = _model_state(path)
    if not any(k.startswith("dec_blocks2.") for k in state):
        state.update({"dec_blocks2." + k[len("dec_blocks."):]: v
                      for k, v in state.items() if k.startswith("dec_blocks.")})
    dust3r.load_state_dict(state, strict=True)
    return dust3r
