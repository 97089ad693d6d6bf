"""CroCo downstream-task adapters (the JAX package's
models/croco_downstream.py, after the reference's
croco/models/croco_downstream.py and head_downstream.py).

The reference wraps CroCoNet for dense per-pixel tasks: an encoder-only
monocular variant and an encoder + decoder binocular variant, each handing
a pluggable head ALL the intermediate states (return_all_blocks) for
DPT-style hooks. Here the same forwards run over the port's `CroCoNet`
modules:

  - croco_args_from_ckpt: the architecture keywords of a released
    checkpoint (v2 'croco_kwargs', the official 'args.model' string parsed
    with ast, never eval'd as the reference does, or v1's defaults)
  - dpt_hook_indices: the reference's automatic hook placement
  - downstream_monocular / downstream_binocular: forwards that hand
    head_fn(states, (H, W)) the collected states
  - croco_backbone: CroCoNet without the pretraining's mask token and
    prediction head, the module the downstream models hold

The keyword mapping (`cfg_from_croco_kwargs`, `croco_kwargs_from_cfg`) has
its one home in `croco_pretrain.py` and is re-exported here. The attention
runs through `ops.attention` (K2, and its backward under autograd) and,
with pos_embed='RoPE100', `ops.rope` (K3); the cosine mode adds sin-cos
tables at the encoder and decoder inputs. The stereo and flow task head,
PixelwiseTaskWithDPT, is in `spann3r_torch/stereoflow/head.py`.
"""
from __future__ import annotations

import ast
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..config import BF16, DUSt3RConfig, Precision
from ..ops.layers import init_linear_, layer_norm, linear
from .croco_pretrain import (CroCoNet, build_croco, cfg_from_croco_kwargs,
                             croco_kwargs_from_cfg, get_2d_sincos_pos_embed)
from .vit import block_apply, decoder_block_apply, patch_embed_apply

__all__ = ["croco_args_from_ckpt", "cfg_from_croco_kwargs",
           "croco_kwargs_from_cfg", "dpt_hook_indices", "croco_backbone",
           "downstream_monocular", "downstream_binocular",
           "linear_pixelwise_head"]


def croco_args_from_ckpt(ckpt: Dict) -> Dict:
    """Architecture kwargs from a checkpoint dict (ref
    croco_downstream.py:13-21). The official-release path stores a
    'CroCoNet(...)' string; the reference eval()s it, here it is parsed
    with ast.literal_eval on keyword literals only."""
    if "croco_kwargs" in ckpt:  # CroCo v2 released models
        return dict(ckpt["croco_kwargs"])
    args = ckpt.get("args")
    model_str = getattr(args, "model", None) if args is not None else None
    if model_str is not None:  # pretrained with the official code release
        node = ast.parse(model_str, mode="eval").body
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "CroCoNet"):
            raise ValueError(f"expected 'CroCoNet(...)', got {model_str!r}")
        return {k.arg: ast.literal_eval(k.value) for k in node.keywords}
    return {}  # CroCo v1 released models: all defaults


def dpt_hook_indices(enc_depth: int, dec_depth: Optional[int] = None
                     ) -> List[int]:
    """Automatic DPT hook placement (ref head_downstream.py:40-47):
    encoder-only -> 4 equally spread encoder layers; encoder + decoder ->
    the last encoder state and 3 equally spread decoder states, indexing
    the concatenated [enc states..., dec states...] list."""
    if dec_depth is None:
        step = enc_depth // 4
        return [enc_depth - 1 - i * step for i in range(3, -1, -1)]
    # the reference's table covers its released depths; ceil(d/3)
    # reproduces every entry and extends to other depths (tiny test models)
    step = {8: 3, 12: 4, 24: 8}.get(dec_depth, max(1, -(-dec_depth // 3)))
    return [dec_depth + enc_depth - 1 - i * step for i in range(3, -1, -1)]


def croco_backbone(cfg: DUSt3RConfig, device="cuda",
                   generator: Optional[torch.Generator] = None) -> CroCoNet:
    """A CroCoNet without mask_token and prediction_head, which the
    downstream models do not register (ref croco_downstream.py:40-55)."""
    model = build_croco(cfg, device, generator)
    del model.mask_token, model.prediction_head
    return model


def _sincos(dim: int, grid: Tuple[int, int], like: torch.Tensor
            ) -> torch.Tensor:
    return get_2d_sincos_pos_embed(dim, grid)[None].to(like.device,
                                                       like.dtype)


def _encode_all(model: CroCoNet, img: torch.Tensor, cfg: DUSt3RConfig,
                prec: Precision) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Full (unmasked) encode collecting EVERY block's output; the last
    state is enc_norm'ed like the reference's return_all_blocks path
    (ref croco.py:129-164)."""
    x, pos = patch_embed_apply(model.patch_embed,
                               img.to(prec.compute_dtype))
    if cfg.enc.rope_base <= 0:
        grid = (img.shape[1] // cfg.patch_size, img.shape[2] // cfg.patch_size)
        x = x + _sincos(cfg.enc.dim, grid, x)
    states = []
    for blk in model.enc_blocks:
        x = block_apply(blk, x, pos, cfg.enc)
        states.append(x)
    states[-1] = layer_norm(model.enc_norm, states[-1], cfg.enc.ln_eps)
    return states, pos


def downstream_monocular(model: CroCoNet, img: torch.Tensor,
                         cfg: DUSt3RConfig, head_fn: Callable,
                         prec: Precision = BF16, all_blocks: bool = True):
    """Encoder-only task forward (ref croco_downstream.py:24-64):
    head_fn(states, (H, W)) with every block's output (or only the last
    when all_blocks=False). img (B, H, W, 3)."""
    h, w = img.shape[1:3]
    states, _ = _encode_all(model, img, cfg, prec)
    return head_fn(states if all_blocks else states[-1], (h, w))


def downstream_binocular(model: CroCoNet, img1: torch.Tensor,
                         img2: torch.Tensor, cfg: DUSt3RConfig,
                         head_fn: Callable, prec: Precision = BF16,
                         all_blocks: bool = True):
    """Binocular task forward (ref croco_downstream.py:67-122): both images
    encoded in ONE batched pass, then a decoder over image 1 only, each of
    whose blocks cross-attends the fixed decoder_embed(f2) of image 2 (not
    the dual decoder of DUSt3R). The head sees image 1's half of every
    encoder state and every decoder state, [enc1..., dec...], like the
    reference's `out + decout`."""
    b, h, w, _ = img1.shape
    states, pos = _encode_all(model, torch.cat([img1, img2]), cfg, prec)
    enc1 = [s[:b] for s in states]
    f1, f2 = states[-1][:b], states[-1][b:]
    pos1, pos2 = pos[:b], pos[b:]

    d1 = linear(model.decoder_embed, f1)
    d2 = linear(model.decoder_embed, f2)
    if cfg.dec.rope_base <= 0:
        pe = _sincos(cfg.dec.dim, (h // cfg.patch_size, w // cfg.patch_size),
                     d1)
        d1 = d1 + pe
        d2 = d2 + pe
    dec_states = []
    for blk in model.dec_blocks:
        d1 = decoder_block_apply(blk, d1, d2, pos1, pos2, cfg.dec)
        dec_states.append(d1)
    dec_states[-1] = layer_norm(model.dec_norm, dec_states[-1],
                                cfg.dec.ln_eps)
    if all_blocks:
        return head_fn(enc1 + dec_states, (h, w))
    return head_fn(dec_states[-1], (h, w))


def linear_pixelwise_head(generator: Optional[torch.Generator],
                          cfg: DUSt3RConfig, num_channels: int = 1,
                          device="cuda") -> Tuple[nn.Linear, Callable]:
    """Minimal dense head: a linear projection of the final state to each
    patch's pixels, then depth-to-space, in fp32. Returns (the linear,
    head_fn)."""
    ps = cfg.patch_size
    proj = nn.Linear(cfg.dec.dim, ps * ps * num_channels)
    init_linear_(proj, generator)
    proj = proj.to(device)

    def head_fn(states, img_hw):
        x = states[-1] if isinstance(states, (list, tuple)) else states
        h, w = img_hw
        out = linear(proj, x.float())  # (B, N, ps*ps*C)
        b = out.shape[0]
        out = out.reshape(b, h // ps, w // ps, ps, ps, num_channels)
        return out.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, num_channels)

    return proj, head_fn
