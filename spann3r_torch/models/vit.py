"""ViT encoder and dual-decoder stacks.

Module attribute paths are the reference state-dict keys
(`enc_blocks.{i}.attn.qkv`, `dec_blocks.{i}.cross_attn.projq`, ...). The
block functions follow the JAX package's `models/vit.py`; its `lax.scan`
over depth becomes a Python loop, and the dual decoder keeps only the hook
states the heads read. `remat=True` (training only) checkpoints each block,
or each pair of decoder blocks, as the JAX package's `jax.checkpoint` of the
scan body does: the backward recomputes the block from its input.
"""
from __future__ import annotations

import functools

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import ViTConfig
from ..ops.attention import (CrossAttention, SelfAttention, cross_attention,
                             self_attention)
from ..ops.layers import Mlp, conv2d, layer_norm, mlp


class Block(nn.Module):
    """Pre-LN self-attention + MLP block."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.norm1 = nn.LayerNorm(cfg.dim, eps=cfg.ln_eps)
        self.attn = SelfAttention(cfg.dim, cfg.qkv_bias)
        self.norm2 = nn.LayerNorm(cfg.dim, eps=cfg.ln_eps)
        self.mlp = Mlp(cfg.dim, int(cfg.dim * cfg.mlp_ratio))


class DecoderBlock(nn.Module):
    """Self-attention -> cross-attention on the normed other stream -> MLP."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.norm1 = nn.LayerNorm(cfg.dim, eps=cfg.ln_eps)
        self.attn = SelfAttention(cfg.dim, cfg.qkv_bias)
        self.norm2 = nn.LayerNorm(cfg.dim, eps=cfg.ln_eps)
        self.mlp = Mlp(cfg.dim, int(cfg.dim * cfg.mlp_ratio))
        self.cross_attn = CrossAttention(cfg.dim, cfg.qkv_bias)
        self.norm3 = nn.LayerNorm(cfg.dim, eps=cfg.ln_eps)
        self.norm_y = nn.LayerNorm(cfg.dim, eps=cfg.ln_eps)


def block_apply(m: Block, x: torch.Tensor, pos: Optional[torch.Tensor],
                cfg: ViTConfig) -> torch.Tensor:
    x = x + self_attention(m.attn, layer_norm(m.norm1, x, cfg.ln_eps), pos,
                           cfg.num_heads, cfg.rope_base)
    return x + mlp(m.mlp, layer_norm(m.norm2, x, cfg.ln_eps))


def decoder_block_apply(m: DecoderBlock, x: torch.Tensor, y: torch.Tensor,
                        xpos: Optional[torch.Tensor],
                        ypos: Optional[torch.Tensor],
                        cfg: ViTConfig) -> torch.Tensor:
    x = x + self_attention(m.attn, layer_norm(m.norm1, x, cfg.ln_eps), xpos,
                           cfg.num_heads, cfg.rope_base)
    y_ = layer_norm(m.norm_y, y, cfg.ln_eps)
    x = x + cross_attention(m.cross_attn, layer_norm(m.norm2, x, cfg.ln_eps),
                            y_, y_, xpos, ypos, cfg.num_heads, cfg.rope_base)
    return x + mlp(m.mlp, layer_norm(m.norm3, x, cfg.ln_eps))


def rematerialised(fn, *args):
    """fn(*args), its activations recomputed in the backward instead of
    kept (`torch.utils.checkpoint`, non-reentrant). Nothing inside draws
    from the global RNG (memory dropout takes a mask drawn outside), so its
    state is not saved."""
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def encoder_apply(blocks: Sequence[Block], x: torch.Tensor,
                  pos: Optional[torch.Tensor], cfg: ViTConfig,
                  remat: bool = False) -> torch.Tensor:
    for blk in blocks:
        if remat:
            x = rematerialised(functools.partial(block_apply, blk, cfg=cfg),
                               x, pos)
        else:
            x = block_apply(blk, x, pos, cfg)
    return x


def _decoder_pair(b1: DecoderBlock, b2: DecoderBlock, c1: torch.Tensor,
                  c2: torch.Tensor, pos1, pos2, cfg: ViTConfig):
    return (decoder_block_apply(b1, c1, c2, pos1, pos2, cfg),
            decoder_block_apply(b2, c2, c1, pos2, pos1, cfg))


def dual_decoder_apply(blocks1: Sequence[DecoderBlock],
                       blocks2: Sequence[DecoderBlock], f1: torch.Tensor,
                       f2: torch.Tensor, pos1, pos2, cfg: ViTConfig,
                       hooks: Tuple[int, ...], remat: bool = False
                       ) -> Dict[int, Tuple[torch.Tensor, torch.Tensor]]:
    """Each block, the two streams attend to the other stream's previous
    output. Returns {block index (1-based): (y1, y2)} for the hook indices
    only."""
    out = {}
    c1, c2 = f1, f2
    for i, (b1, b2) in enumerate(zip(blocks1, blocks2), start=1):
        if remat:
            c1, c2 = rematerialised(
                functools.partial(_decoder_pair, b1, b2, cfg=cfg),
                c1, c2, pos1, pos2)
        else:
            c1, c2 = _decoder_pair(b1, b2, c1, c2, pos1, pos2, cfg)
        if i in hooks:
            out[i] = (c1, c2)
    return out


def patch_positions(h_patches: int, w_patches: int,
                    device=None) -> torch.Tensor:
    """(N, 2) int32 (y, x) positions, row-major."""
    ys, xs = torch.meshgrid(
        torch.arange(h_patches, dtype=torch.int32, device=device),
        torch.arange(w_patches, dtype=torch.int32, device=device),
        indexing="ij")
    return torch.stack([ys, xs], dim=-1).reshape(-1, 2)


class PatchEmbed(nn.Module):
    """k = s = patch_size convolution (key `proj`)."""

    def __init__(self, patch_size: int, in_chans: int, dim: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_chans, dim, patch_size, stride=patch_size)


def patch_embed_apply(m: PatchEmbed, img: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """img (B, H, W, C) NHWC -> tokens (B, N, D), positions (B, N, 2)."""
    b, h, w, _ = img.shape
    ps = m.patch_size
    if h % ps or w % ps:
        raise ValueError(f"image {h}x{w} is not a multiple of {ps}")
    x = conv2d(m.proj, img.permute(0, 3, 1, 2), stride=ps)  # (B, D, hp, wp)
    tokens = x.flatten(2).transpose(1, 2)
    pos = patch_positions(h // ps, w // ps, img.device)
    return tokens, pos[None].expand(b, -1, -1)
