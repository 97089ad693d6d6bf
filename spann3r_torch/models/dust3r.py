"""Two-view pointmap backbone: patch embed, ViT encoder, dual decoder and
the two pointmap heads (module keys `patch_embed`, `enc_blocks.{i}`,
`enc_norm`, `decoder_embed`, `dec_blocks.{i}`, `dec_blocks2.{i}`,
`dec_norm`, `downstream_head1`, `downstream_head2`), and the two-view
forward that pairwise inference runs."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..config import BF16, DUSt3RConfig, Precision
from ..ops.layers import init_conv_, init_modules_, layer_norm, linear
from .heads import head_apply, make_head
from .vit import (Block, DecoderBlock, PatchEmbed, dual_decoder_apply,
                  encoder_apply, patch_embed_apply)


class DUSt3R(nn.Module):
    def __init__(self, cfg: DUSt3RConfig):
        super().__init__()
        self.patch_embed = PatchEmbed(cfg.patch_size, 3, cfg.enc.dim)
        self.enc_blocks = nn.ModuleList(Block(cfg.enc) for _ in range(cfg.enc.depth))
        self.enc_norm = nn.LayerNorm(cfg.enc.dim, eps=cfg.enc.ln_eps)
        self.decoder_embed = nn.Linear(cfg.enc.dim, cfg.dec.dim)
        self.dec_blocks = nn.ModuleList(DecoderBlock(cfg.dec)
                                        for _ in range(cfg.dec.depth))
        self.dec_blocks2 = nn.ModuleList(DecoderBlock(cfg.dec)
                                         for _ in range(cfg.dec.depth))
        self.dec_norm = nn.LayerNorm(cfg.dec.dim, eps=cfg.dec.ln_eps)
        self.downstream_head1 = make_head(cfg)
        self.downstream_head2 = make_head(cfg)

    def init_weights_(self, generator: Optional[torch.Generator]) -> None:
        for name, child in self.named_children():
            if name.startswith("downstream_head"):
                child.init_weights_(generator)
            elif name == "patch_embed":
                init_conv_(child.proj, generator, xavier_flat=True)
            else:
                init_modules_(child, generator)


def encode_image(m: DUSt3R, img: torch.Tensor, cfg: DUSt3RConfig,
                 prec: Precision = BF16) -> Tuple[torch.Tensor, torch.Tensor]:
    """img (B, H, W, 3) normalised NHWC -> tokens (B, N, D), pos (B, N, 2)."""
    x, pos = patch_embed_apply(m.patch_embed, img.to(prec.compute_dtype))
    x = encoder_apply(m.enc_blocks, x, pos, cfg.enc)
    return layer_norm(m.enc_norm, x, cfg.enc.ln_eps), pos


def head_hooks(cfg: DUSt3RConfig) -> Tuple[int, ...]:
    """1-based decoder-block indices whose outputs the head reads."""
    if cfg.head_type == "dpt":
        need = {h for h in cfg.dpt_hooks if h >= 1} | {cfg.dec.depth}
    else:
        need = {cfg.dec.depth}
    return tuple(sorted(need))


def states_from_hooks(cfg: DUSt3RConfig, packed) -> list:
    """Expand a packed (state0, *hook_states) sequence into the 1 + depth
    list `downstream_head` expects, None where the head never reads."""
    states: list = [packed[0]] + [None] * cfg.dec.depth
    for h, s in zip(head_hooks(cfg), packed[1:]):
        states[h] = s
    return states


def decoder(m: DUSt3R, f1: torch.Tensor, pos1: torch.Tensor,
            f2: torch.Tensor, pos2: torch.Tensor, cfg: DUSt3RConfig,
            prec: Precision = BF16) -> Tuple[List, List]:
    """Dual cross-attending decoder. Returns two lists of 1 + depth states:
    the encoder features, then block outputs at the hook indices (None
    elsewhere), the last one normed."""
    f1 = f1.to(prec.compute_dtype)
    f2 = f2.to(prec.compute_dtype)
    p1 = linear(m.decoder_embed, f1)
    p2 = linear(m.decoder_embed, f2)
    ys = dual_decoder_apply(m.dec_blocks, m.dec_blocks2, p1, p2, pos1, pos2,
                            cfg.dec, head_hooks(cfg))
    out1: List = [f1] + [None] * cfg.dec.depth
    out2: List = [f2] + [None] * cfg.dec.depth
    for h, (y1, y2) in ys.items():
        out1[h], out2[h] = y1, y2
    out1[-1] = layer_norm(m.dec_norm, out1[-1], cfg.dec.ln_eps)
    out2[-1] = layer_norm(m.dec_norm, out2[-1], cfg.dec.ln_eps)
    return out1, out2


def downstream_head(m: DUSt3R, head_num: int, dec_states: List,
                    img_hw: Tuple[int, int], cfg: DUSt3RConfig,
                    prec: Optional[Precision] = None) -> Dict[str, torch.Tensor]:
    """The head runs in prec.head_dtype (fp32 by default); outputs fp32."""
    dt = torch.float32 if prec is None else prec.head_dtype
    states = [None if s is None else s.to(dt) for s in dec_states]
    out = head_apply(getattr(m, f"downstream_head{head_num}"), states, img_hw,
                     cfg)
    return {k: v.float() for k, v in out.items()}


@torch.no_grad()
def forward(m: DUSt3R, img1: torch.Tensor, img2: torch.Tensor,
            cfg: DUSt3RConfig, prec: Precision = BF16
            ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Two-view forward: img1, img2 (B, H, W, 3) normalised NHWC ->
    (res1 {'pts3d', 'conf'}, res2 {'pts3d_in_other_view', 'conf'}), res2's
    pointmap in view 1's frame. Views of one shape go through the encoder
    in one batch; views of different shapes are encoded separately."""
    hw, hw2 = tuple(img1.shape[1:3]), tuple(img2.shape[1:3])
    b = img1.shape[0]
    if hw == hw2:
        feats, pos = encode_image(m, torch.cat([img1, img2]), cfg, prec)
        f1, f2, pos1, pos2 = feats[:b], feats[b:], pos[:b], pos[b:]
    else:
        f1, pos1 = encode_image(m, img1, cfg, prec)
        f2, pos2 = encode_image(m, img2, cfg, prec)
    dec1, dec2 = decoder(m, f1, pos1, f2, pos2, cfg, prec)
    res1 = downstream_head(m, 1, dec1, hw, cfg, prec)
    res2 = downstream_head(m, 2, dec2, hw2, cfg, prec)
    res2["pts3d_in_other_view"] = res2.pop("pts3d")
    return res1, res2
