"""Two-view pointmap backbone: patch embed, ViT encoder, dual decoder and
the two pointmap heads (module keys `patch_embed`, `enc_blocks.{i}`,
`enc_norm`, `decoder_embed`, `dec_blocks.{i}`, `dec_blocks2.{i}`,
`dec_norm`, `downstream_head1`, `downstream_head2`), the two-view
forward that pairwise inference runs, and `forward_mixed` for batches of
portrait and landscape pairs."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..config import BF16, DUSt3RConfig, Precision
from ..ops.layers import init_conv_, init_modules_, layer_norm, linear
from ..utils.graphs import LayerGraphs, graphed
from ..utils.trace import span
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
                 prec: Precision = BF16, remat: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """img (B, H, W, 3) normalised NHWC -> tokens (B, N, D), pos (B, N, 2).
    remat: recompute each block in the backward (training)."""
    with span("spann3r.encode"):
        return encode_tokens(m, img, cfg, prec, remat)


def encode_tokens(m: DUSt3R, img: torch.Tensor, cfg: DUSt3RConfig,
                  prec: Precision = BF16, remat: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`encode_image` outside its span, for a caller that opens the span
    itself around more work."""
    x, pos = patch_embed_apply(m.patch_embed, img.to(prec.compute_dtype))
    x = encoder_apply(m.enc_blocks, x, pos, cfg.enc, remat)
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
            prec: Precision = BF16, remat: bool = False,
            graphs: Optional[LayerGraphs] = None) -> Tuple[List, List]:
    """Dual cross-attending decoder. Returns two lists of 1 + depth states:
    the encoder features, then block outputs at the hook indices (None
    elsewhere), the last one normed. remat: recompute each pair of blocks
    in the backward (training). graphs: replay the decoders as a CUDA
    graph from these (`utils.graphs`)."""
    with span("spann3r.decode"):
        return graphed(graphs, "decode", _decoders, m, f1, pos1, f2, pos2,
                       cfg, prec, remat)


def _decoders(m: DUSt3R, f1, pos1, f2, pos2, cfg: DUSt3RConfig,
              prec: Precision, remat: bool) -> Tuple[List, List]:
    f1 = f1.to(prec.compute_dtype)
    f2 = f2.to(prec.compute_dtype)
    p1 = linear(m.decoder_embed, f1)
    p2 = linear(m.decoder_embed, f2)
    ys = dual_decoder_apply(m.dec_blocks, m.dec_blocks2, p1, p2, pos1,
                            pos2, cfg.dec, head_hooks(cfg), remat)
    out1: List = [f1] + [None] * cfg.dec.depth
    out2: List = [f2] + [None] * cfg.dec.depth
    for h, (y1, y2) in ys.items():
        out1[h], out2[h] = y1, y2
    out1[-1] = layer_norm(m.dec_norm, out1[-1], cfg.dec.ln_eps)
    out2[-1] = layer_norm(m.dec_norm, out2[-1], cfg.dec.ln_eps)
    return out1, out2


def downstream_head(m: DUSt3R, head_num: int, dec_states: List,
                    img_hw: Tuple[int, int], cfg: DUSt3RConfig,
                    prec: Optional[Precision] = None,
                    graphs: Optional[LayerGraphs] = None
                    ) -> Dict[str, torch.Tensor]:
    """The head runs in prec.head_dtype (fp32 by default); outputs fp32.
    graphs: replay the head as a CUDA graph from these (`utils.graphs`)."""
    dt = torch.float32 if prec is None else prec.head_dtype
    with span("spann3r.head"):
        return graphed(graphs, f"head{head_num}", _head, m, head_num,
                       dec_states, img_hw, cfg, dt)


def _head(m: DUSt3R, head_num: int, dec_states: List,
          img_hw: Tuple[int, int], cfg: DUSt3RConfig,
          dt: torch.dtype) -> Dict[str, torch.Tensor]:
    states = [None if s is None else s.to(dt) for s in dec_states]
    out = head_apply(getattr(m, f"downstream_head{head_num}"), states,
                     img_hw, cfg)
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


def forward_mixed(m: DUSt3R, img1, img2, true_shape1, true_shape2,
                  cfg: DUSt3RConfig, prec: Precision = BF16
                  ) -> Tuple[Dict, Dict]:
    """Mixed portrait/landscape batches (ref ManyAR_PatchEmbed +
    transpose_to_landscape, dust3r/utils/misc.py:54-96), as the JAX
    package's `forward_mixed`: the pairs are grouped by (portrait1,
    portrait2), at most four groups; a portrait view is transposed to
    landscape, run through `forward` with its group, and its outputs
    transposed back.

    img1/img2: (B, H, W, 3) numpy with W >= H (portrait content pre-rotated
    by the data pipeline); true_shape*: (B, 2) int (h, w) actual shapes.
    Returns (res1, res2) of stacked fp32 numpy arrays, one row per pair."""
    import numpy as np

    img1, img2 = np.asarray(img1), np.asarray(img2)
    land1 = np.asarray(true_shape1)[:, 1] >= np.asarray(true_shape1)[:, 0]
    land2 = np.asarray(true_shape2)[:, 1] >= np.asarray(true_shape2)[:, 0]
    dev = next(m.parameters()).device
    res1_out: list = [None] * img1.shape[0]
    res2_out: list = [None] * img1.shape[0]
    for p1 in (False, True):
        for p2 in (False, True):
            sel = np.nonzero((land1 != p1) & (land2 != p2))[0]
            if len(sel) == 0:
                continue
            a1 = img1[sel].swapaxes(1, 2) if p1 else img1[sel]
            a2 = img2[sel].swapaxes(1, 2) if p2 else img2[sel]
            r1, r2 = forward(m, torch.from_numpy(np.ascontiguousarray(a1)).to(dev),
                             torch.from_numpy(np.ascontiguousarray(a2)).to(dev),
                             cfg, prec)
            r1 = {k: v.cpu().numpy() for k, v in r1.items()}
            r2 = {k: v.cpu().numpy() for k, v in r2.items()}
            if p1:
                r1 = {k: v.swapaxes(1, 2) for k, v in r1.items()}
            if p2:
                r2 = {k: v.swapaxes(1, 2) for k, v in r2.items()}
            for n, bi in enumerate(sel):
                res1_out[bi] = {k: v[n] for k, v in r1.items()}
                res2_out[bi] = {k: v[n] for k, v in r2.items()}
    stack = lambda lst: {k: np.stack([d[k] for d in lst]) for k in lst[0]}
    return stack(res1_out), stack(res2_out)
