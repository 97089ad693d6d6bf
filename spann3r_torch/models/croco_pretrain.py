"""CroCo masked cross-view completion (the JAX package's
models/croco_pretrain.py, after the reference's croco/models/croco.py).

Mask most of image 1, encode its visible patches, cross-attend a decoder
over the whole of image 2, and regress the masked RGB patches (MaskedMSE).
`random_mask` masks exactly int(ratio * N) tokens a row, so the visible
width is the same for every row: the visible tokens are gathered into a
(B, N_vis, D) tensor, encoded, and scattered back over the mask token
before the decoder. The attention runs through `ops.attention` (K2 and its
backward on the card) and, with `pos_embed='RoPE100'`, `ops.rope` (K3); the
cosine mode adds fixed sin-cos tables at the encoder and decoder inputs.
The CroCoNet() default has a decoder 512 wide with 16 heads: head dim 32.

The CroCoNet keyword mapping (`cfg_from_croco_kwargs`,
`croco_kwargs_from_cfg`) and the safe model-string parser
(`parse_croco_model`) are here too.
"""
from __future__ import annotations

import ast
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import BF16, DUSt3RConfig, Precision, ViTConfig
from ..ops.layers import init_modules_, init_conv_, layer_norm, linear
from .vit import (Block, DecoderBlock, PatchEmbed, decoder_block_apply,
                  encoder_apply, patch_embed_apply)


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

def cfg_from_croco_kwargs(kw: Dict, img_size) -> DUSt3RConfig:
    """CroCoNet constructor keywords -> DUSt3RConfig (the reference's
    croco.py:23-37 defaults: encoder 12 x 768 / 12 heads, decoder 8 x 512 /
    16 heads, patch 16, cosine positions). Callers pop their own keys
    (img_size, mask_ratio) first; an unknown keyword raises."""
    kw = dict(kw)
    pos = kw.pop("pos_embed", "cosine")
    rope = 100.0 if str(pos).startswith("RoPE") else 0.0
    cfg = DUSt3RConfig(
        img_size=tuple(img_size),
        patch_size=kw.pop("patch_size", 16),
        enc=ViTConfig(dim=kw.pop("enc_embed_dim", 768),
                      depth=kw.pop("enc_depth", 12),
                      num_heads=kw.pop("enc_num_heads", 12),
                      rope_base=rope),
        dec=ViTConfig(dim=kw.pop("dec_embed_dim", 512),
                      depth=kw.pop("dec_depth", 8),
                      num_heads=kw.pop("dec_num_heads", 16),
                      rope_base=rope),
    )
    if kw:
        raise ValueError(f"unsupported CroCoNet kwargs: {sorted(kw)}")
    return cfg


def croco_kwargs_from_cfg(cfg: DUSt3RConfig) -> Dict:
    """Inverse of cfg_from_croco_kwargs (architecture keys only)."""
    return {"enc_embed_dim": cfg.enc.dim, "enc_depth": cfg.enc.depth,
            "enc_num_heads": cfg.enc.num_heads,
            "dec_embed_dim": cfg.dec.dim, "dec_depth": cfg.dec.depth,
            "dec_num_heads": cfg.dec.num_heads,
            "patch_size": cfg.patch_size,
            "pos_embed": "RoPE100" if cfg.enc.rope_base > 0 else "cosine"}


def parse_croco_model(model_str: str) -> Tuple[DUSt3RConfig, float]:
    """'CroCoNet(k=v, ...)' -> (DUSt3RConfig, mask_ratio), keyword literals
    only, nothing evaluated (the reference eval()s the string,
    croco/pretrain.py:122)."""
    node = ast.parse(model_str, mode="eval").body
    if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id == "CroCoNet" and not node.args):
        raise ValueError(f"expected 'CroCoNet(<kwargs>)', got {model_str!r}")
    kw = {k.arg: ast.literal_eval(k.value) for k in node.keywords}
    img_size = kw.pop("img_size", 224)
    if isinstance(img_size, int):
        img_size = (img_size, img_size)
    mask_ratio = kw.pop("mask_ratio", 0.9)
    return cfg_from_croco_kwargs(kw, img_size), float(mask_ratio)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class CroCoNet(nn.Module):
    """Shared encoder, one cross-attending decoder, mask token and a linear
    RGB prediction head (ref croco.py:39-108); parameter names are the
    reference checkpoint's."""

    def __init__(self, cfg: DUSt3RConfig):
        super().__init__()
        self.cfg = cfg
        ps = cfg.patch_size
        self.patch_embed = PatchEmbed(ps, 3, cfg.enc.dim)
        self.enc_blocks = nn.ModuleList(Block(cfg.enc)
                                        for _ in range(cfg.enc.depth))
        self.enc_norm = nn.LayerNorm(cfg.enc.dim, eps=cfg.enc.ln_eps)
        self.decoder_embed = nn.Linear(cfg.enc.dim, cfg.dec.dim)
        self.dec_blocks = nn.ModuleList(DecoderBlock(cfg.dec)
                                        for _ in range(cfg.dec.depth))
        self.dec_norm = nn.LayerNorm(cfg.dec.dim, eps=cfg.dec.ln_eps)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, cfg.dec.dim))
        self.prediction_head = nn.Linear(cfg.dec.dim, ps * ps * 3)


def build_croco(cfg: DUSt3RConfig, device="cuda",
                generator: Optional[torch.Generator] = None) -> CroCoNet:
    """A CroCoNet on `device` with the JAX package's initialisation rules
    (xavier-uniform linears and patch embedding, zero biases, unit
    LayerNorms, mask token N(0, 0.02)) from `generator`."""
    model = CroCoNet(cfg)
    init_modules_(model, generator)
    init_conv_(model.patch_embed.proj, generator, xavier_flat=True)
    with torch.no_grad():
        model.mask_token.normal_(0.0, 0.02, generator=generator)
    return model.to(device)


def random_mask(generator: Optional[torch.Generator], batch: int,
                num_patches: int, mask_ratio: float, device=None
                ) -> torch.Tensor:
    """(B, N) bool with exactly int(ratio * N) True a row: the ranks of
    uniform noise below the count (ref masking.py:12-25)."""
    num_mask = int(mask_ratio * num_patches)
    noise = torch.rand((batch, num_patches), generator=generator,
                       device=device)
    return torch.argsort(torch.argsort(noise, dim=1), dim=1) < num_mask


def patchify(imgs: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(B, H, W, 3) -> (B, N, ps*ps*3) in the reference's channel-last
    per-patch layout (ref croco.py:203-216)."""
    b, h, w, c = imgs.shape
    p = patch_size
    x = imgs.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def unpatchify(x: torch.Tensor, patch_size: int, h: int, w: int
               ) -> torch.Tensor:
    """(B, N, ps*ps*C) -> (B, h, w, C), the inverse of patchify."""
    b, n, d = x.shape
    p = patch_size
    gh, gw = h // p, w // p
    if n != gh * gw:
        raise ValueError(f"{n} patches do not tile {h}x{w} at {p}")
    c = d // (p * p)
    x = x.reshape(b, gh, gw, p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def get_1d_sincos_pos_embed(embed_dim: int, pos) -> np.ndarray:
    if embed_dim % 2:
        raise ValueError(f"odd embedding width {embed_dim}")
    omega = np.arange(embed_dim // 2, dtype=float) / (embed_dim / 2.0)
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", np.asarray(pos).reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed(embed_dim: int, grid_size) -> torch.Tensor:
    """(gh*gw, D) fp32 sin-cos table of the cosine mode (the JAX package's
    models/vit.py; ref croco/models/pos_embed.py). grid_size: int (square)
    or (gh, gw)."""
    gh, gw = ((grid_size, grid_size) if isinstance(grid_size, int)
              else grid_size)
    grid = np.stack(np.meshgrid(np.arange(gw, dtype=np.float32),
                                np.arange(gh, dtype=np.float32)), axis=0)
    emb = np.concatenate([get_1d_sincos_pos_embed(embed_dim // 2, grid[0]),
                          get_1d_sincos_pos_embed(embed_dim // 2, grid[1])],
                         axis=1)
    return torch.from_numpy(emb.astype(np.float32))


def _check_mask(mask: torch.Tensor, n_patches: int, n_vis: int,
                mask_ratio: float) -> None:
    """The mask carries the count that mask_ratio implies on every row: the
    visible width is taken from mask_ratio, so a mask of another ratio
    would gather the wrong tokens. A host read of the row counts."""
    counts = mask.sum(dim=1).cpu()
    if not bool((counts == n_patches - n_vis).all()):
        raise ValueError(
            f"mask rows carry {sorted(set(counts.tolist()))} masked tokens "
            f"but mask_ratio={mask_ratio} implies {n_patches - n_vis}; build "
            f"the mask with random_mask(..., mask_ratio) matching this "
            f"argument")


def croco_forward(model: CroCoNet, img1: torch.Tensor, img2: torch.Tensor,
                  mask: torch.Tensor, mask_ratio: float = 0.9,
                  prec: Precision = BF16, check_mask: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Masked cross-view completion (ref croco.py:231-249). img1, img2
    (B, H, W, 3); mask (B, N) bool from random_mask(mask_ratio). Returns
    (pred (B, N, ps*ps*3) fp32, mask, target): the loss takes the masked
    patches. `check_mask` holds the mask's row counts to mask_ratio, a
    host read that waits for the mask."""
    cfg = model.cfg
    b, h, w, _ = img1.shape
    n_patches = int(mask.shape[1])
    n_vis = n_patches - int(mask_ratio * n_patches)
    if check_mask:
        _check_mask(mask, n_patches, n_vis, mask_ratio)
    dt = prec.compute_dtype

    # the cosine mode (CroCoNet's default, ref croco.py:48-59): sin-cos
    # tables added at the encoder and decoder inputs; none with RoPE
    use_cosine = cfg.enc.rope_base <= 0
    if use_cosine:
        gh, gw = h // cfg.patch_size, w // cfg.patch_size
        if gh != gw:
            raise ValueError("the cosine pos_embed assumes a square patch "
                             f"grid (ref croco.py:50); got {gh}x{gw}: use "
                             "pos_embed='RoPE100'")
        enc_pe = get_2d_sincos_pos_embed(cfg.enc.dim, gh)[None].to(img1.device)
        dec_pe = get_2d_sincos_pos_embed(cfg.dec.dim, gh)[None].to(img1.device)

    # the visible patches of img1, gathered to a fixed width: a stable sort
    # of the mask puts the visible (False) tokens first, in order
    x1, pos = patch_embed_apply(model.patch_embed, img1.to(dt))
    if use_cosine:
        x1 = x1 + enc_pe.to(x1.dtype)
    order = torch.argsort(mask.to(torch.int32), dim=1, stable=True)
    vis_idx = order[:, :n_vis]
    x1_vis = torch.take_along_dim(x1, vis_idx[..., None], dim=1)
    pos_vis = torch.take_along_dim(pos, vis_idx[..., None], dim=1)
    f1 = encoder_apply(model.enc_blocks, x1_vis, pos_vis, cfg.enc)
    f1 = layer_norm(model.enc_norm, f1, cfg.enc.ln_eps)

    x2, pos2 = patch_embed_apply(model.patch_embed, img2.to(dt))
    if use_cosine:
        x2 = x2 + enc_pe.to(x2.dtype)
    f2 = encoder_apply(model.enc_blocks, x2, pos2, cfg.enc)
    f2 = layer_norm(model.enc_norm, f2, cfg.enc.ln_eps)

    # the decoder: the visible tokens scattered over mask tokens
    # (ref croco.py:166-201), the positions added after the scatter
    d1_vis = linear(model.decoder_embed, f1)
    d2 = linear(model.decoder_embed, f2)
    full = model.mask_token.to(d1_vis.dtype).expand(b, n_patches,
                                                     d1_vis.shape[-1])
    d1 = full.scatter(1, vis_idx[..., None].expand(-1, -1, d1_vis.shape[-1]),
                      d1_vis)
    if use_cosine:
        d1 = d1 + dec_pe.to(d1.dtype)
        d2 = d2 + dec_pe.to(d2.dtype)
    for blk in model.dec_blocks:
        d1 = decoder_block_apply(blk, d1, d2, pos, pos2, cfg.dec)
    out = layer_norm(model.dec_norm, d1, cfg.dec.ln_eps)

    pred = linear(model.prediction_head, out.float())
    return pred, mask, patchify(img1, cfg.patch_size)


def masked_mse(pred: torch.Tensor, mask: torch.Tensor, target: torch.Tensor,
               norm_pix_loss: bool = False, masked: bool = True
               ) -> torch.Tensor:
    """MaskedMSE (ref croco/models/criterion.py:14-36): per-patch MSE,
    averaged over the masked patches; `norm_pix_loss` normalises each
    target patch by its own mean and variance first."""
    target = target.float()
    if norm_pix_loss:
        mean = target.mean(dim=-1, keepdim=True)
        var = target.var(dim=-1, keepdim=True, unbiased=False)
        target = (target - mean) / torch.sqrt(var + 1e-6)
    loss = torch.square(pred - target).mean(dim=-1)
    if masked:
        m = mask.to(loss.dtype)
        return (loss * m).sum() / m.sum().clamp(min=1e-8)
    return loss.mean()
