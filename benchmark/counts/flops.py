"""Model FLOPs per unit of work, from the configuration file alone.

Matrix products count 2 * M * K * N; convolutions 2 * C_out * C_in * k^2
per output pixel (a transposed convolution per input pixel). LayerNorm,
softmax and elementwise work are left out (under 2% of the transformer's).
`transformer_flops_per_frame` is spann3r_torch/bench.py's formula (and the
JAX package's bench.py's); the DPT head is counted here layer by layer
instead of by a FlopCounterMode run of the program's head, so that the
count does not follow the program.
"""
from __future__ import annotations

from typing import Tuple


def tokens(cfg: dict, hw: Tuple[int, int]) -> int:
    ps = cfg["patch_size"]
    return (hw[0] // ps) * (hw[1] // ps)


def _block(n, d, ratio):
    # qkv 6ndd + proj 2ndd + attention 4nnd + MLP 4nd(ratio d)
    return 8 * n * d * d + 4 * n * n * d + 4 * n * d * int(ratio * d)


def _dec_block(n, d):
    # self: qkv + proj + attention; cross: q, k, v, proj + attention; MLP
    return 16 * n * d * d + 8 * n * n * d + 16 * n * d * d


def encoder(cfg: dict, p: int) -> float:
    e, ps = cfg["enc_embed_dim"], cfg["patch_size"]
    return 2 * p * e * ps * ps * 3 + cfg["enc_depth"] * _block(p, e, cfg["mlp_ratio"])


def decoder(cfg: dict, p: int) -> float:
    """Both decoders of one pair, with their input projections."""
    e, d = cfg["enc_embed_dim"], cfg["dec_embed_dim"]
    return 2 * 2 * p * e * d + 2 * cfg["dec_depth"] * _dec_block(p, d)


def dpt_head(cfg: dict, hw: Tuple[int, int]) -> float:
    """One DPT head on one image."""
    ps = cfg["patch_size"]
    nh, nw = hw[0] // ps, hw[1] // ps
    ld, fd, last = cfg["dpt_layer_dims"], cfg["dpt_feature_dim"], cfg["dpt_last_dim"]
    hd = [cfg["enc_embed_dim"]] + [cfg["dec_embed_dim"]] * 3
    conv = lambda co, ci, k, h, w: 2.0 * co * ci * k * k * h * w
    f = 0.0
    # act_postprocess: 1x1 projections at the patch grid, then to 4x, 2x,
    # 1x and 1/2x of it
    f += conv(ld[0], hd[0], 1, nh, nw) + conv(ld[0], ld[0], 4, nh, nw)
    f += conv(ld[1], hd[1], 1, nh, nw) + conv(ld[1], ld[1], 2, nh, nw)
    f += conv(ld[2], hd[2], 1, nh, nw)
    h3, w3 = (nh + 1) // 2, (nw + 1) // 2
    f += conv(ld[3], hd[3], 1, nh, nw) + conv(ld[3], ld[3], 3, h3, w3)
    sizes = [(4 * nh, 4 * nw), (2 * nh, 2 * nw), (nh, nw), (h3, w3)]
    for (h, w), c in zip(sizes, ld):
        f += conv(fd, c, 3, h, w)                            # layerN_rn
    # refinenet4 runs one residual unit (two 3x3 convolutions) at 1/2x, the
    # others two at their level's size; each then upsamples 2x and projects
    for units, (h, w) in zip((1, 2, 2, 2), sizes[::-1]):
        f += units * 2 * conv(fd, fd, 3, h, w) + conv(fd, fd, 1, 2 * h, 2 * w)
    h, w = 8 * nh, 8 * nw                                    # path1's size
    f += conv(fd // 2, fd, 3, h, w)
    f += conv(last, fd // 2, 3, 2 * h, 2 * w) + conv(cfg["out_channels"], last, 1,
                                                     2 * h, 2 * w)
    return f


def memory_capacity(cfg: dict, p: int) -> int:
    m = cfg["memory"]
    cap = m["long_mem_size"] + (m["work_mem_size"] + 1) * p
    return -(-cap // 128) * 128


def spann3r_extras(cfg: dict, p: int) -> float:
    """Per pair outside the backbone: value encoder with its input and
    output projections, and the two attention-head MLPs."""
    v, ps = cfg["value_enc_dim"], cfg["patch_size"]
    ain, aout = cfg["attn_head_in"], cfg["attn_head_out"]
    f = cfg["value_enc_depth"] * _block(p, v, cfg["mlp_ratio"])
    f += 2 * p * v * ps * ps * 3 + 2 * p * v * aout
    f += 2 * (2 * p * ain * ain + 2 * p * ain * aout)
    return f


def transformer_flops_per_frame(cfg: dict, hw: Tuple[int, int]) -> float:
    """One streaming step of one stream outside the head: bench.py's
    formula, the memory read at the bank's full capacity."""
    p = tokens(cfg, hw)
    return (encoder(cfg, p) + decoder(cfg, p) + spann3r_extras(cfg, p)
            + 4 * p * memory_capacity(cfg, p) * cfg["attn_head_out"])


def stream_frame(cfg: dict, hw: Tuple[int, int]) -> float:
    """Model FLOPs a streamed frame: the step and one head."""
    return transformer_flops_per_frame(cfg, hw) + dpt_head(cfg, hw)


def pairs_scene(cfg: dict, hw: Tuple[int, int], n_views: int, n_pairs: int) -> float:
    """A scene of pairwise inference: each view encoded once, each pair
    through both decoders and both heads."""
    p = tokens(cfg, hw)
    return n_views * encoder(cfg, p) + n_pairs * (decoder(cfg, p) + 2 * dpt_head(cfg, hw))
