"""Random weights from the seed, named by the published checkpoints' keys.

`spec(cfg)` lists every tensor of the configuration (name, shape, rule)
from the configuration file alone. `generate(cfg, seed, device)` draws
them on the device in one call of a seeded `torch.Generator` and scales
each slice by its rule: xavier-uniform weights (fan in and fan out of a
convolution counted over its kernel, the patch embeddings' fan out over
the output channels only), zero biases, unit LayerNorm scales, and the
DPT heads' last projection scaled by 0.01 so that the 'exp' depth mode's
expm1 stays finite on random weights. The same seed gives the same
weights on every device of one kind. The program and the reference are
both handed these tensors.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from benchmark import find

Spec = List[Tuple[str, Tuple[int, ...], str]]


def _linear(name, d_out, d_in, bias=True) -> Spec:
    out = [(name + ".weight", (d_out, d_in), "xavier")]
    return out + ([(name + ".bias", (d_out,), "zero")] if bias else [])


def _ln(name, d) -> Spec:
    return [(name + ".weight", (d,), "one"), (name + ".bias", (d,), "zero")]


def _conv(name, c_out, c_in, k, bias=True, rule="conv") -> Spec:
    out = [(name + ".weight", (c_out, c_in, k, k), rule)]
    return out + ([(name + ".bias", (c_out,), "zero")] if bias else [])


def _block(name, d, ratio=4) -> Spec:
    return (_ln(name + ".norm1", d) + _linear(name + ".attn.qkv", 3 * d, d)
            + _linear(name + ".attn.proj", d, d) + _ln(name + ".norm2", d)
            + _linear(name + ".mlp.fc1", ratio * d, d)
            + _linear(name + ".mlp.fc2", d, ratio * d))


def _dec_block(name, d) -> Spec:
    return (_block(name, d)
            + sum((_linear(f"{name}.cross_attn.proj{x}", d, d)
                   for x in ("q", "k", "v", "")), [])
            + _ln(name + ".norm3", d) + _ln(name + ".norm_y", d))


def _dpt(name, cfg) -> Spec:
    ld, fd = cfg["dpt_layer_dims"], cfg["dpt_feature_dim"]
    hd = [cfg["enc_embed_dim"]] + [cfg["dec_embed_dim"]] * 3
    ap = name + ".act_postprocess"
    s = (_conv(ap + ".0.0", ld[0], hd[0], 1)
         + [(ap + ".0.1.weight", (ld[0], ld[0], 4, 4), "conv_t"),
            (ap + ".0.1.bias", (ld[0],), "zero")]
         + _conv(ap + ".1.0", ld[1], hd[1], 1)
         + [(ap + ".1.1.weight", (ld[1], ld[1], 2, 2), "conv_t"),
            (ap + ".1.1.bias", (ld[1],), "zero")]
         + _conv(ap + ".2.0", ld[2], hd[2], 1)
         + _conv(ap + ".3.0", ld[3], hd[3], 1) + _conv(ap + ".3.1", ld[3], ld[3], 3))
    sc = name + ".scratch"
    for i in range(4):
        s += _conv(f"{sc}.layer{i + 1}_rn", fd, ld[i], 3, bias=False)
    for i in range(4):
        r = f"{sc}.refinenet{i + 1}"
        for u in (1, 2):
            for c in (1, 2):
                s += _conv(f"{r}.resConfUnit{u}.conv{c}", fd, fd, 3)
        s += _conv(r + ".out_conv", fd, fd, 1)
    return (s + _conv(name + ".head.0", fd // 2, fd, 3)
            + _conv(name + ".head.2", cfg["dpt_last_dim"], fd // 2, 3)
            + _conv(name + ".head.4", cfg["out_channels"], cfg["dpt_last_dim"], 1,
                    rule="conv_damped"))


def dust3r_spec(cfg, prefix="") -> Spec:
    e, d, ps = cfg["enc_embed_dim"], cfg["dec_embed_dim"], cfg["patch_size"]
    s = _conv(prefix + "patch_embed.proj", e, 3, ps, rule="conv_flat")
    for i in range(cfg["enc_depth"]):
        s += _block(f"{prefix}enc_blocks.{i}", e)
    s += _ln(prefix + "enc_norm", e) + _linear(prefix + "decoder_embed", d, e)
    for side in ("dec_blocks", "dec_blocks2"):
        for i in range(cfg["dec_depth"]):
            s += _dec_block(f"{prefix}{side}.{i}", d)
    s += _ln(prefix + "dec_norm", d)
    for h in (1, 2):
        s += _dpt(f"{prefix}downstream_head{h}.dpt", cfg)
    return s


def spec(cfg: dict) -> Spec:
    """Every tensor of the model the configuration describes: its kind's
    list (benchmark/models/<model>.py)."""
    return find("models", cfg["model"]).spec(cfg)


def _limit(shape, rule) -> float:
    if len(shape) == 2:
        fan_in, fan_out = shape[1], shape[0]
    else:
        k = shape[2] * shape[3]
        c_out, c_in = (shape[1], shape[0]) if rule == "conv_t" else shape[:2]
        fan_in = k * c_in
        fan_out = c_out if rule == "conv_flat" else k * c_out
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    return lim * 0.01 if rule == "conv_damped" else lim


@torch.no_grad()
def generate(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: fp32 tensor} on `device`: the random tensors are views of
    one buffer drawn by a single call."""
    sp = spec(cfg)
    n_rand = sum(math.prod(s) for _, s, r in sp if r not in ("zero", "one"))
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(n_rand, generator=g, device=device)
    out, off = {}, 0
    for name, shape, rule in sp:
        if rule == "zero":
            out[name] = torch.zeros(shape, device=device)
        elif rule == "one":
            out[name] = torch.ones(shape, device=device)
        else:
            n = math.prod(shape)
            lim = _limit(shape, rule)
            out[name] = flat[off:off + n].view(shape).mul_(2 * lim).sub_(lim)
            off += n
    return out


def n_params(cfg: dict) -> int:
    return sum(math.prod(s) for _, s, _ in spec(cfg))
