"""Spann3R (`"model": "spann3r"`): DUSt3R's backbone (benchmark/models/
dust3r.py) under `dust3r.`, with the spatial memory's value encoder, key
heads and memory settings, as the program's `models.spann3r.Spann3R`."""
from __future__ import annotations

from benchmark import common
from benchmark import weights as bw
from benchmark.models import dust3r
from benchmark.reference import model as rm

NARROW = dict(dust3r.NARROW, value_enc_dim=64, value_enc_depth=1, value_enc_heads=1,
              attn_head_in=128, attn_head_out=64)


def spec(cfg: dict) -> bw.Spec:
    v, ain, aout = cfg["value_enc_dim"], cfg["attn_head_in"], cfg["attn_head_out"]
    s = bw.dust3r_spec(cfg, "dust3r.")
    for i in range(cfg["value_enc_depth"]):
        s += bw._block(f"value_encoder.{i}", v)
    s += bw._ln("value_norm", v) + bw._linear("value_out", aout, v)
    for n in ("norm_q", "norm_k", "norm_v"):
        s += bw._ln(n, aout)
    for h in (1, 2):
        s += (bw._linear(f"attn_head_{h}.0", ain, ain)
              + bw._linear(f"attn_head_{h}.2", aout, ain))
    return s + bw._conv("pos_patch_embed.proj", v, 3, cfg["patch_size"], rule="conv_flat")


def port_config(cfg: dict):
    """(Spann3RConfig, Precision) of the program."""
    from spann3r_torch.config import MemoryConfig, Spann3RConfig
    d, prec = dust3r.port_config(cfg)
    m = cfg["memory"]
    s = Spann3RConfig(
        dust3r=d,
        memory=MemoryConfig(long_mem_size=m["long_mem_size"],
                            work_mem_size=m["work_mem_size"],
                            attn_thresh=m["attn_thresh"],
                            sim_thresh=m["sim_thresh"],
                            mem_dropout=m["mem_dropout"]),
        value_enc_depth=cfg["value_enc_depth"], value_enc_dim=cfg["value_enc_dim"],
        value_enc_heads=cfg["value_enc_heads"], attn_head_in=cfg["attn_head_in"],
        attn_head_out=cfg["attn_head_out"])
    return s, prec


def build(ctx: common.Ctx):
    from spann3r_torch.models.spann3r import Spann3R
    pcfg, prec = port_config(ctx.cfg)
    return common.on_device(ctx, lambda: Spann3R(pcfg)), pcfg, prec


def narrow(cfg: dict) -> dict:
    # the bank holds more than the working memory, as at full size
    return dict(cfg, **NARROW, memory=dict(cfg["memory"], long_mem_size=40))


def reference(weights, cfg: dict, **rounding) -> rm.Ref:
    return rm.Ref(weights, cfg, **rounding)


def head_rel_err(ctx: common.Ctx, model, pcfg, prec, img1, img2) -> float:
    """The DPT heads of the program's DUSt3R alone (dust3r.head_rel_err)."""
    return dust3r.head_rel_err(ctx, model.dust3r, pcfg.dust3r, prec, img1, img2)
