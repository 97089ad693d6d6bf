"""DUSt3R's backbone alone (`"model": "dust3r"`): the encoder, the two
decoders and the two DPT heads of AsymmetricCroCo3DStereo, as the
program's `models.dust3r.DUSt3R`."""
from __future__ import annotations

import math

from benchmark import common
from benchmark import weights as bw
from benchmark.reference import model as rm

# the CPU tests' cut: every transformer and DPT width narrow, one head
NARROW = dict(enc_embed_dim=64, enc_depth=2, enc_num_heads=1, dec_embed_dim=64,
              dec_depth=4, dec_num_heads=1, dpt_feature_dim=16, dpt_last_dim=8,
              dpt_layer_dims=[8, 16, 32, 64])


def spec(cfg: dict) -> bw.Spec:
    return bw.dust3r_spec(cfg)


def port_config(cfg: dict):
    """(DUSt3RConfig, Precision) of the program."""
    from spann3r_torch.config import DUSt3RConfig, ViTConfig
    inf = {"inf": math.inf, "-inf": -math.inf}
    mode = lambda m: (m[0], float(inf.get(m[1], m[1])), float(inf.get(m[2], m[2])))
    d = DUSt3RConfig(
        img_size=tuple(cfg.get("img_size", (512, 512))),
        patch_size=cfg["patch_size"],
        enc=ViTConfig(dim=cfg["enc_embed_dim"], depth=cfg["enc_depth"],
                      num_heads=cfg["enc_num_heads"], mlp_ratio=cfg["mlp_ratio"],
                      rope_base=cfg["rope_base"]),
        dec=ViTConfig(dim=cfg["dec_embed_dim"], depth=cfg["dec_depth"],
                      num_heads=cfg["dec_num_heads"], mlp_ratio=cfg["mlp_ratio"],
                      rope_base=cfg["rope_base"]),
        head_type=cfg["head_type"], depth_mode=mode(cfg["depth_mode"]),
        conf_mode=mode(cfg["conf_mode"]), dpt_feature_dim=cfg["dpt_feature_dim"],
        dpt_last_dim=cfg["dpt_last_dim"],
        dpt_layer_dims=tuple(cfg["dpt_layer_dims"]),
        out_channels=cfg["out_channels"])
    return d, common.precision(cfg)


def build(ctx: common.Ctx):
    from spann3r_torch.models.dust3r import DUSt3R
    pcfg, prec = port_config(ctx.cfg)
    return common.on_device(ctx, lambda: DUSt3R(pcfg)), pcfg, prec


def narrow(cfg: dict) -> dict:
    return dict(cfg, **NARROW)


def reference(weights, cfg: dict, **rounding) -> rm.Ref:
    return rm.Ref(weights, cfg, **rounding)


def head_rel_err(ctx: common.Ctx, model, pcfg, prec, img1, img2) -> float:
    """The program's DPT heads alone against the reference's, on the pairs
    (img1[i], img2[i]) (common.head_rel_err)."""
    return common.head_rel_err(reference(bw.generate(ctx.cfg, ctx.seed, ctx.device), ctx.cfg),
                               common.program_head(model, pcfg, prec), img1, img2)
