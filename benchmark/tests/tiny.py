"""Narrow configurations and short traffic of every cell, for runs on the
CPU: the cells' own files with the widths, depths and sizes cut."""
from __future__ import annotations

import time

import torch

from benchmark import run

NARROW = dict(enc_embed_dim=64, enc_depth=2, enc_num_heads=1, dec_embed_dim=64,
              dec_depth=4, dec_num_heads=1, dpt_feature_dim=16, dpt_last_dim=8,
              dpt_layer_dims=[8, 16, 32, 64])
NARROW_SPANN3R = dict(value_enc_dim=64, value_enc_depth=1, value_enc_heads=1,
                      attn_head_in=128, attn_head_out=64)
SHORT = {
    "stream_step": dict(hw=[32, 48], frames=14, warmup_frames=12, trace_start=2,
                        trace_frames=3),
    "pairs": dict(hw=[32, 48], views=4, batch=3),
}


def cell(name: str, precision: str = None, heads: str = None,
         sim_thresh: float = None):
    """(configuration, traffic) of the cell, narrowed; `precision`,
    `heads` and `sim_thresh` replace the configuration's compute and head
    dtypes and its dedup threshold."""
    torch.set_num_threads(1)
    run._environment()
    _, cfg, traffic = run.cell_parts(run.load_spec(), name)
    cfg = dict(cfg, **NARROW)
    if cfg["model"] == "spann3r":
        cfg.update(NARROW_SPANN3R)
        # the bank holds more than the working memory, as at full size
        cfg["memory"] = dict(cfg["memory"], long_mem_size=40)
        if sim_thresh is not None:
            cfg["memory"]["sim_thresh"] = sim_thresh
    if precision:
        cfg["precision"] = dict(cfg["precision"], compute=precision)
    if heads:
        cfg["precision"] = dict(cfg["precision"], heads=heads)
    return cfg, dict(traffic, **SHORT[traffic["driver"]])


def execute(name: str, seed: int = 2**31 + 7, seconds: float = 1.0,
            trace: bool = False, precision: str = None, heads: str = None,
            sim_thresh: float = None) -> dict:
    cfg, traffic = cell(name, precision, heads, sim_thresh)
    return run.execute(name, seed, seconds, trace, "cpu", cfg=cfg,
                       traffic=traffic, t_start=time.perf_counter())
