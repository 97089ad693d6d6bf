"""Narrow configurations and short traffic of every cell, for runs on the
CPU: the cells' own files with the widths, depths and sizes cut, by the
configuration's kind (its `narrow`) and the traffic's driver (its
`SHORT`)."""
from __future__ import annotations

import time

import torch

from benchmark import find, run


def cell(name: str, precision: str = None, heads: str = None,
         sim_thresh: float = None, spec: dict = None):
    """(configuration, traffic) of the cell, narrowed; `precision`,
    `heads` and `sim_thresh` replace the configuration's compute and head
    dtypes and its dedup threshold. `spec` replaces BENCHMARK.json."""
    torch.set_num_threads(1)
    run._environment()
    _, cfg, traffic = run.cell_parts(spec or run.load_spec(), name)
    cfg = find("models", cfg["model"]).narrow(cfg)
    if sim_thresh is not None:
        cfg["memory"] = dict(cfg["memory"], sim_thresh=sim_thresh)
    if precision:
        cfg["precision"] = dict(cfg["precision"], compute=precision)
    if heads:
        cfg["precision"] = dict(cfg["precision"], heads=heads)
    return cfg, dict(traffic, **find("drivers", traffic["driver"]).SHORT)


def execute(name: str, seed: int = 2**31 + 7, seconds: float = 1.0,
            trace: bool = False, precision: str = None, heads: str = None,
            sim_thresh: float = None, spec: dict = None) -> dict:
    cfg, traffic = cell(name, precision, heads, sim_thresh, spec)
    return run.execute(name, seed, seconds, trace, "cpu", spec=spec, cfg=cfg,
                       traffic=traffic, t_start=time.perf_counter())
