"""The yardstick's arithmetic: the FLOP counts against bench.py's formula
and against a count of the reference's own operations, and each kernel's
bound against chip_smoke.py's at the kernel table's shapes (PERF.md)."""
from __future__ import annotations

import json

import pytest
import torch

from benchmark import run, weights as bw
from benchmark.counts import flops, kernels
from benchmark.reference import model as rm

PEAKS = kernels.PEAKS["NVIDIA H100 80GB HBM3"]


def _cfg(name):
    return json.loads((run.BENCH_DIR / "configs" / f"{name}.json").read_text())


def test_transformer_flops_reproduce_bench():
    from spann3r_torch.bench import transformer_flops_per_frame
    from spann3r_torch.config import Spann3RConfig
    ours = flops.transformer_flops_per_frame(_cfg("spann3r"), (384, 512))
    assert ours == transformer_flops_per_frame(Spann3RConfig(), (384, 512), 1)
    assert round(ours / 1e12, 4) == 1.1365


def test_head_flops_count_the_reference_head():
    """At a narrow width on the CPU, the analytic count of one DPT head
    equals torch's count of the reference head's convolutions."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = dict(_cfg("dust3r-512-dpt"), enc_embed_dim=64, dec_embed_dim=48,
               dpt_feature_dim=32, dpt_last_dim=16, dpt_layer_dims=[8, 16, 24, 32],
               enc_depth=1, dec_depth=4)
    ref = rm.Ref(bw.generate(cfg, 1, "cpu"), cfg)
    for hw in ((64, 80), (48, 96)):
        p = flops.tokens(cfg, hw)
        states = [torch.zeros(1, p, d) for d in (64, 48, 48, 48)]
        with FlopCounterMode(display=False) as fc:
            ref.head(1, states, hw)
        assert fc.get_total_flops() == flops.dpt_head(cfg, hw)
    assert round(flops.dpt_head(_cfg("spann3r"), (384, 512)) / 1e12, 4) == 0.1867


def test_scene_flops():
    assert round(flops.pairs_scene(_cfg("dust3r-512-dpt"), (384, 512), 8, 56) / 1e12, 2) == 49.58


@pytest.mark.parametrize("shape,ms", [
    ((16, 16, 768, 768, 64, 2), 0.0391), ((1, 12, 768, 768, 64, 2), 0.0018),
    ((8, 16, 768, 768, 64, 2), 0.0195), ((8, 12, 768, 768, 64, 2), 0.0147),
    ((10, 16, 196, 196, 64, 2), 0.0048), ((2, 12, 196, 196, 64, 2), 0.0007)])
def test_sdpa_bound_matches_chip_smoke(shape, ms):
    assert round(kernels.bound_s(kernels.sdpa_work(shape), PEAKS) * 1e3, 4) == ms


@pytest.mark.parametrize("sizes,ms", [((8704,), 0.0277), ((4000,), 0.0127),
                                      ((768,), 0.0024), ((768, 8704), 0.0301)])
def test_memory_read_bound_matches_chip_smoke(sizes, ms):
    streams = [(768, s, 8704, 1024, 2) for s in sizes]
    assert round(kernels.bound_s(kernels.memory_read_work(streams), PEAKS) * 1e3, 4) == ms
