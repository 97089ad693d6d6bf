"""The controls of each cell at a narrow configuration on the CPU: the
plain reference in float8 put in the program's place, and the program
with its heads in bfloat16, must fail the cell's limits
(benchmark/control.py runs them at the cells' sizes on the card, with the
heads in TF32 too, which the CPU does not have)."""
from __future__ import annotations

import time

import pytest
import torch

from benchmark import common, control
from benchmark.tests import tiny

CELLS = ["spann3r.online-512", "dust3r.pairs-512"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(cell):
    cfg, traffic = tiny.cell(cell)
    ctx = common.Ctx(cfg, traffic, 2**31 + 3, 0.0, False, torch.device("cpu"),
                     time.perf_counter(), traffic["limits"])
    checks = control.fp8_checks(ctx)
    assert any(not v <= lim for v, lim in checks.values()), checks


@pytest.mark.parametrize("cell", CELLS)
def test_heads_in_bfloat16_fail_the_limits(cell):
    res = tiny.execute(cell, seconds=0.5, precision="float32", heads="bfloat16")
    assert not res["correct"], res["checks"]
    assert res["checks"]["head_rel_err"]["value"] > res["checks"]["head_rel_err"]["limit"]
