"""The sides of each cell's limits at a narrow configuration on the CPU:
the plain reference in float8 put in the program's place, and the program
with its heads in bfloat16, must fail the cell's limits; the plain
reference rounded to bfloat16 in the program's place, the sound twin,
must pass them (benchmark/control.py runs them at the cells' sizes on the
card, with the heads in TF32 too, which the CPU does not have)."""
from __future__ import annotations

import time

import pytest
import torch

from benchmark import common, control
from benchmark.tests import tiny

CELLS = ["spann3r.online-512", "dust3r.pairs-512"]


def _reference_checks(cell, name):
    cfg, traffic = tiny.cell(cell)
    ctx = common.Ctx(cfg, traffic, 2**31 + 3, 0.0, False, torch.device("cpu"),
                     time.perf_counter(), traffic["limits"])
    numbers, _ = control.reference_checks(ctx, name)
    return common.limited(ctx, numbers)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(cell):
    checks = _reference_checks(cell, "fp8")
    assert any(not v <= lim for v, lim in checks.values()), checks


@pytest.mark.parametrize("cell", CELLS)
def test_bf16_twin_passes_the_limits(cell):
    checks = _reference_checks(cell, "bf16-twin")
    assert all(v <= lim for v, lim in checks.values()), checks


@pytest.mark.parametrize("cell", CELLS)
def test_heads_in_bfloat16_fail_the_limits(cell):
    res = tiny.execute(cell, seconds=0.5, precision="float32", heads="bfloat16")
    assert not res["correct"], res["checks"]
    assert res["checks"]["head_rel_err"]["value"] > res["checks"]["head_rel_err"]["limit"]
