"""On the card only (each test decides in a fixture and skips elsewhere):
every cell's command runs a short window and prints its result line in
the contract's form, and each control of each cell fails its limits.

    python3 -m pytest -q benchmark/tests/test_card.py
"""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import run

CELLS = [w["name"] for w in run.load_spec()["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name(0)


def _run(args):
    out = subprocess.run([sys.executable, *args], cwd=run.ROOT, capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs(card, cell):
    out = _run(["benchmark/run.py", "--workload", cell, "--seed", str(2**31 + 99),
                "--seconds", "3", "--trace", "0"])
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(res)[-1] == "checks" and res["correct"], res["checks"]
    assert res["device"]["kind"] == card and res["device"]["count"] == 1
    assert all(m["value"] > 0 for m in res["metrics"].values())


@pytest.mark.parametrize("control", ["fp8", "heads-tf32", "heads-bf16"])
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(card, cell, control):
    out = _run(["benchmark/control.py", "--workload", cell, "--control", control,
                "--seed", str(2**31 + 5)])
    assert json.loads(out.stdout.strip().splitlines()[-1])["fails"]
