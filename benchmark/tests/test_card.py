"""On the card only (each test decides in a fixture and skips elsewhere):
every cell's command runs a short window and prints its result line in
the contract's form, each control of each cell fails its limits on every
video, and the bf16 twin passes them.

    python3 -m pytest -q benchmark/tests/test_card.py
"""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import find, run

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


def _control_lines(cell, control):
    out = _run(["benchmark/control.py", "--workload", cell, "--control", control,
                "--seed", str(2**31 + 5)])
    return [json.loads(line) for line in out.stdout.strip().splitlines()]


def _driver(cell):
    return find("drivers", run.cell_parts(run.load_spec(), cell)[2]["driver"])


# each cell's entries that must fail: every cell's, and its driver's own
# faults
@pytest.mark.parametrize("cell,control", [
    (c, k) for c in CELLS
    for k in ["fp8", "heads-tf32", "heads-bf16"] + list(getattr(_driver(c), "FAULTS", {}))])
def test_control_fails(card, cell, control):
    lines = _control_lines(cell, control)
    assert lines and all(d["fails"] and d["must_fail"] for d in lines), lines
    # the checks the control has to fail, any one of them (the driver's
    # CAUGHT_BY; any check where it names none)
    names = getattr(_driver(cell), "CAUGHT_BY", {}).get(control)
    for d in lines:
        assert any(d["checks"][k]["value"] > d["checks"][k]["limit"]
                   for k in names or d["checks"]), d


@pytest.mark.parametrize("cell", CELLS)
def test_bf16_twin_passes(card, cell):
    lines = _control_lines(cell, "bf16-twin")
    assert lines and not any(d["fails"] or d["must_fail"] for d in lines), lines
    if "bank_slot_gap" in lines[0]["checks"]:
        # its bank, replayed in fp32 from its own, to the bit
        assert all(d["checks"]["bank_slot_gap"]["value"] == 0.0
                   and d["notes"]["bank_transitions"] > 0 for d in lines), lines
