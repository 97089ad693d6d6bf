"""BENCHMARK.json and the files it names: every configuration names a
model kind whose module keeps the kinds' contract, every cell a known
configuration and traffic mix, every traffic mix a driver that keeps the
drivers' contract, every per-layer metric a reader, and the entries keep
the contract's form. A name with no module raises a ValueError that names
the module."""
from __future__ import annotations

import json
import re

import pytest

from benchmark import drivers, find, models, run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def spec():
    return run.load_spec()


def test_top_level_keys(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"]
    assert 1 <= spec["run_seconds"] <= 51
    assert len(json.dumps(spec)) < 64 * 1024


def test_configs_load(spec):
    for c in spec["configs"]:
        assert NAME.match(c["name"]) and set(c) == {"name", "source", "file",
                                                    "reduced", "why"}
        assert c["file"].startswith("benchmark/configs/")
        cfg = json.loads((run.ROOT / c["file"]).read_text())
        kind = find("models", cfg["model"])
        assert all(callable(getattr(kind, f, None)) for f in models.CONTRACT), kind


def test_cells_name_known_files(spec):
    configs = {c["name"] for c in spec["configs"]}
    seen = set()
    for w in spec["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in configs
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        _, cfg, traffic = run.cell_parts(spec, w["name"])
        driver = find("drivers", traffic["driver"])
        assert all(hasattr(driver, a) for a in drivers.CONTRACT), driver
        assert callable(driver.run) and callable(driver.reference_checks)
        assert isinstance(driver.SHORT, dict)
        # an exact comparison has the limit 0
        assert traffic["limits"] and all(v >= 0 for v in traffic["limits"].values())
    assert {c["config"] for c in spec["workloads"]} == configs


def test_metrics(spec):
    cells = {w["name"] for w in spec["workloads"]}
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert (run.BENCH_DIR / "metrics" / f"{m['name']}.py").exists()
        assert run.read_metric(m["name"], {}) is None   # nothing to read
    for w in cells:   # every cell reports setup_s, another end-to-end metric
        names = [m["name"] for m in spec["end_to_end"]
                 if w in m.get("workloads", cells)]
        assert "setup_s" in names and len(names) >= 2
        assert any(w in m["workloads"] for m in spec["per_layer"])


@pytest.mark.parametrize("package", ["models", "drivers"])
def test_unknown_name_names_the_missing_module(package):
    with pytest.raises(ValueError, match=rf"benchmark\.{package}\.no_such_name"):
        find(package, "no_such_name")
    with pytest.raises(ValueError, match="no module name"):
        find(package, "a-b")


def test_unknown_kind_falls_through_to_no_other():
    import torch
    from benchmark import common, weights
    ctx = common.Ctx({"model": "no_such_name"}, {"driver": "no_such_driver"}, 1, 0.0,
                     False, torch.device("cpu"), 0.0)
    for look_up in (lambda: weights.spec(ctx.cfg), lambda: common.build_program_model(ctx)):
        with pytest.raises(ValueError, match=r"benchmark\.models\.no_such_name"):
            look_up()
    with pytest.raises(ValueError, match=r"benchmark\.drivers\.no_such_driver"):
        run.execute("spann3r.online-512", 1, 0.0, False, "cpu",
                    traffic={"driver": "no_such_driver", "limits": {}})
