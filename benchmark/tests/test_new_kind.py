"""A configuration of a model kind the benchmark has never seen enters by
new files alone: a stub kind (one linear map) with its configuration,
traffic, driver, reference and per-layer reader is written into a
checkout of its own, beside copies of the benchmark's data files, and
BENCHMARK.json gains its entries there. The harness, pointed at that
checkout (its root, and the packages' search paths), runs the cell
untraced and traced, runs control.py's entries on it, and keeps the
files' contract over the whole spec; no file of the benchmark is
written."""
from __future__ import annotations

import hashlib
import importlib
import json
import shutil
import sys
import textwrap
import time

import pytest
import torch

import benchmark.drivers
import benchmark.models
import benchmark.reference
from benchmark import common, control, run
from benchmark.tests import test_files, tiny

CELL = "stub-linear.rows"
FILES = {
    "configs/stub-linear.json": json.dumps({
        "model": "stub_linear", "dim_in": 64, "dim_out": 24,
        "precision": {"compute": "float32", "heads": "float32", "tf32": False}}),
    "traffic/rows.json": json.dumps({
        "driver": "stub_rows", "rows": 256, "limits": {"rel_err": 1e-5}}),
    "metrics/rows_traced.stub.py": '''
        """Rows through the model in the traced stretch."""


        def read(r):
            return r.get("units") or None
        ''',
    "reference/stub_linear.py": '''
        """Plain reference of one linear map, fp32 or rounded."""
        from benchmark.reference.model import bf16_round, fp8


        class Ref:
            def __init__(self, weights, lowp=False, bf16=False):
                self.w = weights
                self.round = fp8 if lowp else bf16_round if bf16 else (lambda x: x)

            def forward(self, x):
                w = self.w["proj.weight"]
                return self.round(x) @ self.round(w).t() + self.w["proj.bias"]
        ''',
    "models/stub_linear.py": '''
        """A stub kind: one linear map, y = x W^T + b."""
        import torch

        from benchmark import common, weights as bw
        from benchmark.reference import stub_linear


        def spec(cfg):
            return bw._linear("proj", cfg["dim_out"], cfg["dim_in"])


        def port_config(cfg):
            return (cfg["dim_in"], cfg["dim_out"]), common.DTYPES[cfg["precision"]["compute"]]


        def build(ctx):
            dims, dtype = port_config(ctx.cfg)
            make = lambda: torch.nn.ModuleDict({"proj": torch.nn.Linear(*dims)})
            return common.on_device(ctx, make), dims, dtype


        def narrow(cfg):
            return dict(cfg, dim_in=16)


        def reference(weights, cfg, **rounding):
            return stub_linear.Ref(weights, **rounding)
        ''',
    "drivers/stub_rows.py": '''
        """A stub driver: the same batch of `rows` rows through the model,
        closed loop."""
        import time

        import torch

        from benchmark import common, weights as bw
        from benchmark.trace import Tracer

        SHORT = dict(rows=32)


        def rows(ctx):
            x = ctx.rng(0).standard_normal((ctx.traffic["rows"], ctx.cfg["dim_in"]))
            return torch.from_numpy(x.astype("float32")).to(ctx.device)


        @torch.no_grad()
        def run(ctx):
            model, _, _ = common.build_program_model(ctx)
            x = rows(ctx)
            model["proj"](x)
            setup_s = time.perf_counter() - ctx.t_start
            tracer = Tracer(ctx.trace, 1, 2, ctx.device)
            tracer.warm_up()
            win = common.Window(ctx.seconds)
            t_open, unit = win.open(), 0
            while not win.over or unit < 3:
                tracer.begin(unit)
                y = model["proj"](x)
                tracer.add(len(x))
                tracer.end(unit)
                unit += 1
            window_s = time.perf_counter() - t_open
            summary = tracer.finish()
            want = ctx.kind.reference(bw.generate(ctx.cfg, ctx.seed, ctx.device),
                                      ctx.cfg).forward(x)
            return {"metrics": {"rows_per_s": unit * len(x) / window_s, "setup_s": setup_s},
                    "attempted": unit, "failed": 0, "memory_peak_bytes": 0,
                    "trace": summary, "layer": {},
                    "checks": common.limited(ctx, {"rel_err": common.rel_err(y, want)})}


        def reference_checks(ctx, exact, low):
            x = rows(ctx)
            return {"rel_err": common.rel_err(low.forward(x), exact.forward(x))}, None
        ''',
}
ENTRIES = {
    "configs": {"name": "stub-linear", "source": "https://example.org/stub-linear",
                "file": "benchmark/configs/stub-linear.json", "reduced": [],
                "why": "one linear map"},
    "workloads": {"name": CELL, "config": "stub-linear", "traffic": "rows", "chips": 1,
                  "why": "one batch of rows through one linear map, again and again"},
    "end_to_end": {"name": "rows_per_s", "unit": "rows/s", "better": "higher",
                   "bound": 0.05, "source": "host_clock", "workloads": [CELL]},
    "per_layer": {"name": "rows_traced.stub", "unit": "rows", "better": "higher",
                  "source": "program_counter", "layer": "model step",
                  "moves": "rows_per_s", "workloads": [CELL]},
}
PACKAGES = (benchmark.models, benchmark.drivers, benchmark.reference)
MODULES = ("benchmark.models.stub_linear", "benchmark.drivers.stub_rows",
           "benchmark.reference.stub_linear")


def _benchmark_files() -> dict:
    return {str(p.relative_to(run.BENCH_DIR)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(run.BENCH_DIR.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture
def stub(tmp_path, monkeypatch):
    """The spec of a checkout that holds the benchmark's data files and the
    stub's new files, with the harness pointed at it."""
    before = _benchmark_files()
    root = tmp_path / "checkout"
    bench = root / "benchmark"
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(run.BENCH_DIR / d, bench / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for rel, text in FILES.items():
        (bench / rel).parent.mkdir(parents=True, exist_ok=True)
        (bench / rel).write_text(textwrap.dedent(text).lstrip())
    spec = run.load_spec()
    for key, entry in ENTRIES.items():
        spec[key].append(entry)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    monkeypatch.setattr(run, "ROOT", root)
    monkeypatch.setattr(run, "BENCH_DIR", bench)
    monkeypatch.setattr(sys, "path", list(sys.path))
    for k in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR", "USE_FLAX", "USE_JAX"):
        monkeypatch.delenv(k, raising=False)
    for pkg in PACKAGES:
        monkeypatch.setattr(pkg, "__path__",
                            list(pkg.__path__) + [str(bench / pkg.__name__.split(".")[-1])])
    importlib.invalidate_caches()
    try:
        yield run.load_spec()
    finally:
        for name in MODULES:
            sys.modules.pop(name, None)
            parent, _, leaf = name.rpartition(".")
            if hasattr(sys.modules[parent], leaf):
                delattr(sys.modules[parent], leaf)
        monkeypatch.undo()
        assert _benchmark_files() == before


def test_the_files_keep_the_contract(stub):
    test_files.test_top_level_keys(stub)
    test_files.test_configs_load(stub)
    test_files.test_cells_name_known_files(stub)
    test_files.test_metrics(stub)
    assert [w["name"] for w in stub["workloads"]][-1] == CELL


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs(stub, trace):
    res = tiny.execute(CELL, seconds=0.2, trace=trace, spec=stub)
    assert res["correct"] and res["checks"]["rel_err"]["value"] <= 1e-5, res["checks"]
    assert res["device"] == dict(res["device"], platform="cpu", count=1)
    want = {"rows_traced.stub"} if trace else {"rows_per_s", "setup_s"}
    assert set(res["metrics"]) == want and all(m["value"] > 0 for m in res["metrics"].values())
    if trace:
        assert res["metrics"]["rows_traced.stub"]["value"] == 2 * 32   # two traced units


def _ctx(stub):
    cfg, traffic = tiny.cell(CELL, spec=stub)
    return common.Ctx(cfg, traffic, 2**31 + 11, 0.0, False, torch.device("cpu"),
                      time.perf_counter(), traffic["limits"])


def test_control_entries(stub):
    ctx = _ctx(stub)
    assert control.controls(ctx) == control.MUST_PASS + control.MUST_FAIL
    numbers, records = control.program_checks(ctx, CELL, "program", 0.2)
    checks = common.limited(ctx, numbers)
    assert records is None and all(v <= lim for v, lim in checks.values()), checks
    numbers, _ = control.reference_checks(_ctx(stub), "fp8")
    assert numbers["rel_err"] > 1e-5, numbers
    with pytest.raises(ValueError, match="no program entry"):
        control.program_checks(_ctx(stub), CELL, "tenth-frames", 0.2)
