"""The port's serving table (`spann3r_torch.tools.serving_table`) against
the JAX package's root tool `tools/serving_table.py`, on the CPU: the same
configurations, one `python -m spann3r_torch.bench` process each with the
configuration's flags, and from the same bench lines the
same markdown table and JSON lines. The bench processes are stood in for
(the bench itself is held by tests/test_torch_entry.py)."""
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import pytest

from spann3r_torch.tools import serving_table as TST

REPO = Path(__file__).resolve().parent.parent


def _root_tool():
    spec = importlib.util.spec_from_file_location(
        "root_serving_table", REPO / "tools" / "serving_table.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fake_bench(calls):
    def run(cmd, **kw):
        calls.append(cmd)
        streams = int(cmd[cmd.index("--streams") + 1]) \
            if "--streams" in cmd else 1
        rec = {"metric": "fps", "value": 100.0 + len(calls), "unit": "fps",
               "ms_per_frame": 8.0 + len(calls), "mfu_pct": 12.5,
               "streams": streams, "reps": 5,
               "fps_spread": [98.0 + len(calls), 103.0 + len(calls)]}
        return subprocess.CompletedProcess(cmd, 0, "log line\n"
                                           + json.dumps(rec) + "\n", "")
    return run


def test_same_configurations():
    assert TST.CONFIGS == _root_tool().CONFIGS


@pytest.mark.parametrize("quick", [True, False])
def test_table_and_lines_match_the_root_tool(quick, tmp_path, monkeypatch,
                                             capsys):
    root = _root_tool()
    outs = {}
    for name, mod, argv in (
            ("root", root, ["serving_table.py"]),
            ("port", TST, ["serving_table"])):
        calls = []
        monkeypatch.setattr(mod.subprocess, "run", _fake_bench(calls))
        out = tmp_path / f"{name}.md"
        monkeypatch.setattr(sys, "argv",
                            argv + ["--out", str(out)] + (["--quick"] if quick
                                                          else []))
        mod.main()
        lines = capsys.readouterr().out.splitlines()
        outs[name] = (out.read_text(),
                      [l for l in lines if l.startswith(("|", "{"))], calls)
    assert outs["port"][:2] == outs["root"][:2]
    configs = TST.CONFIGS[3:5] if quick else TST.CONFIGS
    assert len(outs["port"][2]) == len(configs)
    for cmd, (_, args) in zip(outs["port"][2], configs):
        assert cmd == [sys.executable, "-m", "spann3r_torch.bench", *args]


def test_a_failed_bench_raises(monkeypatch):
    monkeypatch.setattr(TST.subprocess, "run", lambda cmd, **kw:
                        subprocess.CompletedProcess(cmd, 1, "", "boom"))
    with pytest.raises(RuntimeError, match="boom"):
        TST.run_config("x", [])
