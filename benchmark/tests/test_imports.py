"""What the benchmark loads: no module whose top-level name is jax, jaxlib,
flax or the JAX package (spann3r_tpu), in a whole run; and the reference,
the weights (through the model kinds' modules) and the generators load
nothing of the program either."""
from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "spann3r_tpu"}

RUN = """
import json, sys
from benchmark.tests import tiny
res = tiny.execute("spann3r.online-512", seconds=0.5)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""
# the weights of every configuration are listed through its kind's module
REFERENCE = """
import json, sys
import benchmark.reference.model, benchmark.weights, benchmark.generate
from benchmark import run
for c in run.load_spec()["configs"]:
    assert benchmark.weights.n_params(json.loads((run.ROOT / c["file"]).read_text())) > 0
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""
# the one import of the benchmark's own: weights.spec finds the kind's
# module by name
LOOKUP = {"weights.py": {"benchmark"}}


def _top_level_modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=600)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    mods = _top_level_modules(RUN)
    assert "spann3r_torch" in mods and "benchmark" in mods
    assert not mods & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    mods = _top_level_modules(REFERENCE)
    assert not mods & (FORBIDDEN | {"spann3r_torch"})


def test_reference_sources_import_only_torch_and_the_standard_library():
    for path in (BENCH / "reference" / "model.py", BENCH / "weights.py",
                 BENCH / "generate.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in {"__future__", "math", "typing", "torch",
                                           "numpy"} | LOOKUP.get(path.name, set()), (path, n)
                if n == "benchmark":
                    assert [a.name for a in node.names] == ["find"], (path, n)
