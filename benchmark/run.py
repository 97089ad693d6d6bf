"""The benchmark of spann3r_torch on NVIDIA cards: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell of BENCHMARK.json names a configuration (benchmark/configs/), whose
`model` names its kind's module under benchmark/models/, and a traffic
mix (benchmark/traffic/<name>.json), whose `driver` names the module under
benchmark/drivers/ that runs it. The run makes the weights
and inputs from the seed, warms up (set-up), measures for `--seconds` on
the host clock, then compares a sample of what the timed path produced
with the plain fp32 reference (benchmark/reference/). With `--trace 1` a
bounded stretch of the window runs under torch.profiler, and the cell's
per-layer metrics are read from it by benchmark/metrics/<name>.py.

The last line of standard output is one JSON object: correct, attempted,
failed, setup_build_s (the seconds of setup_s spent building the program's
kernels, 0 once a checkout has them), metrics, device (and with --trace 1
breakdown), then checks: each number compared with its limit, which
standard error's last lines repeat.
The run exits non-zero, with no result, without a CUDA card (or fewer than
the cell asks for), or if JAX or the JAX package is loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "spann3r_tpu")


def _environment() -> None:
    """Caches at fixed paths inside the checkout, and no JAX behind a
    library's back."""
    cache = BENCH_DIR / "out" / "cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def load_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_parts(spec: dict, name: str):
    """(cell, configuration file's dict, traffic file's dict)."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, cfg, traffic


def applies(metric: dict, cell: str, e2e_of_cell) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_of_cell


def read_metric(name: str, r: dict):
    """benchmark/metrics/<name>.py's read(r): a number, or None when the
    run holds nothing it reads."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(r)


def execute(name: str, seed: int, seconds: float, trace: bool, device,
            spec: dict = None, cfg: dict = None, traffic: dict = None,
            t_start: float = None) -> dict:
    """One run of the cell on `device`, past the look for a card: the
    result line's object. `cfg` and `traffic` replace the files' (tests
    run a narrow configuration on the CPU)."""
    import torch

    from benchmark import common
    from benchmark.counts.kernels import PEAKS

    spec = spec or load_spec()
    cell, cfg_f, traffic_f = cell_parts(spec, name)
    cfg, traffic = cfg or cfg_f, traffic or traffic_f
    common.set_tf32_off()
    ctx = common.Ctx(cfg=cfg, traffic=traffic, seed=seed, seconds=seconds,
                     trace=trace, device=torch.device(device),
                     t_start=T_START if t_start is None else t_start,
                     limits=traffic["limits"])
    res = ctx.driver.run(ctx)

    e2e = [m for m in spec["end_to_end"] if "workloads" not in m
           or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    kind = (torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda"
            else "cpu")
    device_rec = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
                  "kind": kind, "count": cell["chips"],
                  "memory_peak_bytes": int(res["memory_peak_bytes"])}
    out = {"attempted": int(res["attempted"]), "failed": int(res["failed"])}
    if not trace:
        metrics = {m["name"]: {"value": float(res["metrics"][m["name"]]),
                               "unit": m["unit"]} for m in e2e}
    else:
        summ = res["trace"] or {}
        r = dict(summ, **res["layer"], cfg=cfg, traffic=traffic, cell=name,
                 peaks=PEAKS.get(kind))
        metrics = {}
        for m in spec["per_layer"]:
            if not applies(m, name, e2e_names):
                continue
            v = read_metric(m["name"], r) if summ else None
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        device_rec["busy_s"] = float(summ.get("busy_s", 0.0))
        device_rec["window_s"] = float(summ.get("window_s", 0.0))
        out["breakdown"] = {"device_ops": summ.get("device_ops", []),
                            "idle_gaps": summ.get("idle_gaps", [])}
    # the kernels' build (nvcc), which only a checkout's first run pays,
    # apart from the rest of setup_s: 0 where they were built already
    from spann3r_torch.ops import _kernels
    out["setup_build_s"] = float(getattr(_kernels, "build_seconds", None) or 0.0)
    correct = all(math.isfinite(v) and v <= lim for v, lim in res["checks"].values())
    # JSON has no infinity: a reading that is not finite prints as 1e300
    checks = {k: {"value": float(v) if math.isfinite(v) else 1e300, "limit": float(lim)}
              for k, (v, lim) in res["checks"].items()}
    return {"correct": correct, **out, "metrics": metrics, "device": device_rec,
            "notes": dict(res.get("notes", {}), **ctx.notes), "checks": checks}


def loaded_forbidden():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    spec = load_spec()
    cell, _, _ = cell_parts(spec, args.workload)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: the cell needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    res = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                  "cuda:0", spec)
    gc.collect()
    bad = loaded_forbidden()
    if bad:
        print(f"benchmark: forbidden modules loaded in this process: {bad}",
              file=sys.stderr)
        return 3
    print(f"notes: {json.dumps(res.pop('notes'))}", file=sys.stderr)
    for k, c in res["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # leave at once, so that no library's exit hook prints after the
    # result and the checks
    os._exit(code)
