"""The benchmark of spann3r_torch on NVIDIA cards (run.py). Its parts are
found by name: a configuration's model kind under benchmark/models/, a
traffic mix's driver under benchmark/drivers/ (`find`), a per-layer
metric's reader under benchmark/metrics/ (`run.read_metric`)."""
from __future__ import annotations

import importlib


def find(package: str, name: str):
    """The module benchmark/<package>/<name>.py. Where there is none, a
    ValueError names the module."""
    path = f"{__name__}.{package}.{name}"
    if not name.isidentifier():
        raise ValueError(f"no module {path}: {name!r} is no module name")
    try:
        return importlib.import_module(path)
    except ModuleNotFoundError as e:
        if e.name != path:
            raise
        raise ValueError(f"no module {path} (benchmark/{package}/{name}.py)") from None
