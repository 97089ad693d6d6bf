"""Spans at the program's layer boundaries.

`span(name)` marks a stretch of the host's work, such as one layer's call,
in the trace of a running torch profiler (`torch.profiler.record_function`),
so that it lies on the profiler's timeline beside the device's operations
that it launched. With no profiler running it returns one shared no-op
context, and costs a check of the profiler's state. While a profiler runs,
each span's host seconds are also summed in `SPAN_S` (inclusive of the
spans nested in it), so that the split of a profiled stretch by span can
be read without parsing the trace.

A span named `spann3r.sync` marks each of the host's waits for the device
inside a step: a read of a device value, or a copy from pageable host
memory to the device, which on the card waits for the device's queue to
drain first. Every span's name starts with `spann3r.`. `reset()` clears
the spans' sums.
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import DefaultDict

import torch

SPAN_S: DefaultDict[str, float] = defaultdict(float)

_profiling = torch._C._autograd._profiler_enabled


class _Off:
    # cheaper to enter and leave than contextlib.nullcontext
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "_rf", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._rf = torch.autograd.profiler.record_function(self.name)
        self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        SPAN_S[self.name] += time.perf_counter() - self._t0
        self._rf.__exit__(*exc)
        return False


def span(name: str):
    """A context that records `name` around its body while a torch
    profiler runs, and does nothing otherwise."""
    return _Span(name) if _profiling() else _OFF


def reset() -> None:
    SPAN_S.clear()
