"""The traced stretch of a `--trace 1` run: torch.profiler (CUPTI) over a
fixed number of units of work inside the window, parsed in memory into a
summary. Nothing is written to disk.

The summary holds each device operation's name and duration, the device's
busy seconds (the union of the operations' intervals), the stretch's
length on the host clock, the kernel launches the program counted
(`ops._kernels.LAUNCHES`) over the stretch, the device operations that
took most time, and the idle gaps of the device by what the host was
doing: the benchmark's own span and the innermost host operation that
was running when the device went idle.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

MEM_OPS = ("Memcpy", "Memset")


def _launches() -> Dict[str, int]:
    from spann3r_torch.ops import _kernels
    return dict(_kernels.LAUNCHES)


class Tracer:
    """Profiles units [start, start + count) of a run when enabled. The
    driver calls begin(i) before and end(i) after unit i, add() inside the
    stretch, span(name) around its calls into the program, and finish()
    once the window has closed, which parses the trace. `spent_s` is the
    stretch's host time with the profiler's start and stop, which the
    untraced rate leaves out."""

    def __init__(self, enabled: bool, start: int, count: int, device):
        self.enabled = enabled
        self.start, self.count = start, count
        self.device = device
        self.prof = None
        self.done = None
        self.summary: Optional[dict] = None
        self.units = 0.0
        self.spent_s = 0.0
        self.shapes: Dict[str, list] = defaultdict(list)

    @property
    def active(self) -> bool:
        return self.prof is not None

    def _activities(self):
        from torch.profiler import ProfilerActivity
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return acts

    def warm_up(self) -> None:
        """Start and stop the profiler once in set-up, so that its own
        first start (CUPTI's) falls outside the window."""
        if self.enabled:
            from torch.profiler import profile
            with profile(activities=self._activities()):
                torch.zeros(1, device=self.device).add_(1)
            _sync(self.device)

    def begin(self, i: int) -> None:
        if not self.enabled or i != self.start or self.done is not None:
            return
        from torch.profiler import profile
        self._t0 = time.perf_counter()
        _sync(self.device)
        self.prof = profile(activities=self._activities())
        self.prof.__enter__()
        self._l0 = _launches()
        self._w0 = time.perf_counter()

    def add(self, units: float, **shapes) -> None:
        """Count units of work done, and the kernel shapes they launched,
        inside the stretch."""
        if self.active:
            self.units += units
            for k, v in shapes.items():
                self.shapes[k] += v

    def end(self, i: int) -> None:
        if not self.active or i != self.start + self.count - 1:
            return
        _sync(self.device)
        wall = time.perf_counter() - self._w0
        l1 = _launches()
        prof, self.prof = self.prof, None
        prof.__exit__(None, None, None)
        self.done = (prof, wall, {k: l1[k] - self._l0.get(k, 0) for k in l1})
        self.spent_s = time.perf_counter() - self._t0

    def finish(self) -> Optional[dict]:
        """The summary of the stretch (None if it never ran); a stretch
        that the window cut short is stopped here and summarised as far as
        it got."""
        if self.active:
            self.end(self.start + self.count - 1)
        if self.done is not None and self.summary is None:
            prof, wall, launches = self.done
            self.summary = summarise(prof, wall)
            self.summary.update(launches=launches, units=self.units,
                                shapes=dict(self.shapes))
            self.done = None
        return self.summary

    def span(self, name: str):
        if self.active:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def summarise(prof, wall_s: float) -> dict:
    """Reads the profiler's raw events (building its event tree would take
    minutes on a long stretch)."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s = e.start_ns() / 1e3
        t = (s, s + e.duration_ns() / 1e3, name)
        if e.device_type() == DeviceType.CUDA:
            if not (e.is_user_annotation() or name.startswith("bench.")):
                dev.append(t)
        elif e.device_type() == DeviceType.CPU:
            host.append(t)
    dev.sort()
    host.sort()
    by_name: Dict[str, float] = defaultdict(float)
    busy_us, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e, name in dev:
        by_name[name] += e - s
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    kernels = [(name, e - s) for s, e, name in dev
               if not name.startswith(MEM_OPS)]
    return {
        "busy_s": busy_us / 1e6,
        "window_s": wall_s,
        "kernels": kernels,
        "device_ops": sorted(((n, t / 1e6) for n, t in by_name.items()),
                             key=lambda x: -x[1])[:10],
        "idle_gaps": _label_gaps(gaps, host),
    }


def _label_gaps(gaps, host) -> List[list]:
    """Idle seconds summed by what the host was running at each gap's
    start: the outermost benchmark span ('bench.*') and the innermost host
    operation that had started and not ended."""
    starts = [s for s, _, _ in host]
    spans = [(s, e, n) for s, e, n in host if n.startswith("bench.")]
    span_starts = [s for s, _, _ in spans]
    out: Dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        label = "host idle"
        j = bisect.bisect_right(starts, g0) - 1
        for k in range(j, max(j - 200, -1), -1):
            s, e, n = host[k]
            if e >= g0 and not n.startswith("bench."):
                label = n
                break
        outer = "no span"
        k = bisect.bisect_right(span_starts, g0) - 1
        while k >= 0:
            s, e, n = spans[k]
            if e >= g0:
                outer = n
            k -= 1
            if s < g0 - 60e6:
                break
        out[f"{outer} / {label}"] += (g1 - g0) / 1e6
    return [list(x) for x in sorted(out.items(), key=lambda x: -x[1])[:10]]
