"""Readers of the program's own spans (`spann3r_torch/utils/trace.py`):
the host milliseconds a unit of work spent inside them while the traced
stretch ran. The program sums each span's host seconds, inclusive of the
spans nested in it, only while a torch profiler runs, which in a run of
the benchmark is the traced stretch alone. Each reader returns None where
the program keeps no such sums or the stretch entered none of the spans
it reads."""
from __future__ import annotations


def program_span_s():
    """{span name: host seconds} summed while the profiler ran, or None
    where the program has no spans."""
    try:
        from spann3r_torch.utils import trace
    except ImportError:
        return None
    return dict(trace.SPAN_S)


def host_ms(r, names, less=()):
    """Host ms a unit of the spans `names`, less the spans `less` nested
    in them."""
    spans = program_span_s()
    if not spans or not r.get("units") or not any(n in spans for n in names):
        return None
    s = sum(spans.get(n, 0.0) for n in names) - sum(spans.get(n, 0.0) for n in less)
    return 1e3 * s / r["units"]


def memory_host_ms(r):
    """The memory's read, key heads, value encoder and write, less the
    host's wait for the device inside the write."""
    names = [n for n in program_span_s() or {} if n.startswith("spann3r.memory.")]
    return host_ms(r, names, less=("spann3r.sync",))
