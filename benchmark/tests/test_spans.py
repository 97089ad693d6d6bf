"""The program's spans as the benchmark sees them: the readers of their
host time (benchmark/counts/spans.py) on sums given by hand and on none;
the trace's summary, whose every reading is the same with and without the
program's spans in the trace; and a traced run of the online cell on the
CPU at a narrow configuration, which reports each metric of the spans."""
from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from benchmark import run
from benchmark.counts import spans
from benchmark.trace import summarise
from benchmark.tests import tiny

READERS = ["encode_host_ms.online", "decode_host_ms.online", "head_host_ms.online",
           "memory_host_ms.online", "sync_wait_ms.online"]
SUMS = {"spann3r.step": 1.0, "spann3r.encode": 0.2, "spann3r.decode": 0.4,
        "spann3r.head": 0.1, "spann3r.memory.read": 0.05,
        "spann3r.memory.value": 0.1, "spann3r.memory.write": 0.08,
        "spann3r.sync": 0.03}
# units 10: ms a unit
WANT = {"encode_host_ms.online": 20.0, "decode_host_ms.online": 40.0,
        "head_host_ms.online": 10.0, "memory_host_ms.online": 20.0,
        "sync_wait_ms.online": 3.0}


@pytest.fixture
def program_sums(monkeypatch):
    from spann3r_torch.utils import trace

    def put(sums):
        monkeypatch.setattr(trace, "SPAN_S", dict(sums))
    return put


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_the_sums(program_sums, name):
    program_sums(SUMS)
    assert run.read_metric(name, {"units": 10.0}) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", READERS)
def test_reader_is_none_without_spans(program_sums, monkeypatch, name):
    program_sums({})
    assert run.read_metric(name, {"units": 10.0}) is None
    program_sums({"spann3r.other": 1.0})
    assert run.read_metric(name, {"units": 10.0}) is None
    # a program that has no spans at all
    import spann3r_torch.utils
    program_sums(SUMS)
    monkeypatch.delattr(spann3r_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "spann3r_torch.utils.trace", None)
    assert spans.program_span_s() is None
    assert run.read_metric(name, {"units": 10.0}) is None


class _Event:
    def __init__(self, name, s_us, e_us, dev, annotation=False):
        self._n, self._s, self._d = name, s_us, e_us - s_us
        self._dev, self._a = dev, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return int(self._s * 1e3)

    def duration_ns(self):
        return int(self._d * 1e3)

    def device_type(self):
        return self._dev

    def is_user_annotation(self):
        return self._a


def _prof(events):
    res = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=res))


CPU, CUDA = DeviceType.CPU, DeviceType.CUDA
BASE = [
    _Event("bench.engine.step", 0, 1000, CPU, True),
    _Event("aten::addmm", 10, 40, CPU), _Event("cudaLaunchKernel", 20, 30, CPU),
    _Event("aten::copy_", 500, 700, CPU),
    _Event("gemm", 30, 200, CUDA), _Event("Memcpy DtoH", 600, 650, CUDA),
    _Event("bench.engine.step", 25, 700, CUDA, True),
]
# the program's spans on the host and their device-side annotations
PROGRAM = [
    _Event("spann3r.step", 5, 990, CPU, True),
    _Event("spann3r.decode", 8, 300, CPU, True),
    _Event("spann3r.memory.write", 450, 980, CPU, True),
    _Event("spann3r.sync", 520, 690, CPU, True),
    _Event("spann3r.decode", 30, 200, CUDA, True),
    _Event("spann3r.memory.write", 600, 650, CUDA, True),
]


def test_summary_reads_the_same_with_program_spans():
    """Every key of the summary but the idle gaps' labels reads the same
    with the program's spans in the trace, and their device-side
    annotations enter neither the kernels nor the busy time."""
    plain = summarise(_prof(BASE), 1e-3)
    spanned = summarise(_prof(BASE + PROGRAM), 1e-3)
    assert set(plain) == set(spanned)
    for k in plain:
        if k != "idle_gaps":
            assert spanned[k] == plain[k], k
    assert plain["kernels"] == [("gemm", 170.0)]
    assert plain["busy_s"] == pytest.approx(220e-6)
    # the gap while the host ran the decoder's Python: a label of its own
    assert [g for g, _ in plain["idle_gaps"]] == ["bench.engine.step / host idle"]
    assert [g for g, _ in spanned["idle_gaps"]] == ["bench.engine.step / spann3r.decode"]
    assert spanned["idle_gaps"][0][1] == pytest.approx(plain["idle_gaps"][0][1])


def test_traced_online_run_reports_the_span_metrics():
    """A traced run of the online cell, narrow, on the CPU: the five
    metrics are there, each above 0 and all under the step's host time."""
    from spann3r_torch.utils import trace
    trace.reset()
    res = tiny.execute("spann3r.online-512", trace=True)
    got = {n: res["metrics"][n]["value"] for n in READERS}
    assert all(v > 0 for v in got.values()), got
    units = 3.0   # the narrow traffic's traced frames, one output each
    step_ms = 1e3 * trace.SPAN_S["spann3r.step"] / units
    assert sum(got.values()) <= step_ms
