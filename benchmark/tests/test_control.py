"""The sides of each cell's limits at a narrow configuration on the CPU:
the plain reference in float8 put in the program's place, and the program
with its heads in bfloat16, must fail the cell's limits; the plain
reference rounded to bfloat16 in the program's place, the sound twin,
must pass them (benchmark/control.py runs them at the cells' sizes on the
card, with the heads in TF32 too, which the CPU does not have). And the
online cell's pooled numbers on made-up records: a heavy tail that the
program shares with the twin on the same frames passes, the same tail on
the program alone does not. And the replay of a bank transition on made-up
banks: the reference's own prune reads no gap, a prune that keeps other
slots does."""
from __future__ import annotations

import functools
import time

import pytest
import torch

from benchmark import common, control
from benchmark.drivers import stream_step
from benchmark.reference import model as rm
from benchmark.tests import tiny

CELLS = ["spann3r.online-512", "dust3r.pairs-512"]
# the online numbers in units of the twin that have a limit: the median
# frame's pointmap, which float8 fails, and the pointmaps' spikes, which a
# fault on a tenth of the frames fails
ONLINE_RATIOS = ["pts3d_err_over_twin", "pts3d_p95_spike_over_twin"]


@functools.lru_cache(maxsize=None)
def _reference_checks(cell, name):
    cfg, traffic = tiny.cell(cell)
    ctx = common.Ctx(cfg, traffic, 2**31 + 3, 0.0, False, torch.device("cpu"),
                     time.perf_counter(), traffic["limits"])
    numbers, _ = control.reference_checks(ctx, name)
    return common.limited(ctx, numbers), ctx.notes


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(cell):
    checks, _ = _reference_checks(cell, "fp8")
    assert any(not v <= lim for v, lim in checks.values()), checks


@pytest.mark.parametrize("cell", CELLS)
def test_bf16_twin_passes_the_limits(cell):
    checks, _ = _reference_checks(cell, "bf16-twin")
    assert all(v <= lim for v, lim in checks.values()), checks


@pytest.mark.parametrize("number,fails", [("pts3d_err_over_twin", True),
                                          ("pts3d_p95_spike_over_twin", False)])
def test_fp8_fails_the_online_median(number, fails):
    """Float8 is worse than the twin on every frame alike: the median sees
    it, the spikes do not."""
    checks, _ = _reference_checks("spann3r.online-512", "fp8")
    v, lim = checks[number]
    assert (v > lim) == fails, checks


@pytest.mark.parametrize("control", ["bf16-twin", "fp8"])
def test_a_reference_replays_its_own_bank_exactly(control):
    """A reference in the program's place: its bank transitions, each
    prune among them, replayed in fp32 from its own banks, read no gap."""
    checks, notes = _reference_checks("spann3r.online-512", control)
    assert checks["bank_slot_gap"][0] == 0.0 and notes["bank_transitions"] > 0, notes


def _records(prog, twin, videos=2):
    """Records of one stream over `videos` videos with the per-frame
    (pointmap, confidence) errors given, every write taken."""
    n = len(prog)
    return [{"prog": [list(prog)], "twin": [list(twin)],
             "log": [[(0.5, False)] for _ in range(n - 1)],
             "dups": [None] + [torch.tensor([False])] * (n - 1), "slot_gaps": []}
            for _ in range(videos)]


def _heavy_tail(n=192, base=0.02, tail=0.4, every=10):
    """A frame error of `base`, and `tail` on every `every`-th frame."""
    return [(tail, tail) if t % every == every - 1 else (base * (1 + 0.01 * (t % 7)),) * 2
            for t in range(n)]


def _limits():
    return tiny.cell("spann3r.online-512")[1]["limits"]


@pytest.mark.parametrize("number", ONLINE_RATIOS)
def test_a_tail_the_twin_shares_passes(number):
    """The program's errors 1.6 times the twin's on every frame: no spike."""
    twin = _heavy_tail()
    prog = [(1.6 * a, 1.6 * b) for a, b in twin]
    got = stream_step.pooled_numbers(_records(prog, twin), 0.95)
    want = 1.0 if "spike" in number else 1.6
    assert got[number] == pytest.approx(want) and got[number] <= _limits()[number]


@pytest.mark.parametrize("number", ONLINE_RATIOS)
def test_a_tail_of_the_program_alone_fails(number):
    """Only the spikes see it: the medians pass."""
    twin = _heavy_tail(tail=0.02)
    prog = [(1.6 * a, 1.6 * b) for a, b in _heavy_tail()]
    got = stream_step.pooled_numbers(_records(prog, twin), 0.95)
    assert (got[number] > _limits()[number]) == ("spike" in number), got


def test_a_stretch_the_twin_does_not_share_passes_the_spikes():
    """Rounding parts the program from the twin for stretches of frames
    (PERF.md): a tenth of the frames in one stretch, the program's errors
    20 times the twin's, raises no spike but at its two ends."""
    twin = [(0.02, 0.02)] * 192
    prog = [(0.4, 0.4) if 100 <= t < 120 else (0.03, 0.03) for t in range(192)]
    got = stream_step.pooled_numbers(_records(prog, twin), 0.95)
    assert got["pts3d_p95_spike_over_twin"] == pytest.approx(1.0)


MEM = dict(long_mem_size=40, work_mem_size=5, sim_thresh=0.95)


def _a_prune():
    """(bank before, bank after): random frames of 6 tokens written to a
    bank until it prunes, on the write that prunes."""
    g = torch.Generator().manual_seed(7)
    bank = rm.empty_bank(1, 128, 8, "cpu")
    for _ in range(12):
        before = bank
        bank = rm.write(bank, torch.randn(1, 6, 8, generator=g),
                        torch.randn(1, 6, 8, generator=g), MEM, torch.tensor([False]))
    assert int(bank.size[0]) < int(before.size[0]) and int(bank.lm[0]) > 0
    return before, bank


def _cut(bank, keep=40):
    """The bank's first `keep` slots kept, by place alone."""
    cut = lambda a: torch.cat([a[:, :keep], torch.zeros_like(a[:, keep:])], 1)
    return bank._replace(k=cut(bank.k), v=cut(bank.v), count=cut(bank.count),
                         attn=cut(bank.attn))


def test_slot_gap_of_the_same_prune_is_zero():
    before, after = _a_prune()
    again = after._replace(k=after.k.clone(), attn=after.attn * 1.01)
    assert stream_step.slot_gap(before, again, after) == 0.0


@pytest.mark.parametrize("fault,least", [("other slots", 0.5), ("one age", 1 / 40),
                                         ("counters", 1.0)])
def test_slot_gap_sees_a_prune_gone_wrong(fault, least):
    before, after = _a_prune()
    appended = rm.append(before, after.k[:, 34:40], after.v[:, 34:40])
    got = {"other slots": lambda: _cut(appended)._replace(size=after.size, wm=after.wm,
                                                           lm=after.lm),
           "one age": lambda: after._replace(count=after.count + (torch.arange(128) == 3)),
           "counters": lambda: after._replace(lm=after.lm + 6)}[fault]()
    assert stream_step.slot_gap(before, got, after) >= least


def test_transitions_keep_every_prune():
    """Every prune of a run is replayed, and SAMPLED_WRITES other writes."""
    keep = stream_step.Transitions(5)
    g = torch.Generator().manual_seed(9)
    bank, pruned = rm.empty_bank(1, 128, 8, "cpu"), []
    for t in range(1, 40):
        before = bank
        bank = rm.write(bank, torch.randn(1, 6, 8, generator=g),
                        torch.randn(1, 6, 8, generator=g), MEM, torch.tensor([t % 3 == 0]))
        if int(bank.size[0]) < int(before.size[0]):
            pruned.append(t)
        keep.offer(t, before, None if t == 1 else torch.zeros(1), bank)
    ts = [t for t, *_ in keep.items]
    assert len(pruned) > 1 and set(pruned) <= set(ts)
    assert len(ts) == len(pruned) + stream_step.SAMPLED_WRITES
    assert not any(t % 3 == 0 for t in ts)


@pytest.mark.parametrize("cell", CELLS)
def test_heads_in_bfloat16_fail_the_limits(cell):
    res = tiny.execute(cell, seconds=0.5, precision="float32", heads="bfloat16")
    assert not res["correct"], res["checks"]
    assert res["checks"]["head_rel_err"]["value"] > res["checks"]["head_rel_err"]["limit"]
