"""A run of each cell with its timed path broken underneath must come out
not correct: past the look for a card, the whole run (set-up, window,
comparison) on the CPU at a narrow configuration, once for each fault the
cell can have. The unbroken run comes out correct. (No cell spans chips,
so none can leave out an exchange between them.) The runs compute in
fp32, where program and reference agree to rounding at any width: the
cells' limits were set from bf16 readings at full width, which a narrow
configuration does not reproduce."""
from __future__ import annotations

import itertools

import pytest
import torch

from benchmark.drivers import stream_step
from benchmark.tests import tiny


def _alter_every(n, fn, scale=2.0):
    """A wrapper of fn that scales the first pointmap it returns by `scale`
    on every n-th call."""
    calls = itertools.count()

    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        if next(calls) % n == n - 1:
            _scale_first_pts(out, scale)
        return out
    return wrapped


def _scale_first_pts(out, scale):
    if isinstance(out, dict):
        if "pts3d" in out and torch.is_tensor(out["pts3d"]):
            out["pts3d"] = out["pts3d"] * scale
            return True
        return any(_scale_first_pts(v, scale) for v in out.values())
    if isinstance(out, (tuple, list)):
        return any(_scale_first_pts(v, scale) for v in out)
    if hasattr(out, "_fields"):
        return any(_scale_first_pts(v, scale) for v in out)
    return False


def state_unchanged_memory(mp):
    import spann3r_torch.models.spann3r as sp
    mp.setattr(sp, "add_mem_check", lambda state, k, v, cfg: state)


def answer_altered_stream(mp):
    """Every pair's reference-frame pointmap, as the pair step returns it,
    scaled by 2 (the median frame's comparison)."""
    import spann3r_torch.models.spann3r as sp
    mp.setattr(sp, "pair_step", _alter_every(1, sp.pair_step))


def answer_altered_some_frames(mp):
    """Every fifth pair's reference-frame pointmap scaled by 2, as a fault
    on the bank's prune frames would be (the tail's comparison)."""
    import spann3r_torch.models.spann3r as sp
    mp.setattr(sp, "pair_step", _alter_every(5, sp.pair_step))


def answer_altered_tenth_frames(mp):
    """Every tenth pair's reference-frame pointmap scaled by 1.5, as the
    `tenth-frames` control plants it at full size (the tail's
    comparison)."""
    import spann3r_torch.models.spann3r as sp
    mp.setattr(sp, "pair_step", _alter_every(10, sp.pair_step, 1.5))


def dedup_off(mp):
    """The write is never skipped as a duplicate."""
    import spann3r_torch.models.memory as mem
    mp.setattr(mem, "check_sim", lambda state, k, *a: torch.zeros(
        k.shape[0], dtype=torch.bool, device=k.device))


def dedup_threshold_moved(mp):
    """The dedup check's threshold 0.15 higher than the configuration's:
    over the narrow model's similarities (0.5-0.8) what 0.05 is over the
    full model's (0.95-1.0)."""
    import spann3r_torch.models.memory as mem
    orig = mem.check_sim
    mp.setattr(mem, "check_sim", lambda state, k, p, wm, thresh: orig(
        state, k, p, wm, thresh + 0.15))


def prune_truncates(mp):
    """The prune keeps the bank's first long_mem_size slots, by place
    alone, as control.py's `prune-truncates` plants it."""
    import spann3r_torch.models.memory as mem
    with stream_step.prune_truncates():
        fault = mem.memory_prune
    mp.setattr(mem, "memory_prune", fault)


def long_term_zeroed(mp):
    """The tokens that spill to long-term memory are zeroed, as control.py's
    `long-term-zeroed` plants it."""
    import spann3r_torch.models.spann3r as sp
    with stream_step.long_term_zeroed():
        fault = sp.add_mem_check
    mp.setattr(sp, "add_mem_check", fault)


def answer_altered_pairs(mp):
    import spann3r_torch.models.inference as inf
    mp.setattr(inf, "decode_pairs", _alter_every(2, inf.decode_pairs))


def half_batch_pairs(mp):
    """Only the first half of each batch of pairs is decoded; the rest gets
    its outputs."""
    import spann3r_torch.models.inference as inf
    orig = inf.decode_pairs

    def wrapped(m, f1, f2, pos, hw, cfg, prec):
        b = f1.shape[0]
        h = max(1, b // 2)
        r1, r2 = orig(m, f1[:h], f2[:h], pos, hw, cfg, prec)
        idx = torch.arange(b) % h
        return ({k: v[idx] for k, v in r1.items()}, {k: v[idx] for k, v in r2.items()})
    mp.setattr(inf, "decode_pairs", wrapped)


FAULTS = {
    "spann3r.online-512": [state_unchanged_memory, answer_altered_stream,
                           answer_altered_some_frames, answer_altered_tenth_frames,
                           dedup_off, dedup_threshold_moved, prune_truncates,
                           long_term_zeroed],
    "dust3r.pairs-512": [answer_altered_pairs, half_batch_pairs],
}
SECONDS = {"spann3r.online-512": 3.0, "dust3r.pairs-512": 0.5}
# the narrow model's similarities of consecutive frames lie at 0.5-0.8
# (0.90-1.0 at full width): a lower threshold makes it skip some writes,
# as the full model does
SIM_THRESH = {"spann3r.online-512": 0.65}
# the faults of the bank that act on a prune: with the configuration's
# own threshold every frame of the narrow model writes, and each video's
# bank prunes (on its twelfth write, with slots past the protected age)
EVERY_WRITE = {prune_truncates, long_term_zeroed}


@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_sound_run_is_correct(cell):
    res = tiny.execute(cell, seconds=SECONDS[cell], precision="float32",
                       sim_thresh=SIM_THRESH.get(cell))
    assert res["correct"], res["checks"]


def test_sound_run_with_every_write_is_correct():
    res = tiny.execute("spann3r.online-512", seconds=SECONDS["spann3r.online-512"],
                       precision="float32")
    assert res["correct"] and res["notes"]["dedup_skipped_by_program"] == 0, res
    assert res["checks"]["bank_slot_gap"]["value"] == 0.0


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in FAULTS.items() for f in fs],
                         ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    res = tiny.execute(cell, seconds=SECONDS[cell], precision="float32",
                       sim_thresh=None if fault in EVERY_WRITE else SIM_THRESH.get(cell))
    assert not res["correct"], res["checks"]
    if fault in EVERY_WRITE:
        assert res["checks"]["bank_slot_gap"]["value"] > 0.1, res["checks"]
