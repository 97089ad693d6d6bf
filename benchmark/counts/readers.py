"""What the per-layer readers (benchmark/metrics/<name>.py) share. Each
takes the run's record `r`: the trace summary (kernels, busy_s, window_s,
launches, units, shapes), the driver's `flops_per_unit` and untraced
`rate`, the configuration, and the card's `peaks` (None off the card).
Each returns None where the run holds nothing it reads."""
from __future__ import annotations

from benchmark.counts import kernels as K


def launches_per_unit(r):
    if not r.get("kernels") or not r.get("units"):
        return None
    return len(r["kernels"]) / r["units"]


def mfu_pct(r):
    if not r.get("peaks") or not r.get("rate"):
        return None
    return 100.0 * r["flops_per_unit"] * r["rate"] / r["peaks"]["bf16_flops"]


def idle_pct(r):
    if not r.get("window_s") or not r.get("kernels"):
        return None
    return 100.0 * (1.0 - r["busy_s"] / r["window_s"])


def roofline_pct(r, kernel_works):
    """Sum over the stretch's launches of each launch's bound, over the
    summed device time of the kernel's trace names. kernel_works: (kernel
    name, work function) pairs; the launches counted by the program must
    match the path's shape table."""
    if not r.get("peaks") or not r.get("kernels"):
        return None
    bound = dev_us = 0.0
    for kernel, work in kernel_works:
        shapes = r["shapes"].get(kernel, [])
        if not shapes or r["launches"].get(kernel) != len(shapes):
            return None
        bound += sum(K.bound_s(work(s), r["peaks"]) for s in shapes)
        dev_us += sum(d for n, d in r["kernels"] if K.is_kernel(n, kernel))
    if dev_us <= 0:
        return None
    return 100.0 * bound / (dev_us / 1e6)
