"""K2 (ops.attention.sdpa): the launches' least time on the card (the
larger of operations over the bf16 peak and bytes over the memory rate,
from the path's shape table) over K2's device time in the trace, in %."""
from benchmark.counts import kernels, readers


def read(r):
    return readers.roofline_pct(r, [("sdpa", kernels.sdpa_work)])
