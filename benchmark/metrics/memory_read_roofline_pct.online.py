"""K1 (ops.memory_read): each read's least time on the card at the bank's
valid slots of that read, over the device time of K1's kernels, in %."""
from benchmark.counts import kernels, readers


def read(r):
    return readers.roofline_pct(r, [("memory_read", kernels.memory_read_work)])
