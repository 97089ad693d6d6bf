"""Model FLOPs of the path a unit of work (benchmark/counts/flops.py) times
the untraced rate of the traced run, over the card's bf16 peak, in %."""
from benchmark.counts import readers


def read(r):
    return readers.mfu_pct(r)
