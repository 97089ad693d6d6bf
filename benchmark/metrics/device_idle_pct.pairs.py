"""The device's idle share of the traced stretch: 1 - the union of the
device operations' intervals over the stretch's host-clock length, in %."""
from benchmark.counts import readers


def read(r):
    return readers.idle_pct(r)
