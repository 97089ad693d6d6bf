"""Kernel launches in the device trace of the traced stretch over the
frames whose outputs it completed: the host's dispatch a frame."""
from benchmark.counts import readers


def read(r):
    return readers.launches_per_unit(r)
