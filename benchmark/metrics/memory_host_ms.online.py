"""Host ms a frame inside the program's `spann3r.memory.*` spans over the
traced stretch (the memory's read, key heads, value encoder and write),
less the `spann3r.sync` inside the write."""
from benchmark.counts import spans


def read(r):
    return spans.memory_host_ms(r)
