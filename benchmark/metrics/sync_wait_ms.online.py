"""Host ms a frame inside the program's `spann3r.sync` spans over the
traced stretch: the host's three waits for the device in each memory
write, the append's two scalar fills (copies from pageable memory) and the
read of the prune decision. The first of them drains the device's queue,
so it carries nearly all of the wait."""
from benchmark.counts import spans


def read(r):
    return spans.host_ms(r, ["spann3r.sync"])
