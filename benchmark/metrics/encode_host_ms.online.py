"""Host ms a frame inside the program's `spann3r.encode` span over the
traced stretch: the patch embed and the encoder's blocks, the host's
dispatch and any wait included."""
from benchmark.counts import spans


def read(r):
    return spans.host_ms(r, ["spann3r.encode"])
