"""Host ms a frame inside the program's `spann3r.decode` span over the
traced stretch: both cross-attending decoders of the pair, the host's
dispatch and any wait included."""
from benchmark.counts import spans


def read(r):
    return spans.host_ms(r, ["spann3r.decode"])
