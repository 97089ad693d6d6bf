"""Host ms a frame inside the program's `spann3r.head` span over the
traced stretch: the reference frame's DPT head, the host's dispatch and
any wait included."""
from benchmark.counts import spans


def read(r):
    return spans.host_ms(r, ["spann3r.head"])
