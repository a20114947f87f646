"""flight.wire_ms (layer ``flight``): the mean client latency less the
mean server time of a ``search`` (``search.seconds`` / ``search.count``
over the window): the RPC, the Arrow encoding and the wire."""

import numpy as np


def read(run):
    count = run.counters.get("search.count", 0.0)
    if not count or not len(run.latencies_s):
        return None
    return float((np.mean(run.latencies_s) - run.counters["search.seconds"] / count) * 1e3)
