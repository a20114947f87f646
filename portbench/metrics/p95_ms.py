"""p95_ms: the 95th percentile of client-side latency, from send to the
last result batch, over every request sent in the window."""

import numpy as np


def read(run):
    return float(np.percentile(run.latencies_s, 95) * 1e3) if len(run.latencies_s) else None
