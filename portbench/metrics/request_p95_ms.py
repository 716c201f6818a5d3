"""The 95th percentile of a serving window's request latencies, in ms,
on the host's clock (profiler off): the tail of every request, failed
ones counted as infinite."""

import numpy as np


def read(run):
    if run.kind != "serve" or not run.latencies_ms:
        return None
    return float(np.percentile(np.asarray(run.latencies_ms), 95))
