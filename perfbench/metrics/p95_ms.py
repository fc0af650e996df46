"""95th percentile of all requests' latency in the window, ms (host
clock, a perf_counter around each agg_search, which ends in the fruit's
host copy)."""

import numpy as np


def read(run):
    lat = run["latencies_s"]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
