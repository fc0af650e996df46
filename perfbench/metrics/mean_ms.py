"""Mean latency of all requests of the window, ms (host clock, a
perf_counter around each agg_search, which ends in the fruit's host
copy)."""


def read(run):
    lat = run["latencies_s"]
    return sum(lat) / len(lat) * 1e3 if lat else None
