"""Mean QueryStats.dispatch_ms of the traced window's agg_search calls
(EngineConfig.collect_stats, host clock), ms."""


def read(run):
    st = run["stats"]
    return sum(s["dispatch_ms"] for s in st) / len(st) if st else None
