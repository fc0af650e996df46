"""Host ms per answered request in the port's `tat.params` span
(aggs/compile.py Program._param_rows: each request's params extracted,
padded and built into the host param matrix), from the request laps of
the traced window's agg_search calls (QueryStats.spans under
EngineConfig.collect_stats). No span nests in tat.params (the param copy
is its sibling under tat.submit), so its lap is its self time."""

from perfbench.lib import spans


def read(run):
    return spans.per_request_ms(run, "tat.params")
