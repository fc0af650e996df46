"""Host ms per answered request in the port's `tat.param_copy` span
(query/compile.py to_device_async: the param matrix pinned and its
host-to-device copy enqueued), from the request laps of the traced
window's agg_search calls (QueryStats.spans)."""

from perfbench.lib import spans


def read(run):
    return spans.per_request_ms(run, "tat.param_copy")
