"""Host ms per answered request in the port's `tat.wait` span
(aggs/compile.py _Staged.numpy: the blocking wait on the fruit copy's
event, so the device step as the host sees it), from the request laps of
the traced window's agg_search calls (QueryStats.spans)."""

from perfbench.lib import spans


def read(run):
    return spans.per_request_ms(run, "tat.wait")
