"""Host ms per answered request in the port's `tat.f64_exact` span
(aggs/compile.py: the harvest's exact f64 work, each sum put together
from its limb planes and rounded once, each f64 bucket key rounded), from
the request laps of the traced window's agg_search calls
(QueryStats.spans); None where the program has no such span."""

from perfbench.lib import spans


def read(run):
    return spans.per_request_ms(run, "tat.f64_exact")
