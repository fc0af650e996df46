"""Host ms per answered request in the port's `tat.launch` span
(aggs/compile.py _StepGraph.replay: the graph launch and the credited
kernel counters; raw_fn itself where no graph is captured), from the
request laps of the traced window's agg_search calls (QueryStats.spans)."""

from perfbench.lib import spans


def read(run):
    return spans.per_request_ms(run, "tat.launch")
