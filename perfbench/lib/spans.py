"""The port's spans (tantivy_aggregations_tpu_torch/utils/stats.py) as
the per-layer metrics read them.

- `per_request_ms(run, name)`: host ms of span `name` per answered
  request of the traced window, from the request laps the port hands out
  under EngineConfig.collect_stats (QueryStats.spans; the harness turns
  collect_stats on in a traced closed-loop run).
- `process_s(*names)`: seconds of the named spans in the process's span
  table (`stats.span_table()`); read after the window, that is set-up
  plus window, one run a process as run.py runs it.
- `split(events)`: over a profiler trace's events (trace_read.events),
  each `tat.*` span name's count, host seconds and self seconds inside
  the window, and the window's device-idle seconds by the innermost
  `tat.*` span open at each idle instant (`outside` where none is): an
  exact sweep over every idle interval.

Each returns None where the program has no spans (a tree without them).
"""

import heapq

from . import trace_read

PREFIX = "tat."
OUTSIDE = "outside"


def per_request_ms(run, name):
    st = run.get("stats")
    if not st or "spans" not in st[0]:
        return None
    laps = [s["spans"].get(name, 0.0) for s in st]
    if not any(laps):
        return None
    return sum(laps) / len(laps)


def process_s(*names):
    try:
        from tantivy_aggregations_tpu_torch.utils import stats
    except ImportError:
        return None
    table = getattr(stats, "span_table", None)
    if table is None:
        return None
    t = table()
    found = [t[n][1] for n in names if n in t]
    return sum(found) if found else None


def _name(record: str) -> str:
    """A span's name: a root's args follow it after a space."""
    return record.split(" ", 1)[0]


def _labelled(spans, w0, w1):
    """[(t0, t1, label)] covering [w0, w1] in order: the innermost span
    open over each piece (the latest started; of two started together
    the one that ends first), OUTSIDE where none is."""
    pts = []
    for i, (a, b, _) in enumerate(spans):
        pts.append((a, 1, i))
        pts.append((b, 0, i))
    pts.sort()  # at one instant, ends before starts
    heap, alive, segs, t = [], [False] * len(spans), [], w0

    def top():
        while heap and not alive[heap[0][2]]:
            heapq.heappop(heap)
        return spans[heap[0][2]][2] if heap else OUTSIDE

    for tp, start, i in pts:
        if tp > t:
            segs.append((t, tp, top()))
            t = tp
        if start:
            alive[i] = True
            heapq.heappush(heap, (-spans[i][0], spans[i][1], i))
        else:
            alive[i] = False
    if w1 > t:
        segs.append((t, w1, top()))
    return segs


def split(evs):
    """{"spans": {name: {"count", "s", "self_s"}}, "idle_by_span": {name
    or OUTSIDE: s}, "idle_s"} of the trace's window, or None where the
    trace has no window or no tat.* span."""
    win = [(a, b) for n, d, a, b in evs if n == trace_read.WINDOW and not d]
    if not win:
        return None
    w0, w1 = win[-1]
    spans = [(max(a, w0), min(b, w1), _name(n)) for n, d, a, b in evs
             if not d and n.startswith(PREFIX) and b > w0 and a < w1]
    spans = [s for s in spans if s[1] > s[0]]
    if not spans:
        return None
    _, busy = trace_read._union([(max(a, w0), min(b, w1))
                                 for _, d, a, b in evs
                                 if d and b > w0 and a < w1])
    idle, prev = [], w0
    for a, b in busy:
        if a > prev:
            idle.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        idle.append((prev, w1))
    segs = _labelled(spans, w0, w1)
    out = {}
    for a, b, name in spans:
        e = out.setdefault(name, {"count": 0, "s": 0.0, "self_s": 0.0})
        e["count"] += 1
        e["s"] += (b - a) / 1e9
    for a, b, label in segs:
        if label != OUTSIDE:
            out[label]["self_s"] += (b - a) / 1e9
    by = {}
    j = 0
    for x0, x1 in idle:
        while segs[j][1] <= x0:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < x1:
            a, b, label = segs[k]
            by[label] = by.get(label, 0) + min(b, x1) - max(a, x0)
            k += 1
    return {"spans": out,
            "idle_by_span": {k: v / 1e9 for k, v in sorted(by.items())},
            "idle_s": sum(b - a for a, b in idle) / 1e9}
