"""Observability: spans, counters, per-query stats, the profiler hook and
structured logging.

- `span(name, args=None)`: one layer's work as a span. While spans are on
  it enters `torch.profiler.record_function("<name> <args>")` when a
  profiler session records, so the span lands in it on the same clock as
  the card's kernel, copy and fill records, and it adds its
  `perf_counter_ns` duration to its thread's span table under `name`.
  The args ride in the profiler's name, after a space: record_function's
  own args string never reaches the trace. While spans are off it costs
  one flag test. Spans are on while a `trace(log_dir)` block is open,
  and inside the requests of a searcher whose `EngineConfig.collect_stats`
  is set (`root`).
- `root(name, collect, ...)`: the span that one request (`tat.request`)
  or one msearch group (`tat.group` at submit, `tat.collect` at collect)
  nests under; its args carry the serial (and a group's rows, distinct
  rows and padded batch size where known: `tat.group serial=3 rows=5`).
  Entering it starts the thread's table of the current request
  (`request_spans`).
- `span_table()` / `reset_spans()`: count and total ns of every span
  name, summed over the threads, since the last reset.
- `counters`: always-on counts of requests, groups, group rows, plans,
  evictions, host fallbacks and graph captures, replays and drops (one
  dict increment at each site, as ops/kernels.py's `launches`);
  `reset_counters()`.
- `QueryStats`: one agg_search's wall-time split, read from its spans
  (`QueryStats.from_spans`).
- `trace(log_dir)`: context manager around `torch.profiler.profile` (the
  JAX package's wraps `jax.profiler.trace`) — writes one Chrome trace JSON
  into `log_dir` when it is set, no-op otherwise.
- module logger `log`: std-logging, structured key=value formatting.
- `prep_cache`: hits and misses of the cross-process prep cache
  (utils/prep_cache.py) since the last `reset_prep()`.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import torch

log = logging.getLogger("tantivy_aggregations_tpu_torch")

#: prep cache lookups that found their artifact (hits) or not (misses),
#: and the seconds and bytes of its reads (hits) and writes
prep_cache = {"hits": 0, "misses": 0, "read_s": 0.0, "read_bytes": 0,
              "write_s": 0.0, "write_bytes": 0}
_prep_lock = threading.Lock()


def count_prep(hit: bool, seconds: float = 0.0, nbytes: int = 0) -> None:
    with _prep_lock:
        prep_cache["hits" if hit else "misses"] += 1
        if hit:
            prep_cache["read_s"] += seconds
            prep_cache["read_bytes"] += nbytes


def count_prep_write(seconds: float, nbytes: int) -> None:
    with _prep_lock:
        prep_cache["write_s"] += seconds
        prep_cache["write_bytes"] += nbytes


def reset_prep() -> None:
    with _prep_lock:
        for k in prep_cache:
            prep_cache[k] = type(prep_cache[k])()


#: serving events since the last reset_counters(): agg_search calls
#: (`requests`), msearch / stream groups submitted (`groups`), their
#: requests (`group_rows`), the distinct rows the device groups ran after
#: dedup (`distinct_rows`) and the rows their power-of-two padding added
#: (`padded_rows`), programs planned and dropped by a searcher's LRU,
#: requests routed to the exact host path, and the step graphs captured,
#: replayed and dropped for the graph memory budget
counters = {"requests": 0, "groups": 0, "group_rows": 0, "distinct_rows": 0,
            "padded_rows": 0, "programs_planned": 0, "programs_evicted": 0,
            "host_fallbacks": 0, "graph_captures": 0, "graph_replays": 0,
            "graph_drops": 0}


def reset_counters() -> None:
    for k in counters:
        counters[k] = 0


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

#: > 0 while spans are on: trace blocks open plus collect_stats roots
#: running, in any thread
_on = 0
_on_lock = threading.Lock()
_serials = itertools.count(1)
_local = threading.local()
#: every thread's _Table (span_table and reset_spans read them all)
_tables = []
_tables_lock = threading.Lock()


def _switch(d: int) -> None:
    global _on
    with _on_lock:
        _on += d


class _Table:
    """One thread's spans: name -> [count, total ns] since the last
    reset, and name -> ns inside the thread's current request."""

    __slots__ = ("total", "request")

    def __init__(self):
        self.total = {}
        self.request = {}


def _table() -> _Table:
    t = getattr(_local, "table", None)
    if t is None:
        t = _local.table = _Table()
        with _tables_lock:
            _tables.append(t)
    return t


class _Off:
    """What span() and root() return while spans are off."""

    __slots__ = ()
    serial = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
#: True while a torch.profiler session records
_profiling = torch.autograd._profiler_enabled


class _Span:
    __slots__ = ("name", "args", "rf", "t0")

    def __init__(self, name, args):
        self.name = name
        self.args = args

    def __enter__(self):
        # record_function costs several us even with no profiler session
        # to take it: entered only while one records
        self.rf = None
        if _profiling():
            self.rf = torch.profiler.record_function(
                self.name if self.args is None
                else f"{self.name} {self.args}")
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        t = _table()
        e = t.total.get(self.name)
        if e is None:
            e = t.total[self.name] = [0, 0]
        e[0] += 1
        e[1] += dt
        t.request[self.name] = t.request.get(self.name, 0) + dt
        return False


class _Root(_Span):
    __slots__ = ("collect", "serial", "fields")

    def __init__(self, name, collect, serial, fields):
        super().__init__(name, None)
        self.collect = collect
        self.serial = serial
        self.fields = fields

    def __enter__(self):
        if self.collect:
            _switch(1)
        if self.serial is None:
            self.serial = next(_serials)
        self.args = " ".join([f"serial={self.serial}"] + [
            f"{k}={v}" for k, v in self.fields if v is not None])
        _table().request = {}
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            if self.collect:
                _switch(-1)


def span(name: str, args: Optional[str] = None):
    """A context manager around one layer's work: a profiler
    record_function named `name` (followed by `args`, after a space,
    where given) plus a perf_counter_ns lap into the thread's span table
    under `name` while spans are on; a no-op otherwise."""
    if not _on:
        return _OFF
    return _Span(name, args)


def root(name: str, collect: bool = False, serial: Optional[int] = None,
         rows: Optional[int] = None, distinct: Optional[int] = None,
         padded: Optional[int] = None):
    """The span one request or group nests under (its `args`: a fresh
    serial, or `serial` where given, and the group fields given), which
    starts the thread's current request table. `collect` turns spans on
    for its duration (EngineConfig.collect_stats); otherwise it is a span
    like any other, a no-op while spans are off. The object entered has
    the serial (None while off)."""
    if not (collect or _on):
        return _OFF
    return _Root(name, collect, serial,
                 (("rows", rows), ("distinct", distinct), ("padded", padded)))


def request_spans() -> dict:
    """ns by span name of the calling thread's current (or last) request
    or group: everything spanned since its root was entered."""
    return dict(_table().request)


def span_table() -> dict:
    """{name: (count, seconds)} of every span since the last
    reset_spans(), summed over the threads."""
    out = {}
    with _tables_lock:
        tables = list(_tables)
    for t in tables:
        for name, (n, ns) in list(t.total.items()):
            c, s = out.get(name, (0, 0.0))
            out[name] = (c + n, s + ns / 1e9)
    return out


def reset_spans() -> None:
    with _tables_lock:
        for t in _tables:
            t.total.clear()
            t.request.clear()


# ---------------------------------------------------------------------------
# per-query stats
# ---------------------------------------------------------------------------

@dataclass
class QueryStats:
    """One agg_search's wall-time split (EngineConfig.collect_stats), from
    its spans: prepare = `tat.plan` (the program lookup, and load and
    build on a miss), dispatch = `tat.submit` (params, their copy, the
    launch), wait = `tat.stage` + `tat.wait` (the fruit copy enqueued and
    waited for: execution + transfer), harvest = `tat.harvest`; device =
    dispatch + wait + harvest, or `tat.fallback` on the exact host path;
    total = prepare + device. `spans`: ms by span name of the request."""

    prepare_ms: float = 0.0
    device_ms: float = 0.0
    harvest_ms: float = 0.0
    total_ms: float = 0.0
    dispatch_ms: float = 0.0
    wait_ms: float = 0.0
    program_cached: bool = True
    spans: dict = field(default_factory=dict)

    @classmethod
    def from_spans(cls, ns: dict, program_cached: bool) -> "QueryStats":
        ms = {k: v / 1e6 for k, v in ns.items()}
        st = cls(prepare_ms=ms.get("tat.plan", 0.0),
                 dispatch_ms=ms.get("tat.submit", 0.0),
                 wait_ms=ms.get("tat.stage", 0.0) + ms.get("tat.wait", 0.0),
                 harvest_ms=ms.get("tat.harvest", 0.0),
                 program_cached=program_cached, spans=ms)
        st.device_ms = (ms["tat.fallback"] if "tat.fallback" in ms else
                        st.dispatch_ms + st.wait_ms + st.harvest_ms)
        st.total_ms = st.prepare_ms + st.device_ms
        return st

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in
                ("prepare_ms", "device_ms", "dispatch_ms", "wait_ms",
                 "harvest_ms", "total_ms", "program_cached", "spans")}


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the enclosed queries with torch.profiler: host (CPU)
    activity, and the card's kernels and copies when CUDA is available,
    with the port's spans on. On exit one Chrome trace JSON
    (chrome://tracing, Perfetto) is written into `log_dir`, created if
    missing. No-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        _switch(1)
        try:
            yield
        finally:
            _switch(-1)
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
