"""The port's spans and counters (utils/stats.py): off, they emit nothing
and cost a flag test; on (EngineConfig.collect_stats, or inside
stats.trace), each request's spans nest under one root on the profiler's
clock, QueryStats is read from them, and the counters count groups,
dedup, padding, plans, fallbacks and graphs."""

import json
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tantivy_aggregations_tpu_torch as tt
from tantivy_aggregations_tpu_torch.aggs import compile as pcompile
from tantivy_aggregations_tpu_torch.engine_config import EngineConfig
from tantivy_aggregations_tpu_torch.models import flagship as F
from tantivy_aggregations_tpu_torch.utils import stats

torch.set_num_threads(2)

#: the spans of a planned B = 1 request, each under its parent
NEST = {"tat.plan": "tat.request", "tat.submit": "tat.request",
        "tat.params": "tat.submit", "tat.param_copy": "tat.submit",
        "tat.launch": "tat.submit", "tat.stage": "tat.request",
        "tat.wait": "tat.request", "tat.harvest": "tat.request"}


@pytest.fixture(scope="module")
def idx():
    ix = tt.Index.create_in_ram(F.bench_schema())
    w = ix.writer()
    w.add_documents_columnar(F.generate_bench_columns(3000, 42), 3000)
    w.commit()
    return ix


@pytest.fixture
def reqs():
    return [(q, a) for _, q, a in F.judged_configs()]


@pytest.fixture(autouse=True)
def _clean():
    stats.reset_spans()
    stats.reset_counters()
    yield
    assert stats._on == 0


def _span(name: str) -> str:
    """A profiler record's span name (a root's args follow a space)."""
    return name.split(" ")[0]


def _tat_events(prof):
    return [e for e in prof.events() if e.name.startswith("tat.")]


def test_spans_off_emit_nothing(idx, reqs):
    """Without collect_stats and outside stats.trace, an active profiler
    sees no tat.* record and the span table stays empty; the counters
    still count."""
    s = idx.searcher(device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for q, a in reqs:
            s.agg_search(q, a)
        s.agg_search_batch(reqs + reqs)
        list(s.agg_search_stream(iter(reqs), lookahead=2))
    assert _tat_events(prof) == []
    assert stats.span_table() == {} and stats.request_spans() == {}
    assert stats.counters["requests"] == len(reqs)
    assert stats.counters["groups"] == 3 * len(reqs)  # a shape a group


def test_spans_off_return_one_shared_no_op():
    assert stats.span("tat.x") is stats.span("tat.y")
    assert stats.root("tat.request") is stats.span("tat.z")
    with stats.root("tat.group", rows=3) as r:
        assert r.serial is None


def test_spans_on_nest_under_the_request(idx, reqs):
    """Under collect_stats each agg_search is one tat.request root,
    its serial in the record's name, with plan, submit (params, their
    copy, the launch), stage, wait and harvest nested in it."""
    s = idx.searcher(device="cpu", config=EngineConfig(collect_stats=True))
    for q, a in reqs:
        s.agg_search(q, a)  # planned: no load or build below
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for q, a in reqs[:2]:
            s.agg_search(q, a)
    evs = _tat_events(prof)
    roots = [e for e in evs if e.cpu_parent is None]
    assert [_span(e.name) for e in roots] == ["tat.request"] * 2
    serials = [int(e.name.split("serial=")[1]) for e in roots]
    assert serials[1] == serials[0] + 1
    for e in evs:
        if e.cpu_parent is not None:
            assert _span(e.cpu_parent.name) == NEST[_span(e.name)], e.name
    assert sorted({_span(e.name) for e in evs}) == sorted(
        set(NEST) | {"tat.request"})
    for r in roots:
        assert [_span(c.name) for c in r.cpu_children
                if c.name.startswith("tat.")] == [
            "tat.plan", "tat.submit", "tat.stage", "tat.wait",
            "tat.harvest"]


def test_a_miss_nests_load_and_build_in_the_plan(idx, reqs):
    s = idx.searcher(device="cpu", config=EngineConfig(collect_stats=True))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s.agg_search(*reqs[0])
    parent = {_span(e.name): _span(e.cpu_parent.name)
              for e in _tat_events(prof) if e.cpu_parent is not None}
    assert parent["tat.load"] == "tat.plan"
    assert parent["tat.build"] == "tat.plan"
    assert parent["tat.column"] == "tat.build"
    assert stats.counters["programs_planned"] == 1
    assert not s.last_stats.program_cached


def test_trace_writes_the_spans(idx, reqs, tmp_path):
    """stats.trace turns the spans on for its block, for any searcher,
    and its Chrome trace holds them."""
    s = idx.searcher(device="cpu")
    s.agg_search(*reqs[0])
    with stats.trace(str(tmp_path)):
        assert stats._on > 0
        s.agg_search(*reqs[0])
        s.agg_search_batch(reqs[:2])
    assert stats._on == 0
    (path,) = tmp_path.iterdir()
    names = {_span(e.get("name", ""))
             for e in json.loads(path.read_text())["traceEvents"]}
    assert set(NEST) | {"tat.request", "tat.group",
                        "tat.collect"} <= names
    assert stats.span_table()["tat.request"][0] == 1
    assert stats.span_table()["tat.group"][0] == 2


def test_query_stats_are_span_sums(idx, reqs):
    """last_stats is the request's span table: prepare = plan, dispatch =
    submit, wait = stage + wait, harvest, device = their sum, total =
    prepare + device; the process table holds the same laps."""
    s = idx.searcher(device="cpu", config=EngineConfig(collect_stats=True))
    for q, a in reqs:
        s.agg_search(q, a)
        st = s.last_stats
        sp = st.spans
        assert st.prepare_ms == sp["tat.plan"] > 0
        assert st.dispatch_ms == sp["tat.submit"] > 0
        assert st.wait_ms == sp["tat.stage"] + sp["tat.wait"]
        assert st.harvest_ms == sp["tat.harvest"] > 0
        assert st.device_ms == st.dispatch_ms + st.wait_ms + st.harvest_ms
        assert st.total_ms == st.prepare_ms + st.device_ms
        assert sp["tat.request"] >= st.total_ms
        assert sp["tat.submit"] >= (sp["tat.params"] + sp["tat.param_copy"]
                                    + sp["tat.launch"])
        assert set(st.as_dict()) == {
            "prepare_ms", "device_ms", "dispatch_ms", "wait_ms",
            "harvest_ms", "total_ms", "program_cached", "spans"}
    table = stats.span_table()
    assert table["tat.request"][0] == table["tat.submit"][0] == len(reqs)
    assert stats.counters["requests"] == len(reqs)
    assert stats.counters["host_fallbacks"] == 0


def test_query_stats_on_the_host_path(idx, reqs, monkeypatch):
    """A shape with no device lowering: device_ms is tat.fallback's, and
    the request counts one host fallback."""
    def unlowered(*a, **k):
        raise NotImplementedError("no lowering (test)")
    monkeypatch.setattr(pcompile, "get_program", unlowered)
    s = idx.searcher(device="cpu", config=EngineConfig(collect_stats=True))
    q, a = reqs[0]
    assert s.agg_search(q, a) == idx.oracle_searcher().agg_search(q, a)
    st = s.last_stats
    assert st.device_ms == st.spans["tat.fallback"] > 0
    assert st.dispatch_ms == st.wait_ms == st.harvest_ms == 0
    assert stats.counters["host_fallbacks"] == 1
    assert stats.counters["programs_planned"] == 0
    s.agg_search_batch([(q, a)] * 3)
    assert stats.counters["host_fallbacks"] == 4


def test_counters_over_a_deduped_padded_msearch(idx):
    """5 requests of one shape, 3 distinct: one group of 5 rows, 3 run,
    padded to 4; the group's roots carry serial, rows, distinct rows and
    the padded batch size."""
    aggs = {"n": tt.count_agg()}
    qs = [tt.TermQuery("status", v) for v in
          ("active", "archived", "active", "deleted", "archived")]
    s = idx.searcher(device="cpu", config=EngineConfig(collect_stats=True))
    oracle = idx.oracle_searcher()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = s.agg_search_batch([(q, aggs) for q in qs])
    assert got == [oracle.agg_search(q, aggs) for q in qs]
    c = stats.counters
    assert (c["groups"], c["group_rows"], c["distinct_rows"],
            c["padded_rows"]) == (1, 5, 3, 1)
    assert c["programs_planned"] == 1 and c["requests"] == 0
    roots = {_span(e.name): e.name for e in _tat_events(prof)
             if e.cpu_parent is None}
    serial = roots["tat.group"].split("serial=")[1].split()[0]
    assert roots["tat.group"] == f"tat.group serial={serial} rows=5"
    assert roots["tat.collect"] == (f"tat.collect serial={serial} rows=5 "
                                    "distinct=3 padded=4")
    s2 = idx.searcher(device="cpu",
                      config=EngineConfig(msearch_dedup=False))
    s2.agg_search_batch([(q, aggs) for q in qs])
    assert (c["groups"], c["group_rows"], c["distinct_rows"],
            c["padded_rows"]) == (2, 10, 8, 4)


class _Prog:
    def __init__(self):
        self._graphs = {}


class _Graph:
    serial = None

    def __init__(self, nbytes, pool):
        self.nbytes = nbytes
        self.pool = pool


def test_counters_over_a_graph_drop():
    """Each graph the book drops for its budget counts once, beside its
    `dropped` attribute."""
    pools = iter(range(1, 100))
    book = pcompile._GraphBook(lambda: next(pools), budget=100)
    progs = [_Prog() for _ in range(3)]
    for B, p in enumerate(progs):
        g = p._graphs[B] = _Graph(40, book.pool)
        book.add(p, B, g, 0)
    assert book.dropped == stats.counters["graph_drops"] == 1
    assert progs[0]._graphs == {}


def test_counters_over_captures_and_replays(monkeypatch):
    """_replayed counts a capture at a key's first use and a replay at
    every call."""
    class Step:
        def __init__(self, device, ins, fn, keep):
            self.ins, self.fn, self.grown = ins, fn, 0
            self.book = self

        def add(self, *a):
            pass

        def replay(self, clone=()):
            return self.fn(None)

    monkeypatch.setattr(pcompile, "_StepGraph", Step)
    owner = _Prog()
    owner.device = torch.device("cpu")
    for v in (1, 2, 3):
        out = pcompile._replayed(owner, 4, lambda: [[0]],
                                 lambda ins, v=v: ins.__setitem__(0, [v]),
                                 lambda ins, _: ins[0][0], keep=())
        assert out == v
    assert stats.counters["graph_captures"] == 1
    assert stats.counters["graph_replays"] == 3


def test_span_tables_are_per_thread_and_summed():
    """Spans of many threads land in their own tables, and span_table sums
    them with no lost update."""
    import sys
    n_threads, n = 12, 400
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        stats._switch(1)
        try:
            def work():
                for _ in range(n):
                    with stats.span("tat.test"):
                        pass
            ts = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in ts)
        finally:
            stats._switch(-1)
    finally:
        sys.setswitchinterval(old)
    count, seconds = stats.span_table()["tat.test"]
    assert count == n_threads * n and seconds > 0
    stats.reset_spans()
    assert stats.span_table() == {}
