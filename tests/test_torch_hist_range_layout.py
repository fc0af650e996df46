"""f64 histograms laid out over their query's range (aggs/compile.py
`_range_layout`): where an f64 column spans more than MAX_HIST_NB buckets
and the root query bounds the histogram's field by a range (a root
RangeQuery, or one among a root BooleanQuery's must), the port lays the
buckets out over the range's span, clipped to the column's, and answers on
the device; the range's bounds then key the shape's programs.

The JAX package has no such layout: it answers these shapes on its exact
host path, so here the port's plan differs from its plan on purpose.
Every answer is held `==` the port's oracle and the JAX package's. The
JAX package's searcher plans each wide shape for about ten seconds before
it falls back (it builds the column's bounds first), so it answers two
shapes here; the other cases are held against its oracle, which is the
host path its searcher falls back to."""

import numpy as np
import pytest
import torch

import tantivy_aggregations_tpu as tat

import tantivy_aggregations_tpu_torch as tt
from tantivy_aggregations_tpu_torch.aggs import compile as pcompile
from tantivy_aggregations_tpu_torch.aggs import ir as agg_ir
from tantivy_aggregations_tpu_torch.models import flagship as F
from tantivy_aggregations_tpu_torch.query import ir as query_ir
from tantivy_aggregations_tpu_torch.searcher import _HostFallback
from tantivy_aggregations_tpu_torch.utils import stats

torch.set_num_threads(2)

N = 3000
#: the far outlier: the distance column spans more than 2^20 unit buckets
FAR = 1_100_000.0


def _columns(seed=5):
    """Trip-like f64 columns: distances in cents of a mile with rows on
    the range's and the buckets' bounds, zeros, -0.0, negatives and one
    far outlier; amounts with refunds, -0.0 and a few large ones; a
    keyword and a multi-valued f64 field."""
    rng = np.random.default_rng(seed)
    d = np.round(rng.lognormal(np.log(1.7), 0.9, N), 2)
    edges = [0.0, -0.0, 50.0, 49.99, 50.01, 1.0, 2.0, 3.0, 9.0, 10.0,
             np.nextafter(10.0, 0.0), np.nextafter(1.0, 2.0), -3.5, -5.0,
             -0.01, 0.01, 120.5, FAR]
    d[:len(edges)] = edges
    d[rng.random(N) < 0.02] = 0.0
    a = np.round(rng.lognormal(np.log(11.8), 0.6, N), 2)
    a[rng.random(N) < 0.03] *= -1
    a[::101] = -0.0
    a[7] = 4321.09
    offs = np.zeros(N + 1, np.uint32)
    np.cumsum(rng.integers(0, 3, N), out=offs[1:])
    m = np.round(rng.lognormal(1.0, 1.0, int(offs[-1])), 2)
    m[:1] = FAR
    return {"trip_distance": d, "total_amount": a,
            "vendor": np.array(["cmt", "vts"], object)[
                rng.integers(0, 2, N)],
            "fares": (offs, m)}


def _build(pkg):
    from importlib import import_module
    card = import_module(pkg.__name__ + ".schema").Cardinality
    b = pkg.SchemaBuilder()
    b.add_f64_field("trip_distance")
    b.add_f64_field("total_amount")
    b.add_keyword_field("vendor")
    b.add_f64_field("fares", cardinality=card.MULTI)
    idx = pkg.Index.create_in_ram(b.build())
    w = idx.writer()
    cols = _columns()
    offs, m = cols["fares"]
    for lo, hi in ((0, N // 2), (N // 2, N)):
        w.add_documents_columnar({
            "trip_distance": cols["trip_distance"][lo:hi],
            "total_amount": cols["total_amount"][lo:hi],
            "vendor": cols["vendor"][lo:hi],
            "fares": (offs[lo:hi + 1] - offs[lo],
                      m[int(offs[lo]):int(offs[hi])])}, hi - lo)
        w.commit()
    return idx


@pytest.fixture(scope="module")
def env():
    pidx, jidx = _build(tt), _build(tat)
    return {"port": pidx.searcher(device="cpu"),
            "oracle": pidx.oracle_searcher(), "jax": jidx.searcher(),
            "jax_oracle": jidx.oracle_searcher()}


@pytest.fixture(autouse=True)
def _clean():
    stats.reset_counters()


def _aggs(pkg, field="trip_distance", interval=1.0, offset=0.0):
    return {"h": pkg.histogram_agg(field, interval, offset, sub_aggs={
        "st": pkg.stats_agg("total_amount"),
        "s": pkg.sum_agg("total_amount"),
        "a": pkg.avg_agg("total_amount")})}


def _range(pkg, field="trip_distance", **kw):
    return pkg.RangeQuery(field, **kw)


def _answers(env, make_query, aggs=_aggs, jax=False):
    """The port's answer, held == the port's oracle and the JAX package
    (its searcher where `jax`, else its oracle)."""
    pq, pa = make_query(tt), aggs(tt)
    got = env["port"].agg_search(pq, pa)
    assert got == env["oracle"].agg_search(pq, pa)
    other = env["jax" if jax else "jax_oracle"]
    assert got == other.agg_search(make_query(tat), aggs(tat))
    return got


def _plan(env, make_query, aggs=_aggs):
    return env["port"]._program_for(make_query(tt), aggs(tt))


def test_track_request_runs_on_the_device(env):
    """Rally nyc_taxis' distance_amount_agg: a bool filter 0 <= distance <
    50, a histogram at interval 1 with stats per bucket."""
    def q(pkg):
        return pkg.BooleanQuery(must=[_range(pkg, lower=0.0, upper=50.0)])
    got = _answers(env, q, jax=True)
    assert [b["key"] for b in got["h"]["buckets"]][:3] == [0.0, 1.0, 2.0]
    assert got["h"]["buckets"][-1]["key"] == 49.0
    assert stats.counters["host_fallbacks"] == 0
    assert stats.counters["hist_range_layouts"] == 1
    prog = _plan(env, q)
    assert not isinstance(prog, _HostFallback)
    p = prog.plan[("a", "h")]
    assert p["nb"] == 50 and p["k_min"] == 0 and "range" in p
    assert stats.counters["programs_planned"] == 1


def test_range_beside_a_term_clause(env):
    def q(pkg):
        return pkg.BooleanQuery(must=[
            pkg.TermQuery("vendor", "vts"),
            _range(pkg, lower=-5.0, upper=10.0, include_upper=True)])
    got = _answers(env, q, jax=True)
    keys = [b["key"] for b in got["h"]["buckets"]]
    assert -5.0 <= keys[0] and keys[-1] <= 10.0
    assert stats.counters["host_fallbacks"] == 0


@pytest.mark.parametrize("lower,upper,inc_lo,inc_hi", [
    (0.0, 50.0, True, False), (0.0, 50.0, False, True),
    (0.0, 50.0, False, False), (0.0, 50.0, True, True),
    (-0.0, 10.0, True, True), (-0.0, 10.0, False, False),
    (-5.0, -0.0, True, True), (-5.0, 0.0, True, False),
    (1.0, 10.0, True, False), (np.nextafter(1.0, 2.0), 3.0, True, True),
    (-3.5, 49.99, False, True), (49.99, 50.01, True, True),
    (10, 20, True, False)])
def test_bounds_on_rows_and_bucket_edges(env, lower, upper, inc_lo,
                                         inc_hi):
    def q(pkg):
        return _range(pkg, lower=lower, upper=upper, include_lower=inc_lo,
                      include_upper=inc_hi)
    _answers(env, q)
    assert stats.counters["host_fallbacks"] == 0
    assert "range" in _plan(env, q).plan[("a", "h")]


@pytest.mark.parametrize("interval,offset", [(0.5, 0.0), (0.25, 0.125),
                                             (0.1, 0.05)])
def test_other_intervals_and_offsets(env, interval, offset):
    def q(pkg):
        return pkg.BooleanQuery(must=[_range(pkg, lower=-1.0, upper=30.0)])

    def aggs(pkg):
        return _aggs(pkg, interval=interval, offset=offset)
    _answers(env, q, aggs)
    assert stats.counters["host_fallbacks"] == 0
    assert "range" in _plan(env, q, aggs).plan[("a", "h")]


def test_one_sided_and_empty_ranges(env):
    """A range whose other end is the column's (upper only), and ranges
    that match nothing (past the column, or empty) still plan."""
    for kw in ({"upper": 12.0}, {"lower": 3e7}, {"lower": 5.0, "upper": 5.0},
               {"lower": 9.0, "upper": 2.0}):
        def q(pkg, kw=kw):
            return _range(pkg, **kw)
        got = _answers(env, q)
        if "lower" in kw:
            assert got["h"]["buckets"] == []
    assert stats.counters["host_fallbacks"] == 0


def test_programs_are_keyed_by_the_bounds(env):
    """Two bounds of one shape plan two programs; a request with bounds
    already seen reuses its program; the shape's bounds that normalize
    alike (-0.0 and 0.0) share one. The shape is one entry of the
    searcher's program cache, its programs inside it."""
    port = env["port"].index.searcher(device="cpu")
    aggs = _aggs(tt)
    want = env["oracle"]
    for lo, hi in ((0.0, 50.0), (0.0, 20.0), (0.0, 50.0), (-0.0, 20.0)):
        q = tt.RangeQuery("trip_distance", lower=lo, upper=hi)
        assert port.agg_search(q, aggs) == want.agg_search(q, aggs)
    assert stats.counters["programs_planned"] == 2
    (entry,) = port._programs.values()
    assert entry.fields == ("trip_distance",)
    assert len(entry.programs) == 2


def test_distinct_ranges_leave_bounded_device_state(env):
    """Dashboards change the bounds: ten distinct ranges of one shape
    keep the newest `_max_range_programs` programs, the bucket planes of
    the others go with them, and nothing of any range is cached on the
    column or the device index."""
    import gc
    import weakref
    port = env["port"].index.searcher(device="cpu")
    aggs = _aggs(tt)
    planes = []
    for i in range(10):
        q = tt.BooleanQuery(must=[tt.RangeQuery(
            "trip_distance", lower=float(i), upper=float(20 + i))])
        assert port.agg_search(q, aggs) == env["oracle"].agg_search(q, aggs)
        prog = port._program_for(q, aggs)
        planes.append(weakref.ref(prog._arrays[prog.plan[("a", "h")]
                                              ["bid_key"]]))
        del prog
    (entry,) = port._programs.values()
    assert len(entry.programs) == port._max_range_programs == 4
    assert stats.counters["programs_planned"] == 10
    assert stats.counters["programs_evicted"] == 6
    assert stats.counters["host_fallbacks"] == 0
    gc.collect()
    assert [r() is not None for r in planes] == [False] * 6 + [True] * 4
    dindex = port._get_device_index()
    col = dindex.column("trip_distance")
    assert not any("range" in str(k) for k in col._bid_cache or ())
    assert not any("range" in str(k) for k in dindex.cube_cache)


def test_range_plane_is_the_host_bucket_ids(env):
    """The bucket plane worked out on the device from the column's planes
    is the host's exact bucket ids, row for row."""
    def q(pkg):
        return _range(pkg, lower=-3.5, upper=49.99, include_lower=False)
    prog = _plan(env, q)
    p = prog.plan[("a", "h")]
    col = env["port"]._get_device_index().column("trip_distance")
    want = pcompile.Program._host_bucket_ids(col, p)
    got = prog._arrays[p["bid_key"]]
    assert got.dtype == torch.int32
    assert got.cpu().numpy().tolist() == want.tolist()


def test_sums_and_wide_layouts_under_a_range(env):
    """Count and sum subs alone (which elsewhere take the cube) plan dense
    over the program's own plane; 310 buckets, past the dense budget, plan
    scatter (elsewhere the prefix path)."""
    def q(pkg):
        return pkg.BooleanQuery(must=[_range(pkg, lower=-1.0, upper=30.0)])

    def sums(pkg):
        return {"h": pkg.histogram_agg("trip_distance", 1.0, sub_aggs={
            "n": pkg.count_agg(), "s": pkg.sum_agg("total_amount")})}

    def wide(pkg):
        return _aggs(pkg, interval=0.1)
    for aggs, mode in ((sums, "dense"), (wide, "scatter")):
        _answers(env, q, aggs)
        p = _plan(env, q, aggs).plan[("a", "h")]
        assert (p["mode"], "cube" in p) == (mode, False)
    assert stats.counters["host_fallbacks"] == 0


#: case: (query, histogram args, its subs) -> the calls expected of the
#: per-bucket extremes: dense_bucket_extremes_mm (one kernel launch on the
#: card), dense_bucket_min, dense_bucket_max
EXTREMES_ROUTES = {
    # the track body: stats over the static range-laid-out plane (ctx.mm)
    "track stats": ((0.0, 50.0), ("trip_distance", 1.0),
                    lambda pkg: {"st": pkg.stats_agg("total_amount")},
                    (1, 0, 0)),
    # a min node and a max node beside each other: a launch each
    "min and max nodes": ((0.0, 50.0), ("trip_distance", 1.0),
                          lambda pkg: {"lo": pkg.min_agg("total_amount"),
                                       "hi": pkg.max_agg("total_amount")},
                          (2, 0, 0)),
    # a multi-valued field: its min and max planes in one launch
    "multi-valued stats": ((0.0, 50.0), ("trip_distance", 1.0),
                           lambda pkg: {"st": pkg.stats_agg("fares")},
                           (1, 0, 0)),
    # 310 buckets, past the dense budget: the scatter mode plans no ctx.mm
    "scatter stats": ((-1.0, 30.0), ("trip_distance", 0.1),
                      lambda pkg: {"st": pkg.stats_agg("total_amount")},
                      (0, 1, 1)),
    # a histogram nested under terms: a composite slot plane, no ctx.mm
    "nested stats": (None, ("total_amount", 100.0),
                     lambda pkg: {"st": pkg.stats_agg("trip_distance")},
                     (0, 1, 1)),
}


@pytest.mark.parametrize("case", list(EXTREMES_ROUTES))
def test_bucket_extremes_take_the_dense_kernel_over_a_static_plane(
        env, monkeypatch, case):
    """`_eval_metric`'s per-bucket min and max: over a dense node's static
    bucket plane (ctx.mm) one dense_bucket_extremes_mm call per metric
    node (the dense_extremes kernel on the card), both extremes of a
    stats in it; every other bucket context keeps dense_bucket_min /
    dense_bucket_max. Answers == the port's oracle == the JAX package's."""
    rng, (field, interval), subs, want = EXTREMES_ROUTES[case]
    calls = {}

    def spy(name):
        fn = getattr(pcompile.R, name)

        def counted(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        monkeypatch.setattr(pcompile.R, name, counted)
    for name in ("dense_bucket_extremes_mm", "dense_bucket_min",
                 "dense_bucket_max"):
        spy(name)

    def q(pkg):
        if rng is None:
            return pkg.MatchAllQuery()
        return pkg.BooleanQuery(must=[_range(pkg, lower=rng[0],
                                             upper=rng[1])])

    def aggs(pkg):
        h = pkg.histogram_agg(field, interval, sub_aggs=subs(pkg))
        if rng is None:
            return {"t": pkg.terms_agg("vendor", 2, sub_aggs={"h": h})}
        return {"h": h}
    got = _answers(env, q, aggs)
    assert got
    assert tuple(calls.get(n, 0) for n in (
        "dense_bucket_extremes_mm", "dense_bucket_min",
        "dense_bucket_max")) == want
    assert stats.counters["host_fallbacks"] == 0


def test_percentiles_under_a_range_layout_fall_back(env):
    """Percentiles would cache a slot plane per range on the index: the
    shape answers on the host path, and the reason says why."""
    def q(pkg):
        return _range(pkg, lower=0.0, upper=50.0)

    def aggs(pkg):
        return {"h": pkg.histogram_agg("trip_distance", 1.0, sub_aggs={
            "p": pkg.percentiles_agg("total_amount", [50.0])})}
    _answers(env, q, aggs)
    prog = _plan(env, q, aggs)
    assert isinstance(prog, _HostFallback)
    assert "laid out over its query's range" in prog.reason


def test_a_range_too_wide_still_falls_back(env):
    def q(pkg):
        return _range(pkg, lower=0.0, upper=FAR + 1)
    port = env["port"].index.searcher(device="cpu")
    pq, pa = q(tt), _aggs(tt)
    assert port.agg_search(pq, pa) == env["oracle"].agg_search(pq, pa)
    prog = port._program_for(pq, pa)
    assert isinstance(prog, _HostFallback)
    assert "over its query's range on 'trip_distance'" in prog.reason
    assert stats.counters["host_fallbacks"] == 2
    # and without a range the column's span names the column's buckets
    prog = port._program_for(tt.MatchAllQuery(), pa)
    assert isinstance(prog, _HostFallback)
    assert prog.reason == ("f64 histogram would span 1100006 buckets on "
                           "device")


def test_host_fallback_off_raises_where_the_device_cannot_answer(env):
    """EngineConfig(host_fallback=False): the range-laid-out histogram
    answers on the device as before; a range too wide for the device
    raises, naming the planner's reason, and nothing takes the host
    path."""
    from tantivy_aggregations_tpu_torch.engine_config import EngineConfig
    port = env["port"].index.searcher(
        device="cpu", config=EngineConfig(host_fallback=False))

    def q(pkg):
        return pkg.BooleanQuery(must=[_range(pkg, lower=0.0, upper=50.0)])
    pq, pa = q(tt), _aggs(tt)
    assert port.agg_search(pq, pa) == env["oracle"].agg_search(pq, pa)
    wide = _range(tt, lower=0.0, upper=FAR + 1)
    for _ in range(2):  # planned, then cached: both raise
        with pytest.raises(NotImplementedError,
                           match="over its query's range on "
                                 "'trip_distance'.*host_fallback is off"):
            port.agg_search(wide, pa)
    assert stats.counters["host_fallbacks"] == 0


def test_where_the_range_bounds_nothing_the_column_layout_stays(env):
    """A range under should, under must_not or on another field, and a
    multi-valued field (whose docs hold values outside the range), keep
    the column's layout: too wide, so the host path."""
    cases = [
        (tt.BooleanQuery(should=[tt.RangeQuery("trip_distance", lower=0.0,
                                               upper=50.0)]), _aggs(tt)),
        (tt.BooleanQuery(must_not=[tt.RangeQuery("trip_distance",
                                                 lower=50.0)]), _aggs(tt)),
        (tt.RangeQuery("total_amount", lower=0.0, upper=50.0), _aggs(tt)),
        (tt.RangeQuery("fares", lower=0.0, upper=50.0),
         {"h": tt.histogram_agg("fares", 1.0)}),
    ]
    port = env["port"].index.searcher(device="cpu")
    for q, a in cases:
        assert pcompile.range_layout_fields(
            port._get_device_index(), q, a) == ()
        assert isinstance(port._program_for(q, a), _HostFallback)
        assert port.agg_search(q, a) == env["oracle"].agg_search(q, a)
    assert stats.counters["hist_range_layouts"] == 0


def test_range_layout_on_a_mesh(env):
    """The same layout on every shard of a 2-shard CPU mesh."""
    s = env["port"].index.searcher(mesh=tt.make_mesh(devices=["cpu"] * 2))

    def q(pkg):
        return pkg.BooleanQuery(must=[_range(pkg, lower=0.0, upper=50.0)])
    pq, pa = q(tt), _aggs(tt)
    assert s.agg_search(pq, pa) == env["oracle"].agg_search(pq, pa)
    assert stats.counters["host_fallbacks"] == 0
    assert stats.counters["hist_range_layouts"] == 2


def test_shapes_that_plan_today_keep_their_key():
    """c1-c5 read no range layout: their programs are keyed by their
    structural keys alone, their plans carry no range."""
    ix = tt.Index.create_in_ram(F.bench_schema())
    w = ix.writer()
    w.add_documents_columnar(F.generate_bench_columns(3000, 42), 3000)
    w.commit()
    s = ix.searcher(device="cpu")
    keys = []
    for _, q, a in F.judged_configs():
        assert s.agg_search(q, a) == ix.oracle_searcher().agg_search(q, a)
        assert pcompile.range_layout_fields(s._get_device_index(), q,
                                            a) == ()
        keys.append((query_ir.structural_key(q), agg_ir.structural_key(a)))
    assert list(s._programs) == keys
    assert not any("range" in p for prog in s._programs.values()
                   for p in prog.plan.values() if isinstance(p, dict))
    assert stats.counters["hist_range_layouts"] == 0
