"""The `nyc_taxis` configuration and its cell `nyc_taxis.rally-aggs` on
the CPU: a run is correct, the port (on its device path), its oracle and
the reference give the same answers to both track bodies, the control
fails the cell, the generator's tail of impossible distances is there,
and the reference's date histograms give the keys worked out by hand."""

import datetime as dt

import numpy as np
import pytest

from perfbench import control
from perfbench.lib import dsl, harness, spec
from perfbench.lib.traffic_gen import Pool
from perfbench.reference.engine import Reference

from conftest import DOCS

CELL = "nyc_taxis.rally-aggs"
BENCH = spec.load_benchmark()
CFG = spec.config(BENCH, "nyc_taxis")


def _us(*ymdhms) -> int:
    return int(dt.datetime(*ymdhms, tzinfo=dt.timezone.utc).timestamp()
               * 1_000_000)


def test_run_is_correct(bench_root):
    r = harness.run_cell(CELL, 2**31 + 4242, 1.0, False, device="cpu",
                         docs=DOCS, root=bench_root)
    assert r["correct"] is True
    assert r["checks"]["mismatched_answers"]["value"] == 0
    assert r["checks"]["templates_unchecked"]["value"] == 0


@pytest.mark.parametrize("seed", [3, 2**31 + 12345])
def test_both_bodies_on_the_device_path(bench_root, seed):
    """port == oracle == reference for both bodies, and no request takes
    the exact host path: the distance histogram is laid out over its
    range."""
    import tantivy_aggregations_tpu_torch as tt
    from tantivy_aggregations_tpu_torch.utils import stats
    idx, cols = harness.build_index(tt, CFG, DOCS, seed, bench_root)
    assert cols["trip_distance"]["values"].max() > 2**20
    pool = Pool(spec.mix("rally-aggs", bench_root), seed)
    reqs = [pool.requests[pool.keys.index(k)] for k in pool.check_keys]
    assert sorted(r["name"] for r in reqs) == ["date_histogram_agg",
                                               "distance_amount_agg"]
    searcher, oracle = idx.searcher(device="cpu"), idx.oracle_searcher()
    ref = Reference(cols, DOCS)
    stats.reset_counters()
    got = {}
    for r in reqs:
        q, a = dsl.query(tt, r["query"]), dsl.aggs(tt, r["aggs"])
        got[r["name"]] = ref.answer(r)
        assert searcher.agg_search(q, a) == got[r["name"]], r["name"]
        assert oracle.agg_search(q, a) == got[r["name"]], r["name"]
    assert stats.counters["host_fallbacks"] == 0
    assert stats.counters["hist_range_layouts"] == 1
    days = got["date_histogram_agg"]["dropoffs_over_time"]["buckets"]
    assert [b["key"] for b in days] == [_us(2015, 1, d) for d in range(1, 22)]
    hist = got["distance_amount_agg"]["distance_histo"]["buckets"]
    assert hist[0]["key"] == 0.0 and hist[-1]["key"] <= 49.0


def test_a_port_without_the_range_layout_fails_the_run_at_once(
        bench_root, monkeypatch):
    """The configuration turns the host path off: where the port cannot
    lay the distance histogram out over its range, the run stops at its
    first distance request instead of answering it on the host."""
    from tantivy_aggregations_tpu_torch.aggs import compile as C
    assert CFG["engine_config"] == {"host_fallback": False}
    monkeypatch.setattr(C, "_range_layout", lambda *a: None)
    with pytest.raises(NotImplementedError,
                       match="f64 histogram would span .*host_fallback is off"):
        harness.run_cell(CELL, 5, 1.0, False, device="cpu", docs=DOCS,
                         root=bench_root)


@pytest.mark.parametrize("seed", [1, 2])
def test_control_fails_the_cell(bench_root, seed):
    r = control.readings(CELL, seed, docs=DOCS, root=bench_root)
    assert r["requests"] == 2
    assert r["exact_mismatched"] == 0
    assert r["mismatched_answers"] > 0


def test_generator_columns():
    """Cents over 100.0, zeros, refunds and distances in the millions of
    miles, whole seconds, dates mostly in 2015 and a few outside; the
    same seed draws the same columns."""
    cols = spec.generator(CFG["generator"])(DOCS, 7, CFG["params"])
    again = spec.generator(CFG["generator"])(DOCS, 7, CFG["params"])
    for name, c in cols.items():
        assert np.array_equal(c["values"], again[name]["values"])
    for name in ("trip_distance", "total_amount"):
        v = cols[name]["values"]
        assert v.dtype == np.float64 and np.isfinite(v).all()
        assert np.array_equal(np.rint(v * 100) / 100.0, v)
    d = cols["trip_distance"]["values"]
    assert (d >= 0).all() and (d == 0).mean() > 0.005
    assert (d >= 50).sum() >= 1 and d.max() > 2**20
    a = cols["total_amount"]["values"]
    assert (a < 0).any() and np.median(a) == pytest.approx(11.8, rel=0.1)
    t = cols["dropoff_datetime"]["values"]
    assert t.dtype == np.uint64 and (t % 1_000_000 == 0).all()
    in_2015 = (t >= _us(2015, 1, 1)) & (t < _us(2016, 1, 1))
    assert 0.99 < in_2015.mean() < 1


def _dates_ref(values):
    v = np.asarray(values, np.uint64)
    return Reference({"t": {"type": "date", "values": v}}, v.size)


def _keys(ref, **args):
    w = np.ones(ref.n, np.int64)
    h = ref.agg({"date_histogram": {"field": "t", **args}}, w)
    return [(b["key"], b["doc_count"]) for b in h["buckets"]]


def test_date_histogram_fixed_and_calendar_intervals():
    """Keys are period starts in micros, worked out by hand: 2015-01-05
    is a Monday, 2015-01-04 a Sunday."""
    vals = [_us(2015, 1, 4, 23, 59, 59), _us(2015, 1, 5),
            _us(2015, 1, 5, 0, 0, 1), _us(2015, 1, 7, 12, 30, 15),
            _us(2015, 1, 11, 23, 59, 59), _us(2015, 1, 12, 6)]
    ref = _dates_ref(vals)
    assert _keys(ref, calendar_interval="day") == [
        (_us(2015, 1, 4), 1), (_us(2015, 1, 5), 2), (_us(2015, 1, 7), 1),
        (_us(2015, 1, 11), 1), (_us(2015, 1, 12), 1)]
    assert _keys(ref, calendar_interval="week") == [
        (_us(2014, 12, 29), 1), (_us(2015, 1, 5), 4), (_us(2015, 1, 12), 1)]
    assert _keys(ref, calendar_interval="hour")[:3] == [
        (_us(2015, 1, 4, 23), 1), (_us(2015, 1, 5), 2),
        (_us(2015, 1, 7, 12), 1)]
    assert _keys(ref, calendar_interval="minute")[2] == (
        _us(2015, 1, 7, 12, 30), 1)
    # fixed: 12 h periods starting at 06:00; a calendar interval ignores
    # interval_micros and offset
    half = 12 * 3_600_000_000
    assert _keys(ref, interval_micros=half, offset=6 * 3_600_000_000) == [
        (_us(2015, 1, 4, 18), 3), (_us(2015, 1, 7, 6), 1),
        (_us(2015, 1, 11, 18), 1), (_us(2015, 1, 12, 6), 1)]
    assert _keys(ref, calendar_interval="day", interval_micros=half,
                 offset=5) == _keys(ref, calendar_interval="day")


@pytest.mark.parametrize("ci", ["month", "quarter", "year"])
def test_date_histogram_refuses_unequal_periods(ci):
    ref = _dates_ref([_us(2015, 1, 4)])
    with pytest.raises(NotImplementedError, match=ci):
        _keys(ref, calendar_interval=ci)


@pytest.mark.parametrize("args", [
    {"calendar_interval": "week"}, {"calendar_interval": "hour"},
    {"interval_micros": 7 * 3_600_000_000, "offset": 123_000_000}])
def test_date_histogram_matches_the_port(args):
    import tantivy_aggregations_tpu_torch as tt
    rng = np.random.default_rng(11)
    v = (_us(2014, 12, 20) + rng.integers(0, 40 * 86_400, 3000)
         * 1_000_000).astype(np.uint64)
    b = tt.SchemaBuilder()
    b.add_date_field("t")
    idx = tt.Index.create_in_ram(b.build())
    w = idx.writer()
    w.add_documents_columnar({"t": v}, v.size)
    w.commit()
    node = {"date_histogram": {"field": "t", **args}}
    want = _dates_ref(v).agg(node, np.ones(v.size, np.int64))
    got = idx.searcher(device="cpu").agg_search(
        tt.MatchAllQuery(), dsl.aggs(tt, {"h": node}))
    assert got == {"h": want}
