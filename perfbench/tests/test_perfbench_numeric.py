"""The reference answers every numeric field type of the port's schema
(u64, i64, date, f64) by the port's declared semantics: exact f64 sums
rounded once, f64 averages, exact f64 histogram keys, signed sums and
order. A configuration of f64 and signed fields, its generator, a mix
and a cell are added as files only (perfbench/tests/numeric/, copied
into the checkout's copy) and judged against the port on the CPU, the
port's oracle and the control."""

import json
import math
import shutil
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest

from perfbench import control
from perfbench.lib import dsl, harness, spec
from perfbench.lib.traffic_gen import Pool
from perfbench.reference.engine import Reference

from conftest import DOCS

NUMERIC = Path(__file__).resolve().parent / "numeric"
CELL = "numeric_probe.numeric-probe"
#: the templates of the mix that read no f64 field
NO_F64 = {"i64"}


@pytest.fixture
def numeric_root(bench_root):
    """The checkout's copy with the numeric configuration, generator and
    mix added as files, and a cell for them added to BENCHMARK.json."""
    shutil.copytree(NUMERIC, bench_root / "perfbench", dirs_exist_ok=True)
    b = json.loads((bench_root / "BENCHMARK.json").read_text())
    b["configs"].append({
        "name": "numeric_probe", "source": "test only",
        "file": "perfbench/configs/numeric_probe.json", "reduced": [],
        "why": "f64 and i64 fields in every reference kind"})
    b["workloads"].append({
        "name": CELL, "config": "numeric_probe", "traffic": "numeric-probe",
        "chips": 1, "why": "one client, closed loop, the mix's templates"
                           " in turn"})
    for m in b["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append(CELL)
    (bench_root / "BENCHMARK.json").write_text(json.dumps(b))
    return bench_root


def _sampled(root, seed):
    bench = spec.load_benchmark(root)
    cfg = spec.config(bench, "numeric_probe", root)
    pool = Pool(spec.mix("numeric-probe", root), seed)
    return cfg, [pool.requests[pool.keys.index(k)] for k in pool.check_keys]


def test_run_is_correct(numeric_root):
    r = harness.run_cell(CELL, 2**31 + 99, 1.0, False, device="cpu",
                         docs=DOCS, root=numeric_root)
    assert r["correct"] is True
    assert r["checks"]["mismatched_answers"]["value"] == 0
    assert r["checks"]["templates_unchecked"]["value"] == 0


@pytest.mark.parametrize("seed", [3, 2**31 + 12345])
def test_port_oracle_and_reference_agree(numeric_root, seed):
    import tantivy_aggregations_tpu_torch as tt
    cfg, reqs = _sampled(numeric_root, seed)
    idx, cols = harness.build_index(tt, cfg, DOCS, seed, numeric_root)
    searcher = idx.searcher(device="cpu")
    oracle = idx.oracle_searcher()
    ref = Reference(cols, DOCS)
    mix = spec.mix("numeric-probe", numeric_root)
    assert {r["name"] for r in reqs} == {t["name"] for t in mix["requests"]}
    for r in reqs:
        q, a = dsl.query(tt, r["query"]), dsl.aggs(tt, r["aggs"])
        want = ref.answer(r)
        assert searcher.agg_search(q, a) == want, r
        assert oracle.agg_search(q, a) == want, r


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails_the_f64_requests(numeric_root, seed):
    r = control.readings(CELL, seed, docs=DOCS, root=numeric_root)
    assert r["exact_mismatched"] == 0
    assert r["mismatched_answers"] > 0
    cfg, reqs = _sampled(numeric_root, seed)
    cols = spec.generator(cfg["generator"], numeric_root)(DOCS, seed,
                                                         cfg["params"])
    exact, lossy = Reference(cols, DOCS), Reference(cols, DOCS, lossy=True)
    for req in reqs:
        if req["name"] not in NO_F64:
            assert lossy.answer(req) != exact.answer(req), req["name"]


# -- the semantics, against plain Python -------------------------------------

def _f64_column(rng, n):
    v = (rng.integers(-(1 << 53) + 1, 1 << 53, n).astype(np.float64)
         * np.exp2(rng.integers(-70, 70, n).astype(np.float64)))
    v[::7] = np.round(rng.lognormal(2.0, 1.0, v[::7].size), 2)
    v[::11] = -0.0
    v[3] = 5e-324
    return v


def _exact(v, w) -> float:
    """The rational sum of w * v rounded once to the nearest f64."""
    return float(sum((Fraction(float(a)) * int(b) for a, b in zip(v, w)),
                     Fraction(0)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_f64_sum_is_the_exact_sum_rounded_once(seed):
    rng = np.random.default_rng(seed)
    v = _f64_column(rng, 3000)
    ref = Reference({"x": {"type": "f64", "values": v}}, v.size)
    w = rng.integers(0, 4, v.size)
    keys = rng.integers(0, 5, v.size)
    assert ref.sums("x", w) == [_exact(v, w)]
    got = ref.sums("x", w, keys, 5)
    assert got == [_exact(v[keys == k], w[keys == k]) for k in range(5)]
    # avg: the rounded sum over the count in f64
    s, n = ref.sums("x", w)[0], int(w.sum())
    assert ref.agg({"avg": {"field": "x"}}, w) == {"value": s / n, "sum": s,
                                                   "count": n}


def test_f64_sum_zeros_and_refusals():
    z = np.array([-0.0, -0.0, 1.5, -1.5])
    ref = Reference({"x": {"type": "f64", "values": z}}, 4)
    one = np.ones(4, np.int64)
    for w in (one, np.zeros(4, np.int64), np.array([1, 1, 0, 0])):
        s = ref.agg({"sum": {"field": "x"}}, w)["value"]
        assert s == 0.0 and math.copysign(1, s) == 1
    assert ref.agg({"avg": {"field": "x"}}, np.zeros(4, np.int64)) == {
        "value": None, "sum": 0.0, "count": 0}
    assert ref.agg({"stats": {"field": "x"}}, np.zeros(4, np.int64)) == {
        "count": 0, "sum": 0.0, "min": None, "max": None, "avg": None}
    none = Reference({"x": {"type": "f64", "offsets": np.zeros(4, np.uint32),
                            "values": np.zeros(0)}}, 3)
    assert none.agg({"stats": {"field": "x"}}, np.ones(3, np.int64)) == {
        "count": 0, "sum": 0.0, "min": None, "max": None, "avg": None}
    for bad in (np.nan, np.inf):
        r = Reference({"x": {"type": "f64", "values": np.array([1.0, bad])}},
                      2)
        with pytest.raises(ValueError):
            r.agg({"sum": {"field": "x"}}, np.ones(2, np.int64))


def test_counts_refuse_weights_past_exact():
    keys = np.zeros(4, np.int64)
    assert Reference.counts(keys, np.full(4, 1 << 50), 1).tolist() == [
        1 << 52]
    with pytest.raises(OverflowError):
        Reference.counts(keys, np.full(4, 1 << 51), 1)


def test_i64_sums_and_order_are_signed():
    rng = np.random.default_rng(5)
    v = rng.integers(-5000, 5000, 4000, dtype=np.int64)
    v[:3] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, -1]
    ref = Reference({"x": {"type": "i64", "values": v}}, v.size)
    w = rng.integers(0, 3, v.size)
    exact = sum(int(a) * int(b) for a, b in zip(v, w))
    assert ref.agg({"sum": {"field": "x"}}, w) == {"value": exact}
    assert ref.agg({"avg": {"field": "x"}}, w)["value"] == float(
        Fraction(exact, int(w.sum())))
    keys = rng.integers(0, 4, v.size)
    assert ref.sums("x", w, keys, 4) == [
        sum(int(a) * int(b) for a, b in zip(v[keys == k], w[keys == k]))
        for k in range(4)]
    order, vals = ref.sorted_rows("x")
    assert (np.diff(vals) >= 0).all() and vals[0] == np.iinfo(np.int64).min
    p = ref.agg({"percentiles": {"field": "x", "percents": [0.0, 100.0]}},
                np.ones(v.size, np.int64))["values"]
    assert p == {"0.0": float(v.min()), "100.0": float(v.max())}


@pytest.mark.parametrize("interval,offset", [(0.1, 0), (1, 0), (0.1, 0.05),
                                             (0.3, -0.2), (2.5, 1)])
def test_f64_histogram_keys_are_exact(interval, offset):
    """floor((v - offset) / interval) with v, interval and offset as the
    rationals they are, on values at and beside the bounds."""
    k = np.arange(-200, 200)
    v = np.concatenate([k / 10, k * 0.1, np.nextafter(k / 10, -np.inf),
                        np.nextafter(k / 10, np.inf), k * 0.3, [-0.0, 0.0]])
    ref = Reference({"x": {"type": "f64", "values": v}}, v.size)
    got = ref.bucket_keys("x", interval, offset, np.ones(v.size, bool))
    want = [int((Fraction(float(x)) - Fraction(offset)) // Fraction(interval))
            for x in v]
    assert got.tolist() == want
    h = ref.agg({"histogram": {"field": "x", "interval": interval,
                               "offset": offset}}, np.ones(v.size, np.int64))
    keys = [b["key"] for b in h["buckets"]]
    assert keys == sorted(keys)
    assert keys == [float(Fraction(offset) + j * Fraction(interval))
                    for j in sorted(set(want))]
