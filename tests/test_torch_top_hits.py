"""top_hits in the PyTorch port, on the CPU: flat (the first k matched
docs of a static (sort key, doc) order) and in-slot (one stable sort per
query by composite slot; one hit per (slot, doc) over value rows). Each
request's fruits from the port at its default EngineConfig == the port in
row modes == the oracle == the JAX package (Pallas in interpret mode), with
plan parity (`assert_phase2_parity`): score order, ascending and
descending over u64, i64, f64 and date fields, the wide column whose
minimum's descending key is I64_MAX, deleted docs, ties broken on the
global doc id; under dense and scatter terms, under a histogram and under
a multi-valued terms agg; the huge-bucket shapes that answer on the host
path in both. Every comparison is exact."""

import pytest
import torch

import tantivy_aggregations_tpu as tat

import tantivy_aggregations_tpu_torch as tt

from test_cross_mode import build_random
from test_torch_multi_query import build_multi, engines, persist, to_port
from test_torch_phase2 import bench_index, check, plan_of

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def rnd(tmp_path_factory):
    """build_random: u64 u over 2^40 (wide), i64 i, f64 f, date ts,
    keyword k (card 40) and multi-valued tags; key003's docs deleted."""
    return engines(persist(build_random(91, n=500),
                           str(tmp_path_factory.mktemp("th") / "r")))


@pytest.fixture(scope="module")
def scatter(tmp_path_factory):
    """The same index at dense_nb=8: terms over k (40 terms) scatter."""
    return engines(persist(build_random(92, n=500),
                           str(tmp_path_factory.mktemp("th") / "s")),
                   dense_nb=8)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return engines(bench_index(str(tmp_path_factory.mktemp("th") / "b"),
                               n=3000))


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    return engines(build_multi(str(tmp_path_factory.mktemp("th") / "d"),
                               n=500, seed=15, tails=False))


_QUERIES = [tat.MatchAllQuery(), tat.TermQuery("k", "key010"),
            tat.RangeQuery("i", lower=-2**33, upper=2**34),
            tat.RangeQuery("u", lower=2**62)]  # the last matches nothing


@pytest.mark.parametrize("field,ascending", [
    (None, False), ("u", False), ("u", True), ("i", False), ("i", True),
    ("f", False), ("f", True), ("ts", False), ("ts", True)])
def test_flat(rnd, field, ascending):
    aggs = {"h": tat.top_hits_agg(7, field, ascending),
            "n": tat.count_agg()}
    for q in _QUERIES:
        check(rnd, q, aggs, "device")
    p = plan_of(rnd, q, aggs, ("a", "h"))
    assert not p["in_slot"] and bool(p.get("score")) == (field is None)


def test_flat_sentinel_collision(tmp_path):
    """JAX tests/test_features.py's case: the column minimum's descending
    key ~rm equals I64_MAX on a wide column; matched-ness must stay an
    explicit key."""
    idx = tat.Index.create_in_ram(tat.SchemaBuilder().add_u64_field("v")
                                  .build())
    w = idx.writer()
    for v in (2**40, 0, 3):
        w.add_document({"v": v})
    w.commit()
    env = engines(persist(idx, str(tmp_path / "s")))
    q = tat.RangeQuery("v", upper=5, include_upper=True)
    r = check(env, q, {"h": tat.top_hits_agg(2, "v", ascending=False)},
              "device")
    assert [h["doc"] for h in r["h"]["hits"]] == [2, 1]
    r = check(env, q, {"h": tat.top_hits_agg(3, "v", ascending=True)},
              "device")
    assert [h["doc"] for h in r["h"]["hits"]] == [1, 2]


def test_ties_break_on_the_global_doc_id(bench):
    """qty holds 100 values over 3000 docs in 2 segments: every k-th hit
    ties with many; the tie-break is the global doc id, across segments."""
    for asc in (False, True):
        aggs = {"h": tat.top_hits_agg(40, "qty", asc)}
        for q in (tat.MatchAllQuery(), tat.TermQuery("status", "pending")):
            check(bench, q, aggs, "device")


def test_bench_shapes(bench):
    """h1-h5 of the smoke run's select path."""
    R = tat.RangeQuery("amount", lower=150, upper=8900, include_upper=True)
    for aggs in (
            {"h": tat.top_hits_agg(10, "amount", False)},
            {"t": tat.terms_agg("status", 4, sub_aggs={
                "h": tat.top_hits_agg(3, "price", False)})},
            {"h": tat.top_hits_agg(10)},
            {"t": tat.terms_agg("weights", 10, sub_aggs={
                "h": tat.top_hits_agg(2, "price", True)})},
            {"t": tat.terms_agg("sku", 10, sub_aggs={
                "h": tat.top_hits_agg(3, "price", False)})}):
        check(bench, R, aggs, "device")


@pytest.mark.parametrize("env_name", ["rnd", "scatter"])
def test_in_slot_under_terms(request, env_name):
    env = request.getfixturevalue(env_name)
    aggs = {"t": tat.terms_agg("k", size=6, sub_aggs={
        "h": tat.top_hits_agg(3, "f", False), "n": tat.count_agg(),
        "hs": tat.top_hits_agg(2)})}
    for q in _QUERIES:
        check(env, q, aggs, "device")
    mode = plan_of(env, q, aggs, ("a", "t"))["mode"]
    assert mode == ("dense" if env_name == "rnd" else "scatter")
    assert plan_of(env, q, aggs, ("a", "t", "h"))["in_slot"]


def test_in_slot_under_histogram_and_filter(rnd):
    aggs = {"h": tat.histogram_agg("i", interval=2**33, sub_aggs={
        "th": tat.top_hits_agg(2, "ts", True),
        "fl": tat.filter_agg(tat.RangeQuery("f", lower=0.0), {
            "th": tat.top_hits_agg(3, "u", False)})})}
    for q in _QUERIES[:3]:
        check(rnd, q, aggs, "device")


def test_in_slot_under_a_multi_valued_terms_agg(rnd, dense):
    """Over value rows a doc holding the bucket's value twice is one hit."""
    check(rnd, tat.MatchAllQuery(), {"t": tat.terms_agg("tags", size=5,
                                                         sub_aggs={
        "th": tat.top_hits_agg(3, "i", False)})}, "device")
    aggs = {"t": tat.terms_agg("tags", size=6, sub_aggs={
        "th": tat.top_hits_agg(4, "qty", True), "hs": tat.top_hits_agg(2)})}
    for q in (tat.MatchAllQuery(), tat.RangeQuery("qty", lower=30)):
        check(dense, q, aggs, "device")


def test_huge_bucket_spaces_answer_on_the_host_path(rnd, bench):
    """prod(hdims) * k > 4096 refuses the device path, as in JAX."""
    check(rnd, tat.MatchAllQuery(), {"t": tat.terms_agg("k", size=40,
                                                         sub_aggs={
        "h": tat.top_hits_agg(200, "f")})}, "host")
    check(bench, tat.MatchAllQuery(), {"t": tat.terms_agg("sku", 2000,
                                                          sub_aggs={
        "h": tat.top_hits_agg(50)})}, "host")


def test_multi_valued_sort_field_is_refused(rnd):
    jaggs = {"h": tat.top_hits_agg(3, "mf")}
    with pytest.raises(TypeError):
        rnd["jax"].agg_search(tat.MatchAllQuery(), jaggs)
    with pytest.raises(TypeError):
        rnd["port"].agg_search(tt.MatchAllQuery(), to_port(jaggs))


@pytest.mark.parametrize("dedup", [True, False])
def test_msearch(rnd, dedup):
    from tantivy_aggregations_tpu_torch.engine_config import EngineConfig
    aggs = to_port({"h": tat.top_hits_agg(5, "f", True),
                    "t": tat.terms_agg("k", size=4, sub_aggs={
                        "th": tat.top_hits_agg(2, "u", False)})})
    reqs = [(tt.RangeQuery("i", lower=-2**34 + (j % 5) * 2**31), aggs)
            for j in range(9)]
    s = rnd["port"].index.searcher(device="cpu",
                                   config=EngineConfig(msearch_dedup=dedup))
    assert s.agg_search_batch(reqs) == [rnd["oracle"].agg_search(q, a)
                                        for q, a in reqs]
