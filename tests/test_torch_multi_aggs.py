"""Aggregations gated by multi-valued query fields, and over them, in the
PyTorch port on the CPU — the cases of tests/test_multi_query_fields.py
and tests/test_wide_multi.py that run unsharded, on their indexes: each
request's fruits from the port at its default EngineConfig == the port in
row modes == the oracle == the JAX package (Pallas in interpret mode), and
the port plans every node as the JAX package does, at both configs
(`four_way`). Narrow and wide multi-valued chains keep the prefix and rank
modes (the per-position planes permute into the layouts); a chain over a
field with an overflow tail gathers the doc mask (`mask_gather`);
percentiles over a multi-valued field rank its value rows."""

import numpy as np
import pytest
import torch

import tantivy_aggregations_tpu as tat

from test_multi_query_fields import planeable_index, tail_index
from test_torch_multi_query import engines, four_way, persist, port_plan
from test_wide_multi import tail_index as wide_tail_index
from test_wide_multi import wide_index

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tails(tmp_path_factory):
    return engines(persist(tail_index(),
                           str(tmp_path_factory.mktemp("ma") / "tail")))


@pytest.fixture(scope="module")
def planeable(tmp_path_factory):
    return engines(persist(planeable_index(),
                           str(tmp_path_factory.mktemp("ma") / "plane")))


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    return engines(persist(wide_index(),
                           str(tmp_path_factory.mktemp("ma") / "wide")))


@pytest.fixture(scope="module")
def wide_tails(tmp_path_factory):
    return engines(persist(wide_tail_index(),
                           str(tmp_path_factory.mktemp("ma") / "wtail")))


def _tail_cases(m):
    return [
        (m.TermQuery("vals", 7), {"n": m.count_agg()}),
        (m.RangeQuery("vals", lower=10, upper=20),
         {"n": m.count_agg(), "s": m.sum_agg("qty")}),
        (m.TermQuery("tags", "t005"), {"n": m.count_agg()}),
        (m.RangeQuery("tags", lower="t010", upper="t020"),
         {"n": m.count_agg()}),
        (m.ExistsQuery("vals"), {"n": m.count_agg()}),
        (m.BooleanQuery(must=[m.TermQuery("vals", 7)],
                        must_not=[m.TermQuery("tags", "t001")]),
         {"n": m.count_agg()}),
        # the tailed query field keeps exact terms over a multi field
        (m.TermQuery("vals", 7), {"t": m.terms_agg("tags", size=10)}),
    ]


@pytest.mark.parametrize("i", range(7))
def test_tail_term_range_exists_parity(tails, i):
    four_way(tails, *_tail_cases(tat)[i])


@pytest.mark.parametrize("aggs", [
    {"p": tat.percentiles_agg("qty")},
    {"p": tat.percentiles_agg("vals")},
])
def test_tail_chain_percentiles_gather_rank(tails, aggs):
    """Percentiles under a chain over a tailed field rank through the
    gathered doc mask, single- and multi-valued percentile fields; an
    msearch batch through the same program."""
    q = tat.TermQuery("vals", 7)
    four_way(tails, q, aggs)
    pp = port_plan(tails, q, aggs, ("a", "p"))
    assert pp["pmode"] == "rank" and pp.get("mask_gather"), pp
    from test_torch_multi_query import to_port
    reqs = [(to_port(tat.TermQuery("vals", v)), to_port(aggs))
            for v in (7, 9, 7, 3)]
    want = [tails["oracle"].agg_search(q2, a2) for q2, a2 in reqs]
    assert tails["port"].agg_search_batch(reqs) == want
    assert tails["row"].agg_search_batch(reqs) == want


@pytest.mark.parametrize("q", [tat.TermQuery("weights", 42),
                               tat.RangeQuery("weights", lower=10,
                                              upper=60)])
def test_multi_query_field_keeps_prefix_mode(planeable, q):
    aggs = {"t": tat.terms_agg("sku", size=10,
                               sub_aggs={"s": tat.sum_agg("amount")})}
    four_way(planeable, q, aggs)
    for which in ("port", "row"):
        p = port_plan(planeable, q, aggs, ("a", "t"), which)
        assert p["mode"] == "prefix" and not p.get("mask_gather"), p


def test_multi_query_field_keeps_rank_percentiles(planeable):
    aggs = {"p": tat.percentiles_agg("price")}
    for q in (tat.TermQuery("weights", 42),
              tat.RangeQuery("weights", lower=5, upper=95)):
        four_way(planeable, q, aggs)
        p = port_plan(planeable, q, aggs, ("a", "p"), "row")
        assert p["pmode"] == "rank" and p["pallas_counts"], p


def test_multi_valued_percentiles_and_buckets(planeable):
    """Percentiles of the multi-valued field over its value rows (the
    pcube at the default config, chain_counts in row modes), and terms /
    histogram over it (scatter and dense over the value rows)."""
    q = tat.RangeQuery("amount", lower=100, upper=900)
    aggs = {"p": tat.percentiles_agg("weights"),
            "t": tat.terms_agg("weights", size=5, sub_aggs={
                "s": tat.sum_agg("amount"), "mx": tat.max_agg("price")}),
            "h": tat.histogram_agg("weights", interval=10, sub_aggs={
                "a": tat.avg_agg("price")})}
    four_way(planeable, q, aggs)
    assert port_plan(planeable, q, aggs, ("a", "p"))["pcube"]
    assert port_plan(planeable, q, aggs, ("a", "p"), "row")["pallas_counts"]
    assert port_plan(planeable, q, aggs, ("a", "h"))["dense_mm"]


def _wide_cases(m):
    return [
        (m.TermQuery("big", 7 * 2**33), {"n": m.count_agg()}),
        (m.TermQuery("big", 12345), {"n": m.count_agg()}),
        (m.RangeQuery("big", lower=2**35, upper=2**39),
         {"n": m.count_agg(), "s": m.sum_agg("amount")}),
        (m.RangeQuery("big", lower=None, upper=2**34, include_upper=False),
         {"n": m.count_agg()}),
        (m.ExistsQuery("big"), {"n": m.count_agg()}),
        (m.BooleanQuery(must=[m.RangeQuery("big", lower=2**30)],
                        must_not=[m.TermQuery("big", 7 * 2**33)]),
         {"n": m.count_agg()}),
        (m.RangeQuery("ratios", lower=0.5, upper=4.0),
         {"n": m.count_agg(), "s": m.sum_agg("amount")}),
        (m.RangeQuery("ratios", lower=-1.0, upper=0.0), {"n": m.count_agg()}),
        (m.ExistsQuery("ratios"), {"n": m.count_agg()}),
        (m.TermSetQuery("big", [7 * 2**33, 999, 2**38]),
         {"n": m.count_agg()}),
        (m.TermSetQuery("big", []), {"n": m.count_agg()}),
    ]


@pytest.mark.parametrize("i", range(11))
def test_wide_term_range_exists_termset_parity(wide, i):
    four_way(wide, *_wide_cases(tat)[i])


@pytest.mark.parametrize("q", [tat.TermQuery("big", 7 * 2**33),
                               tat.RangeQuery("big", lower=2**33,
                                              upper=2**39)])
def test_wide_multi_query_field_keeps_prefix_and_rank(wide, q):
    aggs = {"t": tat.terms_agg("sku", size=10,
                               sub_aggs={"s": tat.sum_agg("amount")}),
            "p": tat.percentiles_agg("price")}
    four_way(wide, q, aggs)
    assert port_plan(wide, q, aggs, ("a", "t"))["mode"] == "prefix"
    assert port_plan(wide, q, aggs, ("a", "p"))["pmode"] == "rank"
    pp = port_plan(wide, q, aggs, ("a", "p"), "row")
    assert any(k.endswith(":mpn") for k in pp["chainp"]["mp"].plane_keys)


@pytest.mark.parametrize("q", [tat.RangeQuery("big", lower=2**36,
                                              upper=2**39),
                               tat.ExistsQuery("big")])
def test_wide_tail_parity(wide_tails, q):
    four_way(wide_tails, q, {"n": tat.count_agg(), "s": tat.sum_agg("qty"),
                             "p": tat.percentiles_agg("qty")})

