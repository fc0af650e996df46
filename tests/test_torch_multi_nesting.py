"""Bucket aggs over multi-valued fields and under them in the PyTorch port,
on the CPU — the cases of tests/test_multi_parent_nesting.py and
tests/test_wslot_percentiles.py that run unsharded with integer percents,
on their indexes, each held by `four_way` (port default == port row modes
== oracle == the JAX package, plans equal at both configs): children
chained per value row of a multi-valued terms parent, the cross-product
expansion of a multi-valued child under one (`xpand`), the plane fan-out
of a short keyword parent, and percentiles under a multi-valued terms
ancestor counted with occurrence weights (`wslots`)."""

import pytest
import torch

import tantivy_aggregations_tpu as tat

from test_cross_mode import build_random
from test_torch_multi_query import (engines, four_way, persist, port_plan,
                                    to_port)
from test_wslot_percentiles import build as wslot_index

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def nest(tmp_path_factory):
    return engines(persist(build_random(88, n=300),
                           str(tmp_path_factory.mktemp("mn") / "nest")))


@pytest.fixture(scope="module")
def wslot(tmp_path_factory):
    return engines(persist(wslot_index(),
                           str(tmp_path_factory.mktemp("mn") / "wslot")))


def _nest_cases(m):
    return [
        (m.MatchAllQuery(),
         {"t": m.terms_agg("tags", size=4, sub_aggs={"h": m.histogram_agg(
             "u", interval=2**38, sub_aggs={"s": m.sum_agg("i"),
                                            "n": m.count_agg()})})}),
        (m.RangeQuery("u", lower=2**38),
         {"t": m.terms_agg("tags", size=3, sub_aggs={
             "f": m.filter_agg(m.RangeQuery("i", lower=0), sub_aggs={
                 "h": m.histogram_agg("u", interval=2**39)}),
             "a": m.avg_agg("mf")})}),
        (m.MatchAllQuery(),
         {"t": m.terms_agg("tags", size=3, sub_aggs={"t2": m.terms_agg(
             "k", size=4, sub_aggs={"s": m.sum_agg("u")})})}),
        (m.RangeQuery("i", lower=0),
         {"t": m.terms_agg("tags", size=4, sub_aggs={"h": m.histogram_agg(
             "u", interval=2**39, sub_aggs={"t2": m.terms_agg(
                 "k", size=3)})})}),
        # a multi-valued child under a multi-valued parent: the expansion
        (m.RangeQuery("i", lower=-2**34),
         {"t": m.terms_agg("k", size=40, sub_aggs={"t2": m.terms_agg(
             "tags", size=3, sub_aggs={"t3": m.terms_agg(
                 "mf", size=2, sub_aggs={"s": m.sum_agg("u")})})})}),
        (m.MatchAllQuery(),
         {"h": m.histogram_agg("mf", interval=0.5, sub_aggs={
             "t2": m.terms_agg("tags", size=2)})}),
        # a multi-valued terms agg under a single-valued one
        (m.PhraseQuery("txt", "alpha beta"),
         {"t": m.terms_agg("k", size=5, sub_aggs={"t2": m.terms_agg(
             "tags", size=3, sub_aggs={"mn": m.min_agg("mf")})})}),
    ]


@pytest.mark.parametrize("i", range(7))
def test_buckets_under_multi_terms(nest, i):
    four_way(nest, *_nest_cases(tat)[i])


def test_plane_fanout_and_expansion_plans(nest):
    q, aggs = _nest_cases(tat)[0]
    p = port_plan(nest, q, aggs, ("a", "t"))
    assert p["plane_fanout"] and p["dense_mm"], p
    q, aggs = _nest_cases(tat)[4]
    assert port_plan(nest, q, aggs, ("a", "t", "t2", "t3"))["xpand"]


def _wslot_cases(m):
    pct = (25, 50, 75)
    tags_p = {"t": m.terms_agg("tags", size=14, sub_aggs={
        "p": m.percentiles_agg("price", pct), "n": m.count_agg()})}
    return [
        (m.MatchAllQuery(), tags_p),
        (m.TermQuery("cat", "c2"), tags_p),
        (m.RangeQuery("amount", lower=100, upper=800), tags_p),
        (m.RangeQuery("amount", lower=10**9), tags_p),  # empty
        (m.TermQuery("tags", "t03"), {"t": m.terms_agg("nums", size=30,
                                                       sub_aggs={
            "p": m.percentiles_agg("amount", (50,))})}),
        (m.MatchAllQuery(), {"t": m.terms_agg("tags", size=14, sub_aggs={
            "p": m.percentiles_agg("scores", (25, 75))})}),
        (m.MatchAllQuery(), {"c": m.terms_agg("cat", size=6, sub_aggs={
            "t": m.terms_agg("tags", size=14, sub_aggs={
                "p": m.percentiles_agg("price", (50,))})})}),
        # a multi-valued percentile field under single-valued buckets
        (m.RangeQuery("nums", lower=3, upper=20), {"c": m.terms_agg(
            "cat", size=6, sub_aggs={"p": m.percentiles_agg("scores",
                                                            pct)})}),
    ]


@pytest.mark.parametrize("i", range(8))
def test_percentiles_under_multi_terms(wslot, i):
    q, aggs = _wslot_cases(tat)[i]
    four_way(wslot, q, aggs)
    path = ("a", "c", "t", "p") if i == 6 else (
        ("a", "c", "p") if i == 7 else ("a", "t", "p"))
    p = port_plan(wslot, q, aggs, path)
    assert p["pmode"] == "slot_rank" and p["wslots"] == (i < 7), p
    assert p["slotks"] and not p["pallas_slots"], p


def test_wslots_msearch_batch(wslot):
    aggs = to_port({"t": tat.terms_agg("tags", size=14, sub_aggs={
        "p": tat.percentiles_agg("price", (50,))})})
    reqs = [(to_port(tat.RangeQuery("amount", lower=10 * j, upper=900)),
             aggs) for j in range(5)]
    want = [wslot["oracle"].agg_search(q, a) for q, a in reqs]
    assert wslot["port"].agg_search_batch(reqs) == want
    assert wslot["row"].agg_search_batch(reqs) == want


def test_exists_leaf_on_the_cube(wslot):
    """An Exists leaf over a single-valued keyword is elementwise in its
    ordinal plane (`w > -1`), so its chain takes the cube as in the JAX
    package, the pcube included; over a multi-valued field it keeps the
    row paths."""
    aggs = {"n": tat.count_agg(), "s": tat.stats_agg("price"),
            "p": tat.percentiles_agg("price")}
    q = tat.BooleanQuery(must=[tat.RangeQuery("amount", lower=5, upper=900),
                               tat.ExistsQuery("cat")])
    four_way(wslot, q, aggs)
    assert port_plan(wslot, q, aggs, ("a", "n"))["cube"]
    assert port_plan(wslot, q, aggs, ("a", "p"))["pcube"]
    q = tat.BooleanQuery(must=[tat.RangeQuery("amount", lower=5, upper=900),
                               tat.ExistsQuery("tags")])
    four_way(wslot, q, aggs)
    assert port_plan(wslot, q, aggs, ("a", "n")).get("cube") is None
    assert port_plan(wslot, q, aggs, ("a", "p"), "row")["pallas_counts"]
