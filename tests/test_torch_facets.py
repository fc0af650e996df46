"""facet aggs in the PyTorch port, on the CPU: a terms agg over the facet
field's value rows (every ancestor indexed once per doc) with host-side
selection of the static child ordinals. Each request's fruits from the
port at its default EngineConfig == the port in row modes == the oracle ==
the JAX package (Pallas in interpret mode), with plan parity
(`assert_phase2_parity`, the child set included): the cases of
tests/test_facet_bytes.py (root counts, child counts and order, size,
term queries on descendants, deletes, a facet under terms, validation
errors) and, on a catalog index (leaf paths /cNN/sN/lN beside a
multi-valued keyword), the smoke run's f1-f4 shapes, a facet under a
plane fan-out among them. Every comparison is exact."""

import numpy as np
import pytest
import torch

import tantivy_aggregations_tpu as tat
from tantivy_aggregations_tpu.schema import Cardinality as JCard

import tantivy_aggregations_tpu_torch as tt

from test_facet_bytes import facet_index
from test_torch_multi_query import engines, persist, to_port
from test_torch_phase2 import check, plan_of

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return engines(persist(facet_index(),
                           str(tmp_path_factory.mktemp("fc") / "f")))


@pytest.fixture(scope="module")
def deleted(tmp_path_factory):
    idx = facet_index()
    w = idx.writer()
    w.delete_term("k", "b")
    w.commit()
    return engines(persist(idx, str(tmp_path_factory.mktemp("fc") / "d")))


def catalog_index(path, n=2000, seed=5):
    """amount, a multi-valued zipf keyword `tags` (0-3 a doc) and a facet
    field `cat` holding one leaf path /cNN/sN/lN a doc (20 x 10 x 10
    leaves, zipf-skewed), in 2 segments."""
    schema = (tat.SchemaBuilder().add_u64_field("amount")
              .add_keyword_field("tags", cardinality=JCard.MULTI)
              .add_facet_field("cat").build())
    idx = tat.Index.create_in_ram(schema)
    w = idx.writer()
    rng = np.random.default_rng(seed)
    leaves = [f"/c{c:02d}/s{s}/l{l}" for c in range(20) for s in range(10)
              for l in range(10)]
    for i in range(n):
        w.add_document({
            "amount": int(rng.integers(0, 10_000)),
            "tags": [f"tag{int(x) % 12:02d}"
                     for x in rng.zipf(1.3, int(rng.integers(0, 4)))],
            "cat": leaves[(int(rng.zipf(1.3)) - 1) % len(leaves)]})
        if i == n // 2:
            w.commit()
    w.commit()
    return persist(idx, path)


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    return engines(catalog_index(str(tmp_path_factory.mktemp("fc") / "c")))


def test_root_counts(small):
    r = check(small, tat.MatchAllQuery(), {"f": tat.facet_agg("cat")},
              "device")
    got = {b["key"]: b["doc_count"] for b in r["f"]["buckets"]}
    assert got == {"/electronics": 3, "/books": 3, "/deals": 1}


def test_child_counts_order_and_size(small):
    r = check(small, tat.MatchAllQuery(),
              {"f": tat.facet_agg("cat", "/electronics")}, "device")
    assert [(b["key"], b["doc_count"]) for b in r["f"]["buckets"]] == [
        ("/electronics/phones", 2), ("/electronics/laptops", 1)]
    r = check(small, tat.MatchAllQuery(),
              {"f": tat.facet_agg("cat", "/books", size=1)}, "device")
    assert [b["key"] for b in r["f"]["buckets"]] == ["/books/fiction"]
    check(small, tat.MatchAllQuery(),
          {"f": tat.facet_agg("cat", "/electronics/phones"),
           "g": tat.facet_agg("cat", "/nowhere")}, "device")


def test_term_queries_match_descendants(small):
    r = check(small, tat.TermQuery("cat", "/electronics"),
              {"n": tat.count_agg(), "s": tat.sum_agg("v"),
               "f": tat.facet_agg("cat", "/electronics")}, "device")
    assert r["n"]["value"] == 3 and r["s"]["value"] == 6
    check(small, tat.BooleanQuery(
        must=[tat.TermQuery("cat", "/books")],
        must_not=[tat.TermQuery("cat", "/books/fiction")]),
        {"n": tat.count_agg(), "f": tat.facet_agg("cat")}, "device")


def test_filtered_and_deleted(deleted):
    check(deleted, tat.MatchAllQuery(), {"f": tat.facet_agg("cat")},
          "device")
    check(deleted, tat.TermQuery("k", "a"),
          {"f": tat.facet_agg("cat", "/books")}, "device")
    check(deleted, tat.RangeQuery("v", lower=2),
          {"f": tat.facet_agg("cat")}, "device")


def test_under_terms(small):
    check(small, tat.MatchAllQuery(),
          {"t": tat.terms_agg("k", size=3, sub_aggs={
              "f": tat.facet_agg("cat")})}, "device")


def test_validation(small):
    for jaggs, err in (({"f": tat.facet_agg("cat", "bad-path")}, ValueError),
                       ({"f": tat.facet_agg("k")}, TypeError)):
        with pytest.raises(err):
            small["jax"].agg_search(tat.MatchAllQuery(), jaggs)
        with pytest.raises(err):
            small["port"].agg_search(tt.MatchAllQuery(), to_port(jaggs))


def _catalog_cases(m):
    """f1-f4 of the smoke run's catalog path."""
    rng = m.RangeQuery("amount", lower=100, upper=9000, include_upper=True)
    return [
        (rng, {"f": m.facet_agg("cat")}),
        (rng, {"f": m.facet_agg("cat", "/c07", size=5)}),
        (m.TermQuery("cat", "/c03"),
         {"n": m.count_agg(), "s": m.sum_agg("amount"),
          "f": m.facet_agg("cat", "/c03")}),
        (rng, {"t": m.terms_agg("tags", size=5, sub_aggs={
            "f": m.facet_agg("cat")})}),
    ]


@pytest.mark.parametrize("i", range(4))
def test_catalog_shapes(catalog, i):
    jq, jaggs = _catalog_cases(tat)[i]
    check(catalog, jq, jaggs, "device")
    path = ("a", "t", "f") if i == 3 else ("a", "f")
    p = plan_of(catalog, jq, jaggs, path)
    assert p["sel"] == "host" and p["keff"] == p["card"]
    assert not p["plane_fanout"] and p.get("cube") is None
    if i == 3:  # the facet runs under the terms agg's plane fan-out
        assert plan_of(catalog, jq, jaggs, ("a", "t"))["plane_fanout"]


def test_catalog_msearch(catalog):
    from tantivy_aggregations_tpu_torch.engine_config import EngineConfig
    aggs = to_port(_catalog_cases(tat)[1][1])
    reqs = [(tt.TermQuery("cat", f"/c{c:02d}"),
             {"f": tt.facet_agg("cat", f"/c{c:02d}")}) for c in range(3)]
    reqs += [(tt.RangeQuery("amount", lower=100 * j, upper=9000), aggs)
             for j in range(5)]
    want = [catalog["oracle"].agg_search(q, a) for q, a in reqs]
    for dedup in (True, False):
        s = catalog["port"].index.searcher(
            device="cpu", config=EngineConfig(msearch_dedup=dedup))
        assert s.agg_search_batch(reqs) == want
