"""Sharded selections in the PyTorch port, on the CPU (the JAX package's
tests/test_sharded.py, second half): rank percentiles by cross-shard
bisection of the value domain (narrow and wide columns, duplicates and
span edges, non-integer percents through phase 2, multi-valued value-row
layouts), slot_rank percentiles by per-slot bisection (and phase 2 under a
host-selected terms ancestor), in-slot top_hits by a k-way merge of the
shards' candidates, the cross-product expansion built per shard, and
phrase queries over shard-partitioned token streams. Each case: port ==
JAX == oracle with sharded plan parity (test_torch_sharded.py's harness),
and the port's kernels launched per shard where its plan says so."""

import numpy as np

import tantivy_aggregations_tpu as tat
from tantivy_aggregations_tpu import (
    MatchAllQuery,
    PhraseQuery,
    RangeQuery,
    SchemaBuilder,
    TermQuery,
    count_agg,
    histogram_agg,
    percentiles_agg,
    sum_agg,
    terms_agg,
    top_hits_agg,
)

from fixtures import random_index
from test_torch_multi_query import persist, to_port
from test_torch_sharded import mesh_env, sharded_check


def _queries():
    return [MatchAllQuery(), RangeQuery("qty", lower=50, upper=900),
            TermQuery("cat", "cat0002"),
            RangeQuery("qty", lower=10**7)]  # empty: all-None fruits


def test_sharded_percentiles_bisect(tmp_path):
    path = persist(random_index(13, n_docs=800, n_segments=3),
                   str(tmp_path / "ix"))
    env = mesh_env(path, 8)
    # qty: narrow u64; price: wide (f64 mono span)
    aggs = {"pq": percentiles_agg("qty"),
            "pp": percentiles_agg("price"),
            "pd": percentiles_agg("delta", percents=(0, 10, 50, 90, 100))}
    for q in _queries():
        plan, _ = sharded_check(env, q, aggs)
        for k in ("pq", "pp", "pd"):
            assert plan[("a", k)]["pmode"] == "rank", k
            assert plan[("a", k)]["bisect"], k
            assert plan[("a", k)]["pallas_counts"], k  # chain_counts
    assert not plan[("a", "pp")]["narrow"]


def test_sharded_bisect_duplicates_and_edges(tmp_path):
    """Heavy duplicates + span edges: bisection lands on exact values
    (ties across shards, min / max ranks at 0 / 100), wide and narrow."""
    sch = SchemaBuilder().add_u64_field("v").add_i64_field("w").build()
    idx = tat.Index.create_in_ram(sch)
    w = idx.writer()
    vals = [0, 0, 0, 7, 7, 2**33, 2**33, 2**33, 2**40, 1]
    for i, v in enumerate(vals):
        w.add_document({"v": v, "w": (-1) ** i * v})
        if i == 4:
            w.commit()
    w.commit()
    env = mesh_env(persist(idx, str(tmp_path / "ix")), 8)
    aggs = {"pv": percentiles_agg("v", percents=(0, 25, 50, 75, 100)),
            "pw": percentiles_agg("w", percents=(0, 25, 50, 75, 100))}
    for q in [MatchAllQuery(), RangeQuery("v", upper=2**33,
                                          include_upper=True)]:
        plan, _ = sharded_check(env, q, aggs)
        assert plan[("a", "pv")]["bisect"]
        assert not plan[("a", "pv")]["narrow"]  # span 2^40: wide


def test_sharded_percentiles_noninteger_bisect(tmp_path):
    """Non-integer percents on a mesh: host ranks, then a phase-2
    cross-shard bisection selects values; batched too."""
    path = persist(random_index(14, n_docs=600, n_segments=3),
                   str(tmp_path / "ix"))
    env = mesh_env(path, 4)
    aggs = {"p": percentiles_agg("price", percents=(2.5, 33.3, 50.0, 97.5)),
            "pq": percentiles_agg("qty", percents=(0.1, 99.9))}
    for q in [MatchAllQuery(), RangeQuery("qty", lower=50, upper=900),
              RangeQuery("qty", lower=10**7)]:
        plan, _ = sharded_check(env, q, aggs)
        for k in ("p", "pq"):
            assert plan[("a", k)]["bisect"] and \
                not plan[("a", k)]["int_percents"], k
    reqs = [(MatchAllQuery(), aggs), (RangeQuery("qty", lower=50), aggs)] * 3
    preqs = [(to_port(q), to_port(a)) for q, a in reqs]
    want = [env["oracle"].agg_search(q, a) for q, a in preqs]
    assert env["port"].agg_search_batch(preqs) == want
    assert env["jax"].agg_search_batch(reqs) == want


def test_sharded_percentiles_multivalued_bisect(tmp_path):
    """Multi-valued percentile fields on a mesh: value-row rank layouts
    per shard, the same bisection."""
    path = persist(random_index(15, n_docs=700, n_segments=3),
                   str(tmp_path / "ix"))
    env = mesh_env(path, 8)
    aggs = {"pc": percentiles_agg("counts"),
            "ps": percentiles_agg("scores"),
            "pn": percentiles_agg("scores", percents=(2.5, 50.0, 97.5))}
    for q in _queries():
        plan, _ = sharded_check(env, q, aggs)
        for k in ("pc", "ps", "pn"):
            assert plan[("a", k)]["pmode"] == "rank", k
            assert plan[("a", k)]["bisect"], k


def test_sharded_slot_rank_percentiles(tmp_path):
    """Percentiles under bucket aggs: slot_rank with per-slot cross-shard
    bisection (chain_slot_counts per shard on single-valued fields); the
    non-integer form through phase 2 under a host-selected terms node."""
    path = persist(random_index(16, n_docs=700, n_segments=3),
                   str(tmp_path / "ix"))
    env = mesh_env(path, 4)
    aggs = {"t": terms_agg("cat", size=4,
                           sub_aggs={"p": percentiles_agg("price"),
                                     "pc": percentiles_agg("counts")}),
            "h": histogram_agg("qty", interval=397,
                               sub_aggs={"pq": percentiles_agg("delta")})}
    for q in _queries():
        plan, _ = sharded_check(env, q, aggs)
        for pth in (("a", "t", "p"), ("a", "t", "pc"), ("a", "h", "pq")):
            assert plan[pth]["pmode"] == "slot_rank", pth
            assert plan[pth]["slot_bisect"], pth
    assert plan[("a", "t", "p")]["pallas_slots"]
    na = {"t": terms_agg("cat", size=3,
                         sub_aggs={"p": percentiles_agg("price",
                                                        percents=(50.5,)),
                                   "n": count_agg()}),
          "h": histogram_agg("qty", interval=397,
                             sub_aggs={"p": percentiles_agg(
                                 "delta", percents=(33.3, 75.0))})}
    for q in [MatchAllQuery(), TermQuery("cat", "cat0001"),
              RangeQuery("qty", lower=10**7)]:
        plan, _ = sharded_check(env, q, na)
        assert plan[("a", "t", "p")]["phase2_vals"]
        assert plan[("a", "t")]["sel"] == "host"
    reqs = [(RangeQuery("qty", lower=10 * j, upper=900), na)
            for j in range(5)]
    preqs = [(to_port(q), to_port(a)) for q, a in reqs]
    assert env["port"].agg_search_batch(preqs) == \
        [env["oracle"].agg_search(q, a) for q, a in preqs]


def test_sharded_in_slot_top_hits(tmp_path):
    path = persist(random_index(17, n_docs=600, n_segments=3),
                   str(tmp_path / "ix"))
    env = mesh_env(path, 8)
    aggs = {"t": terms_agg("cat", size=4,
                           sub_aggs={"th": top_hits_agg(3, "qty"),
                                     "td": top_hits_agg(2, "delta",
                                                        ascending=False)}),
            "h": histogram_agg("qty", interval=509,
                               sub_aggs={"ts": top_hits_agg(2, "price")}),
            "tg": terms_agg("tags", size=3,
                            sub_aggs={"tq": top_hits_agg(2, "qty")})}
    for q in _queries():
        plan, _ = sharded_check(env, q, aggs)
        for pth in (("a", "t", "th"), ("a", "t", "td"), ("a", "h", "ts"),
                    ("a", "tg", "tq")):
            assert plan[pth]["kind"] == "top_hits", pth
            assert plan[pth]["in_slot"], pth


def test_sharded_multi_under_multi_expansion(tmp_path):
    path = persist(random_index(seed=55, n_docs=3000),
                   str(tmp_path / "ix"))
    env = mesh_env(path, 8)
    aggs = {"t": terms_agg("counts", size=8, sub_aggs={
        "c": terms_agg("tags", size=5, sub_aggs={"s": sum_agg("qty")})})}
    for q in [MatchAllQuery(), RangeQuery("qty", lower=100, upper=800)]:
        plan, _ = sharded_check(env, q, aggs)
        assert plan[("a", "t", "c")].get("xpand")


def test_sharded_phrase_query(tmp_path):
    schema = (SchemaBuilder().add_text_field("body")
              .add_u64_field("qty").build())
    idx = tat.Index.create_in_ram(schema)
    w = idx.writer()
    rng = np.random.default_rng(9)
    vocab = ["v%d" % i for i in range(8)]
    for i in range(500):
        toks = [vocab[int(t)] for t in rng.integers(0, 8,
                                                    int(rng.integers(0, 20)))]
        w.add_document({"body": " ".join(toks), "qty": int(i % 97)})
    w.commit()
    env = mesh_env(persist(idx, str(tmp_path / "ix")), 8)
    for text in ("v1 v2", "v3", "v0 v0 v1"):
        sharded_check(env, PhraseQuery("body", text),
                      {"n": count_agg(), "s": sum_agg("qty")})
