"""The port's slice end to end on the CPU: c1-c5 shaped requests through
`agg_search` / `agg_search_batch` of tantivy_aggregations_tpu_torch, held
by exact `==` against the port's oracle, the JAX package's Searcher (cube
off, Pallas kernels in interpret mode) and the JAX oracle — all four over
ONE on-disk index written by the JAX writer.

Two indexes: a persisted fixtures.random_index with dense_nb=8 (forcing
the prefix modes, as tests/test_pallas_prefix.py does), and a small
flagship bench index (models/flagship.py schema, 4 segments) with the
judged configs themselves at the default config."""

import pytest
import torch

import tantivy_aggregations_tpu as tat
from tantivy_aggregations_tpu.engine_config import EngineConfig as JaxConfig
from tantivy_aggregations_tpu.models import flagship as jflag

import tantivy_aggregations_tpu_torch as tt
from tantivy_aggregations_tpu_torch.engine_config import EngineConfig
from tantivy_aggregations_tpu_torch.models import flagship as pflag

from fixtures import random_index

torch.set_num_threads(2)


def _persist(ram, path):
    disk = tat.Index.create(path, ram.schema)
    for seg in ram.segments:
        disk._add_segment(seg)
    disk._commit_meta()
    return path


@pytest.fixture(scope="module")
def rnd(tmp_path_factory):
    path = _persist(random_index(seed=21, n_docs=20_000),
                    str(tmp_path_factory.mktemp("slice") / "idx"))
    jidx, pidx = tat.Index.open(path), tt.Index.open(path)
    return {
        "port": pidx.searcher(device="cpu",
                              config=EngineConfig(dense_nb=8)),
        "port_oracle": pidx.oracle_searcher(),
        "jax": jidx.searcher(config=JaxConfig(dense_nb=8, use_cube=False,
                                              pallas_interpret=True)),
        "jax_oracle": jidx.oracle_searcher(),
    }


def _shapes(m):
    """c1-c5 shaped (query builder j -> query, aggs) over the fixture
    schema, built with module `m`'s IR (tat or tt)."""
    return {
        "c1": (lambda j: m.MatchAllQuery(),
               {"n": m.count_agg(), "s": m.sum_agg("qty")}),
        "c2": (lambda j: m.TermQuery("cat", f"cat00{10 + j % 4}"),
               {"lo": m.min_agg("price"), "hi": m.max_agg("price"),
                "avg_w": m.avg_agg("counts")}),
        "c3": (lambda j: m.MatchAllQuery(),
               {"h": m.histogram_agg("ts", interval=1_000_000,
                                     sub_aggs={"s": m.sum_agg("qty")})}),
        "c4": (lambda j: m.BooleanQuery(
                   must=[m.RangeQuery("qty", lower=j, upper=990 - j)]),
               {"t": m.terms_agg("cat", size=10,
                                 sub_aggs={"s": m.sum_agg("price"),
                                           "sq": m.sum_agg("qty"),
                                           "n": m.count_agg()})}),
        "c5": (lambda j: m.BooleanQuery(must=[
                   m.RangeQuery("qty", lower=100 + j, upper=900 - j,
                                include_upper=True)]),
               {"p": m.percentiles_agg("price"),
                "pf": m.post_filter_agg(
                    m.TermQuery("cat", "cat0020"),
                    sub_aggs={"n": m.count_agg(), "s": m.sum_agg("delta"),
                              "h": m.histogram_agg("delta", interval=100)}),
                "t": m.terms_agg("cat", size=4,
                                 sub_aggs={"s": m.sum_agg("qty")})}),
    }


#: the plan entries that must take each kernel mode
KERNEL_MODES = {
    "c1": [(("a", "s"), "fused")],
    "c3": [(("a", "h"), "pallas_prefix")],
    "c4": [(("a", "t"), "pallas_prefix")],
    "c5": [(("a", "p"), "pallas_counts"), (("a", "pf", "s"), "fused"),
           (("a", "pf", "h"), "pallas_prefix")],
}


@pytest.mark.parametrize("cfg", ["c1", "c2", "c3", "c4", "c5"])
def test_port_matches_jax_and_oracles(rnd, cfg):
    jb, jaggs = _shapes(tat)[cfg]
    pb, paggs = _shapes(tt)[cfg]
    for j in (0, 3):
        want = rnd["jax_oracle"].agg_search(jb(j), jaggs)
        assert rnd["jax"].agg_search(jb(j), jaggs) == want
        assert rnd["port_oracle"].agg_search(pb(j), paggs) == want
        assert rnd["port"].agg_search(pb(j), paggs) == want
    prog = rnd["port"]._program_for(pb(0), paggs)
    for path, key in KERNEL_MODES.get(cfg, []):
        assert prog.plan[path].get(key), (path, key, prog.plan[path])


@pytest.mark.parametrize("cfg", ["c2", "c4", "c5"])
def test_batch_matches_single(rnd, cfg):
    pb, paggs = _shapes(tt)[cfg]
    reqs = [(pb(j), paggs) for j in range(9)]
    reqs += reqs[:3]  # duplicates ride the msearch dedup
    got = rnd["port"].agg_search_batch(reqs)
    assert got == [rnd["port"].agg_search(q, a) for q, a in reqs]
    assert got[0] is not got[9]


@pytest.mark.parametrize("cfg", ["c1", "c3", "c5"])
def test_batch_without_dedup(rnd, cfg):
    """Identical and param-free requests as separate batch rows (B > 1
    through every kernel) give the per-query results."""
    pidx = rnd["port"].index
    s = pidx.searcher(device="cpu",
                      config=EngineConfig(dense_nb=8, msearch_dedup=False))
    pb, paggs = _shapes(tt)[cfg]
    reqs = [(pb(j % 2), paggs) for j in range(5)]
    assert s.agg_search_batch(reqs) == [s.agg_search(q, a) for q, a in reqs]


def test_collect_stats(rnd):
    pidx = rnd["port"].index
    s = pidx.searcher(device="cpu",
                      config=EngineConfig(dense_nb=8, collect_stats=True))
    pb, paggs = _shapes(tt)["c5"]
    assert s.agg_search(pb(1), paggs) == \
        rnd["port_oracle"].agg_search(pb(1), paggs)
    st = s.last_stats
    assert not st.program_cached and st.total_ms > 0
    s.agg_search(pb(2), paggs)
    assert s.last_stats.program_cached


@pytest.mark.parametrize("aggs,query", [
    ({"t": tt.top_hits_agg(size=3)}, tt.MatchAllQuery()),
    ({"p": tt.percentiles_agg("price", (2.5, 50.0))}, tt.MatchAllQuery()),
    ({"t": tt.terms_agg("cat", sub_aggs={"p": tt.percentiles_agg("qty")})},
     tt.MatchAllQuery()),
    ({"t": tt.terms_agg("tags")}, tt.MatchAllQuery()),
    ({"n": tt.count_agg()}, tt.TermSetQuery("cat", ["cat0001"])),
    ({"n": tt.count_agg()}, tt.TermQuery("tags", "t1")),
    ({"n": tt.count_agg()}, tt.ExistsQuery("cat")),
])
def test_unported_shapes_raise(rnd, aggs, query):
    with pytest.raises(NotImplementedError):
        rnd["port"].agg_search(query, aggs)


# ---------------------------------------------------------------------------
# the judged configs on a small flagship bench index
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bench") / "idx")
    jflag.build_bench_index(path, 40_000, seed=42, n_segments=4)
    jidx, pidx = tat.Index.open(path), tt.Index.open(path)
    return (pidx.searcher(device="cpu"), pidx.oracle_searcher(),
            jidx.searcher(config=JaxConfig(use_cube=False,
                                           pallas_interpret=True)),
            jidx.oracle_searcher())


@pytest.mark.parametrize("i", range(5))
def test_flagship_judged_configs(bench, i):
    port, port_oracle, jax_s, jax_oracle = bench
    _, jq, jaggs = jflag.judged_configs()[i]
    _, pq, paggs = pflag.judged_configs()[i]
    want = jax_oracle.agg_search(jq, jaggs)
    assert jax_s.agg_search(jq, jaggs) == want
    assert port_oracle.agg_search(pq, paggs) == want
    assert port.agg_search(pq, paggs) == want
    reqs = pflag.varied_requests(i + 1, paggs, 40)
    got = port.agg_search_batch(reqs)
    for (q, a), g in zip(reqs[:8], got[:8]):
        assert g == port_oracle.agg_search(q, a)
    assert got == [port.agg_search(q, a) for q, a in reqs]


def test_flagship_plans_the_kernel_modes(bench):
    port = bench[0]
    plans = {}
    for name, q, aggs in pflag.judged_configs():
        plans[name] = port._program_for(q, aggs).plan
    assert plans["c1_count_sum"][("a", "s")]["fused"]
    assert plans["c4_terms_highcard_nested"][("a", "t")]["pallas_prefix"]
    c5 = plans["c5_percentiles_mixed_postfilter"]
    assert c5[("a", "p")]["pallas_counts"]
    assert c5[("a", "pf", "s")]["fused"]
    assert c5[("a", "t")]["mode"] == "dense"
    assert plans["c3_date_histogram_sum"][("a", "h")]["mode"] == "dense"
